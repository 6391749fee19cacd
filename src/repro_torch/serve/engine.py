"""Batched greedy serving (the JAX package's ``serve/engine.py``): prefill,
then a greedy decode loop over the cache-carrying path.

``generate`` runs where the model lives: on the card for a model built
with the default ``device="cuda"``, on the CPU (plain versions) for one
built with ``device="cpu"``.
"""

from __future__ import annotations

import torch

from repro_torch.models import lm


@torch.no_grad()
def _serve(model, tokens, max_new: int, max_len: int, forced=None):
    """Prefill, then ``max_new`` decode steps (the last step's output is
    discarded, as in the JAX package).  Feeds the argmax, or ``forced``'s
    columns when given.  Returns (tokens ``[B, max_new]`` int32, logits
    ``[B, max_new, vocab]`` that chose each of them)."""
    cfg = model.cfg
    if cfg.frontend != "tokens":
        raise ValueError("generate() requires a token frontend")
    tokens = torch.as_tensor(tokens, dtype=torch.int32).to(model.device)
    last_logits, caches, cl = lm.prefill(model, tokens, max_len=max_len)
    step_logits = [last_logits[:, -1, :cfg.vocab]]
    toks = []
    tok = step_logits[0].argmax(dim=-1).to(torch.int32)
    for i in range(max_new):
        if forced is not None:
            tok = forced[:, i].to(device=model.device, dtype=torch.int32)
        toks.append(tok)
        cl = cl + 1
        logits, caches = lm.decode_step(model, tok[:, None], caches, cl)
        if i + 1 < max_new:
            step_logits.append(logits[:, -1, :cfg.vocab])
        tok = logits[:, -1, :cfg.vocab].argmax(dim=-1).to(torch.int32)
    return torch.stack(toks, dim=1), torch.stack(step_logits, dim=1)


def generate(model, tokens, *, max_new: int, max_len: int):
    """Greedy generation for token-frontend models: tokens int ``[B, S]``
    -> int32 ``[B, max_new]`` (the first token comes from the prefill)."""
    return _serve(model, tokens, max_new, max_len)[0]


def teacher_forced_logits(model, tokens, forced, *, max_len: int):
    """The logits ``[B, T, vocab]`` that score each column of ``forced``
    (``[B, T]``) when the model is fed ``forced`` instead of its own
    argmax: the comparison of two runs without letting one differing
    token send them apart."""
    return _serve(model, tokens, forced.shape[1], max_len, forced=forced)[1]
