"""PyTorch port, the model zoo's other eight architectures on the CPU,
decoding: ``decode_step`` fed the same inputs for several steps (tokens,
musicgen-large's frame embeddings; llama-3.2-vision-90b's cross caches as
the prefill wrote them) against the JAX package's ``lm.decode_step``, at
the reduced configs.  The models, inputs, MoE route recording and
tolerances are ``tests/test_torch_zoo_serve.py``'s;
``tests/test_torch_zoo_serve_c.py`` holds the teacher-forced ``generate``.
A row is compared up to its first step whose input some MoE layer routed
otherwise than the reference (an undecided route, see ``flagged``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from test_torch_zoo_serve import (ARCHS, B, LOGITS_REL_TOL, MAX_LEN, NEW, S,  # noqa: E402
                                  Routes, f32, flagged, inputs, pair, rel,
                                  torch_one_thread, whole_depth_tol)  # noqa: F401 (fixture)


def step_inputs(cfg, seed=3):
    """NEW decode inputs for both packages: tokens ``[B, 1]`` or frame
    embeddings ``[B, 1, d]``, from numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(NEW):
        if cfg.frontend == "tokens":
            t = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
            out.append(({"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}))
        else:
            e = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
            out.append(({"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}))
    return out


def compared_steps(routes, cfg, steps):
    """``[B, steps]``: the steps of each row before its first step whose
    input was routed otherwise in some MoE layer (the prefill's calls
    count for step 0: its last position and every position before it)."""
    keep = np.ones((B, steps), bool)
    if not cfg.n_experts:
        return keep
    masks = flagged(routes, cfg)
    n_moe = sum(m.shape[1] == S for m in masks)
    events = [np.any([m.any(axis=1) for m in masks[:n_moe]], axis=0)]
    for j in range(steps - 1):
        events.append(np.any([m[:, 0] for m in masks[n_moe * (j + 1):n_moe * (j + 2)]],
                             axis=0))
    hit = np.cumsum(np.stack(events, axis=1), axis=1) > 0
    return ~hit


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, monkeypatch, torch_one_thread):
    """Prefill, then NEW ``decode_step`` calls fed the same inputs, each
    side from its own caches: every step's logits within the tolerance."""
    cfg, jcfg, params, model = pair(arch)
    routes = Routes(monkeypatch)
    jb, tb = inputs(cfg)
    _, jcaches, jcl = jlm.prefill(params, jcfg, jb, max_len=MAX_LEN)
    _, caches, cl = tlm.prefill(model, tb, MAX_LEN)
    want, got = [], []
    for jstep, tstep in step_inputs(cfg):
        jcl, cl = jcl + 1, cl + 1
        jl, jcaches = jlm.decode_step(params, jcfg, jstep, jcaches, jcl)
        tl, caches = tlm.decode_step(model, tstep, caches, cl)
        assert tuple(tl.shape) == jl.shape and tl.dtype == torch.bfloat16
        want.append(f32(jl)[:, 0])
        got.append(f32(tl)[:, 0])
    jax.effects_barrier()
    # step i's logits come from decode step i: its route events are the
    # prefill's and those of steps 0..i
    keep = compared_steps(routes, cfg, NEW + 1)[:, 1:]
    want, got = np.stack(want, axis=1), np.stack(got, axis=1)
    assert keep.any()
    tol = whole_depth_tol(arch, LOGITS_REL_TOL)
    assert np.max(np.abs(want - got)[keep]) / np.max(np.abs(want)) < tol
    if "cross" in tb:           # decode never writes the cross caches
        for l, c in enumerate(caches):
            if cfg.pattern[l % len(cfg.pattern)].mixer == "cross":
                assert rel(jcaches[l % len(cfg.pattern)]["k"][l // len(cfg.pattern)],
                           c["k"]) < LOGITS_REL_TOL
