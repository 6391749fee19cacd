"""PyTorch port, the model zoo's token architectures on the CPU:
``generate`` teacher-forced against the JAX package's ``serve.generate``
at the reduced configs (llama-3.2-vision-90b needs its cross feed, which
``generate`` does not take, as in the JAX package; musicgen-large has no
tokens to generate).  The models, inputs, MoE route recording and
tolerances are ``tests/test_torch_zoo_serve.py``'s.

Tokens are compared as ``tests/test_torch_serve.py`` compares them: both
fed the reference's greedy tokens, the port's argmax equals the
reference's token wherever the reference's top-1 minus top-2 margin
exceeds the logits tolerance (``whole_depth_tol``).  A row is compared
up to its first step whose input some MoE layer routed otherwise than the
reference (an undecided route, see ``flagged``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import generate as jgenerate  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from test_torch_zoo_serve import (LOGITS_REL_TOL, MAX_LEN, NEW, Routes, f32,  # noqa: E402
                                  inputs, pair, torch_one_thread,  # noqa: F401 (fixture)
                                  whole_depth_tol)
from test_torch_zoo_serve_b import compared_steps  # noqa: E402

GENERATE_ARCHS = ("qwen2-0.5b", "phi3-mini-3.8b", "minicpm3-4b", "dbrx-132b",
                  "mixtral-8x22b", "jamba-1.5-large-398b")


def _jax_forced_logits(params, cfg, prompt, forced, max_len):
    """The reference's logits scoring each column of ``forced`` (teacher
    forcing: prefill, then decode steps fed ``forced``)."""
    logits, caches, cl = jlm.prefill(params, cfg, {"tokens": prompt}, max_len=max_len)
    out = [logits[:, -1, :cfg.vocab]]
    for i in range(forced.shape[1] - 1):
        cl = cl + 1
        logits, caches = jlm.decode_step(params, cfg, {"tokens": forced[:, i:i + 1]},
                                         caches, cl)
        out.append(logits[:, -1, :cfg.vocab])
    return f32(jnp.stack(out, axis=1))


@pytest.mark.parametrize("arch", GENERATE_ARCHS)
def test_generate_matches_reference_teacher_forced(arch, monkeypatch, torch_one_thread):
    """``generate``'s greedy tokens against ``serve.generate``: teacher-
    forced, the port's argmax equals the reference's token wherever the
    reference's margin exceeds the logits tolerance; the port's own greedy
    tokens equal the reference's up to the first position where the
    margin is inside the tolerance (or a MoE route was undecided)."""
    cfg, jcfg, params, model = pair(arch)
    jb, tb = inputs(cfg)
    want = np.asarray(jgenerate(params, jcfg, jb["tokens"], max_new=NEW, max_len=MAX_LEN))
    got = engine.generate(model, tb["tokens"], max_new=NEW, max_len=MAX_LEN)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    routes = Routes(monkeypatch)
    ref_logits = _jax_forced_logits(params, jcfg, jb["tokens"], jnp.asarray(want), MAX_LEN)
    forced = engine.teacher_forced_logits(model, tb["tokens"], torch.from_numpy(want.copy()),
                                          max_len=MAX_LEN)
    jax.effects_barrier()
    del routes.port[len(routes.jax):]       # the port's last step scores nothing
    keep = compared_steps(routes, cfg, NEW)
    forced = f32(forced)
    assert forced.shape == (*want.shape, cfg.vocab) and keep.any()
    scale, tol = np.max(np.abs(ref_logits)), whole_depth_tol(arch, LOGITS_REL_TOL)
    assert np.max(np.abs(ref_logits - forced)[keep]) / scale < tol
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0] > tol * scale) & keep
    assert decided.any()
    np.testing.assert_array_equal(np.argmax(forced, axis=-1)[decided], want[decided])
    for row in range(want.shape[0]):
        undecided = np.flatnonzero(~decided[row])
        upto = undecided[0] if undecided.size else want.shape[1]
        np.testing.assert_array_equal(got.numpy()[row, :upto], want[row, :upto])
