"""PyTorch port, the serving path end to end on the CPU: the port's
``prefill`` (logits and caches), ``decode_step`` and ``generate`` against
the JAX package's ``lm.prefill``, ``lm.decode_step`` and
``serve.generate``, for qwen3-0.6b and mamba2-780m, at the reduced
configs (B=2, S=16) and at full width with depth 2 (B=2, a prompt of 160
tokens: ragged against the 64-row attention tiles, and two SSD chunks of
128 with padding).  The weights are the JAX package's seeded init,
carried across by ``models/convert.py``; the port runs its plain
versions (the CPU has no kernels).

Tolerances and why:
- logits (``LOGITS_REL_TOL``, ``max|Δ| / max|ref|``): weights and
  activations are bf16, and eager PyTorch rounds every operation's bf16
  result where XLA:CPU fuses elementwise chains (norms, SiLU gates,
  residual adds, the conv) and rounds once; through a few layers that is
  a few bf16 ULPs (2^-8 each) of the largest logit, so 2e-2 — inside the
  5 % that ``tests/test_models.py::test_decode_matches_forward`` allows
  between the JAX package's own two paths.
- caches (``CACHE_REL_TOL``): the same bf16 argument; the f32 SSM state
  sums over the whole prompt, so it is held to the same relative bound.
- tokens: compared teacher-forced.  Both models are fed the reference's
  greedy tokens; wherever the reference's top-1 minus top-2 logit margin
  exceeds the logits tolerance, the port's argmax must be the
  reference's token.  (A margin inside the tolerance is a near tie that
  the bf16 rounding above may break either way.)
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import generate as jgenerate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

LOGITS_REL_TOL = 2e-2
CACHE_REL_TOL = 2e-2

# (arch, full width?, batch, prompt length, new tokens)
CASES = [("qwen3-0.6b", False, 2, 16, 6), ("mamba2-780m", False, 2, 16, 6),
         ("qwen3-0.6b", True, 2, 160, 3), ("mamba2-780m", True, 2, 160, 3)]
IDS = ["qwen3-reduced", "mamba2-reduced", "qwen3-full-width-depth2",
       "mamba2-full-width-depth2"]


def _configs(arch, full):
    if full:
        return (dataclasses.replace(get_config(arch), n_layers=2),
                dataclasses.replace(jget_config(arch), n_layers=2))
    return get_config(arch, reduced=True), jget_config(arch, reduced=True)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _rel(want, got):
    want, got = _f32(want), _f32(got)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)), 1e-30))


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
    return _f32(jnp.stack(out, axis=1))


def _assert_tokens_under_margin(ref_logits, got_logits, ref_tokens):
    """Where the reference's top-1 minus top-2 margin exceeds the logits
    tolerance, the port's argmax equals the reference's token."""
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    decided = margin > LOGITS_REL_TOL * np.max(np.abs(ref_logits))
    got = np.argmax(got_logits, axis=-1)
    assert decided.any()
    np.testing.assert_array_equal(got[decided], ref_tokens[decided])
    return decided


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def pair(request):
    arch, full, b, s, new = request.param
    cfg, jcfg = _configs(arch, full)
    params = jlm.init_params(jcfg, jax.random.key(0))
    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return dict(cfg=cfg, jcfg=jcfg, params=params, model=model, prompt=prompt,
                new=new, max_len=s + new + 1)


def test_prefill_logits_and_caches_match_reference(pair):
    cfg, jcfg, prompt, max_len = pair["cfg"], pair["jcfg"], pair["prompt"], pair["max_len"]
    jlogits, jcaches, jclen = jlm.prefill(pair["params"], jcfg,
                                          {"tokens": jnp.asarray(prompt)}, max_len=max_len)
    logits, caches, clen = tlm.prefill(pair["model"], torch.from_numpy(prompt), max_len)
    assert tuple(logits.shape) == jlogits.shape and logits.dtype == torch.bfloat16
    assert _rel(jlogits, logits) < LOGITS_REL_TOL
    np.testing.assert_array_equal(clen.numpy(), np.asarray(jclen))
    assert len(caches) == cfg.n_layers
    for l, cache in enumerate(caches):
        r, i = divmod(l, len(cfg.pattern))
        want = jcaches[i]
        assert set(cache) == set(want)
        for name, got in cache.items():
            ref = np.asarray(want[name][r].astype(jnp.float32))
            assert str(got.dtype).split(".")[-1] == want[name].dtype.name, name
            assert tuple(got.shape) == ref.shape, name
            assert _rel(ref, got) < CACHE_REL_TOL, (l, name)


def test_decode_step_matches_reference(pair):
    """One decode step after the prefill, each side from its own caches."""
    cfg, jcfg, prompt, max_len = pair["cfg"], pair["jcfg"], pair["prompt"], pair["max_len"]
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (prompt.shape[0], 1)).astype(np.int32)
    _, jcaches, jclen = jlm.prefill(pair["params"], jcfg,
                                    {"tokens": jnp.asarray(prompt)}, max_len=max_len)
    jlogits, _ = jlm.decode_step(pair["params"], jcfg, {"tokens": jnp.asarray(tok)},
                                 jcaches, jclen + 1)
    _, caches, clen = tlm.prefill(pair["model"], torch.from_numpy(prompt), max_len)
    logits, caches = tlm.decode_step(pair["model"], torch.from_numpy(tok), caches, clen + 1)
    assert tuple(logits.shape) == jlogits.shape
    assert _rel(jlogits, logits) < LOGITS_REL_TOL


def test_generate_matches_reference_teacher_forced(pair):
    """``generate``'s greedy tokens against ``serve.generate``: the port's
    teacher-forced argmax equals the reference's token wherever the
    reference's margin exceeds the logits tolerance; the port's own
    greedy tokens equal the reference's up to the first position where
    the reference's margin is inside the tolerance."""
    cfg, jcfg, prompt, max_len, new = (pair[k] for k in ("cfg", "jcfg", "prompt",
                                                         "max_len", "new"))
    want = np.asarray(jgenerate(pair["params"], jcfg, jnp.asarray(prompt),
                                max_new=new, max_len=max_len))
    got = engine.generate(pair["model"], prompt, max_new=new, max_len=max_len)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    ref_logits = _jax_forced_logits(pair["params"], jcfg, jnp.asarray(prompt),
                                    jnp.asarray(want), max_len)
    forced = engine.teacher_forced_logits(pair["model"], prompt, torch.from_numpy(want.copy()),
                                          max_len=max_len)
    assert forced.shape == (*want.shape, cfg.vocab)
    assert _rel(ref_logits, forced) < LOGITS_REL_TOL
    decided = _assert_tokens_under_margin(ref_logits, _f32(forced), want)
    for row in range(want.shape[0]):
        undecided = np.flatnonzero(~decided[row])
        upto = undecided[0] if undecided.size else want.shape[1]
        np.testing.assert_array_equal(got.numpy()[row, :upto], want[row, :upto])


def test_generate_defaults_to_the_card():
    """A model is built on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.LM(get_config("qwen3-0.6b", reduced=True))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m"])
def test_init_cache_matches_reference(arch):
    """Empty caches: one dict a layer with the reference's names, shapes
    (its ``[G, ...]`` stack split per layer) and dtypes, all zeros."""
    cfg, jcfg = _configs(arch, False)
    want = jlm.init_cache(jcfg, 3, 20)
    got = tlm.init_cache(cfg, 3, 20, "cpu")
    assert len(got) == cfg.n_layers
    for l, cache in enumerate(got):
        ref = want[l % len(cfg.pattern)]
        assert set(cache) == set(ref)
        for name, t in cache.items():
            assert tuple(t.shape) == ref[name].shape[1:], name
            assert str(t.dtype).split(".")[-1] == ref[name].dtype.name, name
            assert not t.any()
