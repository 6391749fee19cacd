"""PyTorch port, ``models/mla.py`` on the CPU against the JAX package's
``models/mla.py``: the prefill (``mla_apply``: the latents expanded to
per-head K/V, attention with q/k of ``qk_nope + qk_rope`` columns and v
of ``v_head_dim`` through the flash_attention plain version) and its
latents, and the absorbed decode (``mla_decode``) writing each new
latent into the bf16 caches, at the reduced minicpm3-4b (5 heads of
24/16); then minicpm3-4b at full width (40 heads of 96/64, latent 256),
depth 1, on a 16-token prompt, through ``prefill`` and ``decode_step``.
Same parameters (the JAX package's init) and the same inputs, made with
numpy from a seed.

Tolerance (``LAYER_REL_TOL``, max |Δ| / max |ref|): the weights and
activations are bf16, and eager PyTorch rounds each operation's bf16
result where XLA:CPU fuses an elementwise chain; a few bf16 ULPs (2^-8
each), so 2e-2, as the other layers' tests.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402


@pytest.fixture(autouse=True)
def serving_without_autograd():
    """The layers run here as serving runs them, under ``torch.no_grad()``
    (the parameters are trainable: a result that requires grad has no
    ``.numpy()``)."""
    with torch.no_grad():
        yield


LAYER_REL_TOL = 2e-2


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _rel(want, got):
    want, got = _f32(want), _f32(got)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)), 1e-30))


def _act(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


@pytest.fixture(scope="module")
def layer():
    """Layer 0's MLA of the reduced minicpm3-4b: (cfg, JAX params, port module)."""
    cfg, jcfg = get_config("minicpm3-4b", reduced=True), jget_config("minicpm3-4b", reduced=True)
    params = jlm.init_params(jcfg, jax.random.key(0))
    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    p = jax.tree.map(lambda t: t[0], params["groups"][0])["mixer"]
    return cfg, p, model.layers[0].mixer


@pytest.mark.parametrize("s", [16, 37])
def test_mla_prefill_and_latents_match_reference(layer, s):
    """mla_apply and mla_latents on a prompt (37: ragged against the
    kernel's 64-row tiles, as the plain version visits them)."""
    cfg, p, tp = layer
    rng = np.random.default_rng(s)
    jx, x = _act(rng, (2, s, cfg.d_model))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want = jmla.mla_apply(p, cfg, jx, jnp.asarray(pos))
    jckv, jkr = jmla.mla_latents(p, cfg, jx, jnp.asarray(pos))
    got, ckv, kr = tmla.mla_apply(tp, cfg, x, torch.from_numpy(pos.copy()))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _rel(want, got) < LAYER_REL_TOL
    for w, g in ((jckv, ckv), (jkr, kr)):
        assert tuple(g.shape) == w.shape and _rel(w, g) < LAYER_REL_TOL


def test_mla_decode_matches_reference(layer):
    """The absorbed decode from the same bf16 caches (20 rows valid of
    32, rows 13 and 20 written by this token): the output, and the caches
    with the new latent written at ``cache_len - 1`` in place."""
    cfg, p, tp = layer
    m = cfg.mla
    rng = np.random.default_rng(3)
    jckv, ckv = _act(rng, (2, 32, m.kv_lora_rank))
    jkr, kr = _act(rng, (2, 32, m.qk_rope_dim))
    jx1, x1 = _act(rng, (2, 1, cfg.d_model))
    clen = np.array([20, 13], np.int32)
    pos = (clen - 1)[:, None]
    want, wckv, wkr = jmla.mla_decode(p, cfg, jx1, jnp.asarray(pos), jckv, jkr,
                                      jnp.asarray(clen))
    before = ckv.clone()
    got = tmla.mla_decode(tp, cfg, x1, torch.from_numpy(pos), ckv, kr, torch.from_numpy(clen))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _rel(want, got) < LAYER_REL_TOL
    assert ckv.dtype == kr.dtype == torch.bfloat16
    assert _rel(wckv, ckv) < LAYER_REL_TOL and _rel(wkr, kr) < LAYER_REL_TOL
    changed = (ckv != before).any(dim=-1)
    assert changed.sum() == 2 and changed[0, 19] and changed[1, 12]


def test_minicpm3_full_width_depth1_prefill_and_decode():
    """minicpm3-4b at its full width (40 heads, q/k 96, v 64, latent 256),
    one layer, a 16-token prompt: prefill logits and the ckv/kr caches,
    then one decode step, against the JAX package's."""
    cfg = dataclasses.replace(get_config("minicpm3-4b"), n_layers=1)
    jcfg = dataclasses.replace(jget_config("minicpm3-4b"), n_layers=1)
    params = jlm.init_params(jcfg, jax.random.key(0))
    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(16)
    prompt = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    jl, jc, jcl = jlm.prefill(params, jcfg, {"tokens": jnp.asarray(prompt)}, max_len=20)
    logits, caches, cl = tlm.prefill(model, {"tokens": torch.from_numpy(prompt)}, 20)
    assert _rel(jl, logits) < LAYER_REL_TOL
    assert set(caches[0]) == {"ckv", "kr"}
    for name in ("ckv", "kr"):
        assert caches[0][name].dtype == torch.bfloat16
        assert tuple(caches[0][name].shape) == jc[0][name].shape[1:]
        assert _rel(jc[0][name][0], caches[0][name]) < LAYER_REL_TOL
    tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    jd, _ = jlm.decode_step(params, jcfg, {"tokens": jnp.asarray(tok)}, jc, jcl + 1)
    d, _ = tlm.decode_step(model, torch.from_numpy(tok), caches, cl + 1)
    assert _rel(jd, d) < LAYER_REL_TOL
