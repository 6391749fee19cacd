"""PyTorch port, serving slice, module by module on the CPU: the plain
versions of the two kernels against the JAX package's Pallas kernels
(interpret mode) and oracles (and, with a value head dim of its own and
non-causal Sk > Sq, against ``blocked_attention``), the attention and
Mamba-2 layers against the JAX layers, the configs and parameter counts
of all ten architectures, and the weight converter.

All inputs are made with numpy from a seed and handed to both sides.

Tolerances and why:
- kernels, f32 (``KERNEL_F32_TOL``, ``SSD_TOL``): the tolerances of
  ``tests/test_kernels.py``; the two sides sum in another order only.
- kernels, bf16 in and out (``KERNEL_BF16_TOL``): as there, one bf16
  rounding of the output (2^-8 relative) against an f32 oracle.
- layers (``LAYER_REL_TOL``, relative to the largest reference value):
  the weights and activations are bf16, and eager PyTorch rounds each
  operation's bf16 result where XLA:CPU fuses an elementwise chain and
  rounds once; a few bf16 ULPs (2^-8 each) of difference, so 2e-2.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels.flash_attn.ops import gqa_flash_attention  # noqa: E402
from repro.kernels.flash_attn.ref import attention_ref as jattention_ref  # noqa: E402
from repro.kernels.ssd_scan.kernel import ssd_chunk_scan as jssd_chunk_scan  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_jnp_with_state  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attn import ref as flash_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402


@pytest.fixture(autouse=True)
def serving_without_autograd():
    """The layers run here as serving runs them, under ``torch.no_grad()``
    (the parameters are trainable: a result that requires grad has no
    ``.numpy()``)."""
    with torch.no_grad():
        yield


KERNEL_F32_TOL = 2e-5
KERNEL_BF16_TOL = 2e-2
SSD_TOL = 2e-4
LAYER_REL_TOL = 2e-2

ARCHS = ("qwen3-0.6b", "mamba2-780m")
ALL_ARCHS = JARCH_IDS


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _t(a, dtype=None):
    """numpy -> torch, through f32 for bf16 (exact)."""
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(dtype) if dtype is not None else t


def _rel(want, got):
    want, got = _np(want), _np(got)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)), 1e-30))


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(arch, reduced):
    want = dataclasses.asdict(jget_config(arch, reduced=reduced))
    got = dataclasses.asdict(get_config(arch, reduced=reduced))
    assert got == want


def test_unported_arch_raises():
    """Every arch of the JAX package's registry is ported; an unknown id
    raises ``KeyError``, as there."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mixtral-8x23b")
    with pytest.raises(KeyError):
        jget_config("mixtral-8x23b")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_equals_reference(arch):
    """The port's full-width model, built on ``device="meta"`` (no memory),
    holds as many parameters as ``jax.eval_shape(lm.init_params)``."""
    from repro_torch.models import lm as tlm
    jcfg = jget_config(arch)
    shapes = jax.eval_shape(lambda: jlm.init_params(jcfg, jax.random.key(0)))
    want = sum(int(x.size) for x in jax.tree.leaves(shapes))
    model = tlm.LM(get_config(arch), device="meta")
    assert sum(p.numel() for p in model.parameters()) == want


# ------------------------------------------------------ flash_attention

# the cases of tests/test_kernels.py::test_flash_attention_matches_oracle
# (b, hq, hkv, sq, sk, d, causal, window, dtype)
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, True, 0, "f32"),
    (2, 4, 2, 256, 256, 32, True, 0, "f32"),
    (1, 2, 1, 128, 256, 64, True, 0, "f32"),
    (1, 2, 2, 128, 128, 64, True, 64, "f32"),
    (1, 2, 2, 64, 64, 16, False, 0, "f32"),
    (1, 2, 2, 128, 128, 64, True, 0, "bf16"),
]
# ragged and edge cases the TPU kernel's tiling cannot take: S=300, Sq != Sk
# (q shorter, and q longer: rows with no unmasked key), one query row,
# windows, non-causal, the model's GQA head shape
RAGGED_CASES = [
    (2, 2, 1, 300, 300, 32, True, 0, "f32"),
    (1, 2, 2, 100, 300, 16, True, 0, "f32"),
    (1, 2, 2, 130, 70, 16, True, 0, "f32"),
    (2, 4, 2, 1, 77, 16, True, 0, "f32"),
    (1, 2, 1, 300, 300, 16, True, 50, "f32"),
    (1, 2, 2, 70, 130, 16, False, 0, "f32"),
    (1, 2, 2, 90, 200, 16, False, 40, "f32"),
    (1, 4, 2, 160, 160, 128, True, 0, "bf16"),
]


def _flash_inputs(case, seed=7):
    b, hq, hkv, sq, sk, d, _, _, dt = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    return ([jnp.asarray(a, jdt) for a in (q, k, v)],
            [_t(a, tdt) for a in (q, k, v)])


def _rep(x, n):
    return jnp.repeat(x, n, axis=1)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_and_oracle(case):
    _, hq, hkv, _, _, _, causal, win, dt = case
    (jq, jk, jv), (q, k, v) = _flash_inputs(case)
    want_kernel = gqa_flash_attention(jq, jk, jv, causal=causal, window=win)
    want_ref = jattention_ref(jq, _rep(jk, hq // hkv), _rep(jv, hq // hkv),
                              causal=causal, window=win)
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=win)
    naive = flash_ref.attention_ref(q, k, v, causal=causal, window=win)
    tol = KERNEL_F32_TOL if dt == "f32" else KERNEL_BF16_TOL
    assert got.dtype == q.dtype and got.shape == q.shape
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(naive), _np(want_ref), rtol=KERNEL_F32_TOL,
                               atol=KERNEL_F32_TOL)


# (b, hq, hkv, sq, sk, d, dv, causal, q_chunk, k_chunk): a value head dim
# of its own (MLA's q/k 24 and v 16 reduced, 96 and 64 full) and
# cross-attention's non-causal Sk > Sq (the reduced feed of 32 rows; Sk
# past one 64-row tile), against the JAX package's blocked_attention
DV_CASES = [
    (2, 5, 5, 16, 16, 24, 16, True, 16, 16),
    (1, 4, 4, 128, 128, 96, 64, True, 64, 64),
    (2, 4, 2, 16, 32, 16, 16, False, 16, 16),
    (1, 4, 2, 40, 160, 32, 32, False, 8, 32),
    (1, 2, 1, 48, 200, 48, 24, False, 16, 40),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", DV_CASES)
def test_flash_plain_dv_and_cross_match_blocked_attention(case, dt):
    b, hq, hkv, sq, sk, d, dv, causal, qc, kc = case
    rng = np.random.default_rng(sq + sk + d)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, dv)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = jattn.blocked_attention(jq, _rep(jk, hq // hkv), _rep(jv, hq // hkv),
                                   causal=causal, q_chunk=qc, k_chunk=kc)
    got = flash_ops.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (b, hq, sq, dv)
    tol = KERNEL_F32_TOL if dt == "f32" else KERNEL_BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    naive = flash_ref.attention_ref(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(_np(naive), _np(jattn.blocked_attention(
        *(jnp.asarray(a) for a in (q, np.repeat(k, hq // hkv, 1), np.repeat(v, hq // hkv, 1))),
        causal=causal, q_chunk=qc, k_chunk=kc)), rtol=KERNEL_F32_TOL, atol=KERNEL_F32_TOL)


def test_flash_plain_bf16_scores_match_blocked_attention():
    """``attn_bf16``: the plain version rounds scores and probabilities to
    bf16 as ``blocked_attention(score_dtype=bf16)`` does (on a card the
    tensor-core kernel's bf16-score variant does the same)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 2, 64, 16)).astype(np.float32) for _ in range(3))
    want = jattn.blocked_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                                   q_chunk=64, k_chunk=64, score_dtype=jnp.bfloat16)
    got = flash_ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                    score_dtype=torch.bfloat16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=KERNEL_BF16_TOL, atol=KERNEL_BF16_TOL)
    f32 = flash_ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_flash_plain_ragged_matches_oracle(case):
    _, hq, hkv, _, _, _, causal, win, dt = case
    (jq, jk, jv), (q, k, v) = _flash_inputs(case, seed=3)
    want = jattention_ref(jq, _rep(jk, hq // hkv), _rep(jv, hq // hkv),
                          causal=causal, window=win)
    got = flash_ref.flash_attention_ref(q, k, v, causal=causal, window=win)
    tol = KERNEL_F32_TOL if dt == "f32" else KERNEL_BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_flash_key_tiles_skip_only_masked_tiles():
    """Causal prefill: query tile t visits key tiles 0..t; a window starts
    later; rows with no unmasked key (q longer than k) visit every tile."""
    assert list(flash_ref.key_tiles(128, 64, 512, 512, True, 0)) == [0, 1, 2]
    assert list(flash_ref.key_tiles(256, 64, 512, 512, True, 100)) == [2, 3, 4]
    assert list(flash_ref.key_tiles(0, 64, 130, 70, True, 0)) == [0, 1]
    assert list(flash_ref.key_tiles(0, 64, 300, 300, False, 0)) == [0, 1, 2, 3, 4]


# ------------------------------------------------------- ssd_chunk_scan

# the cases of tests/test_kernels.py::test_ssd_kernel_and_jnp_match_sequential
# (BH, L, P, N, chunk)
SSD_CASES = [(2, 64, 16, 32, 16), (1, 128, 64, 128, 32), (3, 96, 8, 16, 48)]


def _ssd_inputs(case, seed=11):
    BH, L, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((BH, L, P)) * 0.5).astype(np.float32)
    loga = (-np.abs(rng.standard_normal((BH, L))) * 0.3).astype(np.float32)
    B = (rng.standard_normal((BH, L, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((BH, L, N)) * 0.3).astype(np.float32)
    return x, loga, B, C


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_pallas_jnp_and_sequential(case):
    chunk = case[-1]
    arrs = _ssd_inputs(case)
    jx = [jnp.asarray(a) for a in arrs]
    tx = [_t(a) for a in arrs]
    for want, got in zip(jssd_chunk_scan(*jx, chunk=chunk),
                         ssd_ops.ssd_chunk_scan(*tx, chunk=chunk)):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=SSD_TOL, atol=SSD_TOL)
    y, state = ssd_ops.ssd_with_state(*tx, chunk=chunk)
    jy, jstate = ssd_jnp_with_state(*jx, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(_np(state), _np(jstate), rtol=SSD_TOL, atol=SSD_TOL)
    seq = jssd_ref(*jx)
    np.testing.assert_allclose(_np(y), _np(seq), rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(_np(ssd_ref.ssd_ref(*tx)), _np(seq),
                               rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_plain_takes_bf16_b_and_c():
    """On the model path B and C arrive in bf16 (f32 inside, as the Pallas
    kernel casts them)."""
    case = (2, 64, 16, 32, 16)
    x, loga, B, C = _ssd_inputs(case)
    Bb, Cb = (jnp.asarray(a, jnp.bfloat16) for a in (B, C))
    want = jssd_chunk_scan(jnp.asarray(x), jnp.asarray(loga), Bb, Cb, chunk=16)
    got = ssd_ops.ssd_chunk_scan(_t(x), _t(loga), _t(B, torch.bfloat16),
                                 _t(C, torch.bfloat16), chunk=16)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), _np(w), rtol=SSD_TOL, atol=SSD_TOL)


# -------------------------------------------------------------- layers


def _model_pair(arch, seed=0):
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    params = jlm.init_params(jcfg, jax.random.key(seed))
    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return cfg, jcfg, params, model


def _layer0(params):
    return jax.tree.map(lambda t: t[0], params["groups"][0])


def _act(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), _t(a, torch.bfloat16)


def test_attention_layer_matches_reference():
    """attn_qkv + gqa (prefill) and decode_attention, layer 0 of the
    reduced qwen3-0.6b, against the JAX layer on the same inputs."""
    cfg, jcfg, params, model = _model_pair("qwen3-0.6b")
    p, tp = _layer0(params)["mixer"], model.layers[0].mixer
    rng = np.random.default_rng(5)
    B, S = 2, 24
    jx, tx = _act(rng, (B, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jq, jk, jv = jattn.attn_qkv(p, jcfg, jx, jx, jnp.asarray(pos), None)
    q, k, v = tattn.attn_qkv(tp, cfg, tx, tx, torch.from_numpy(pos.copy()))
    for want, got in ((jq, q), (jk, k), (jv, v)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert _rel(want, got) < LAYER_REL_TOL
    # attention itself from the same (JAX) q, k, v
    qq, kk, vv = (_t(np.asarray(a, np.float32), torch.bfloat16) for a in (jq, jk, jv))
    want = jattn.gqa(jq, jk, jv, causal=True, q_chunk=jcfg.q_chunk,
                     k_chunk=jcfg.k_chunk)
    got = tattn.gqa(qq, kk, vv, causal=True)
    assert got.shape == qq.shape and _rel(want, got) < LAYER_REL_TOL
    # decode: caches of length 32 with 20 valid rows
    jkc, tkc = _act(rng, (B, 32, cfg.n_kv_heads, cfg.head_dim_))
    jvc, tvc = _act(rng, (B, 32, cfg.n_kv_heads, cfg.head_dim_))
    jq1, tq1 = _act(rng, (B, 1, cfg.n_heads, cfg.head_dim_))
    clen = np.array([20, 13], np.int32)
    for win in (0, 8):
        want = jattn.decode_attention(jq1, jkc, jvc, jnp.asarray(clen), window=win)
        got = tattn.decode_attention(tq1, tkc, tvc, torch.from_numpy(clen), window=win)
        assert got.dtype == torch.bfloat16 and _rel(want, got) < LAYER_REL_TOL


@pytest.mark.parametrize("S", [24, 70])
def test_attention_layer_with_bf16_scores_matches_reference(S):
    """``cfg.attn_bf16``: layer 0 of the reduced qwen3-0.6b through the
    port's ``attn_apply`` on the kernel backend (on the CPU, the plain
    version with bf16 scores) against the JAX ``attn_apply`` with
    ``attn_bf16=True`` on the same input (70: two query tiles here, one
    chunk there); the f32-score layer differs from it."""
    cfg, jcfg, params, model = _model_pair("qwen3-0.6b")
    cfg, jcfg = (dataclasses.replace(c, attn_bf16=True) for c in (cfg, jcfg))
    p, tp = _layer0(params)["mixer"], model.layers[0].mixer
    jx, tx = _act(np.random.default_rng(6), (2, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want = jattn.attn_apply(p, jcfg, jx, jnp.asarray(pos), None)
    got, _, _ = tattn.attn_apply(tp, cfg, tx, torch.from_numpy(pos.copy()), backend="kernel")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _rel(want, got) < LAYER_REL_TOL
    f32, _, _ = tattn.attn_apply(tp, dataclasses.replace(cfg, attn_bf16=False), tx,
                                 torch.from_numpy(pos.copy()), backend="kernel")
    assert not torch.equal(f32, got)


@pytest.mark.parametrize("S", [16, 21])
def test_mamba_layer_matches_reference(S):
    """mamba_apply(return_state=True) over a prompt (21: padded to a chunk
    multiple), then mamba_decode from the JAX cache, layer 0 of the
    reduced mamba2-780m."""
    cfg, jcfg, params, model = _model_pair("mamba2-780m")
    p, tp = _layer0(params)["mixer"], model.layers[0].mixer
    rng = np.random.default_rng(9)
    jx, tx = _act(rng, (2, S, cfg.d_model))
    jout, jcache = jmamba.mamba_apply(p, jcfg, jx, return_state=True)
    out, cache = tmamba.mamba_apply(tp, cfg, tx, return_state=True)
    assert out.dtype == torch.bfloat16 and _rel(jout, out) < LAYER_REL_TOL
    assert set(cache) == set(jcache)
    for name in jcache:
        assert cache[name].dtype == torch.float32
        assert tuple(cache[name].shape) == jcache[name].shape, name
        assert _rel(jcache[name], cache[name]) < LAYER_REL_TOL, name
    jx1, tx1 = _act(rng, (2, 1, cfg.d_model))
    tcache = {k: _t(np.asarray(v)) for k, v in jcache.items()}
    jo, jc = jmamba.mamba_decode(p, jcfg, jx1, jcache)
    o, c = tmamba.mamba_decode(tp, cfg, tx1, tcache)
    assert o.dtype == torch.bfloat16 and _rel(jo, o) < LAYER_REL_TOL
    for name in jc:
        assert _rel(jc[name], c[name]) < LAYER_REL_TOL, name


# ----------------------------------------------------------- converter


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_converter_maps_every_leaf_once_exactly(arch):
    cfg = get_config(arch, reduced=True)
    params = jlm.init_params(jget_config(arch, reduced=True), jax.random.key(1))
    pnp = jax.tree.map(np.asarray, params)
    model = convert.from_jax_params(cfg, pnp, device="cpu")
    sd = model.state_dict()
    seen = set()
    for i, group in enumerate(pnp["groups"]):
        for path, leaf in jax.tree_util.tree_flatten_with_path(group)[0]:
            name = ".".join(str(k.key) for k in path)
            for r in range(cfg.repeats):
                key = f"layers.{r * len(cfg.pattern) + i}.{name}"
                assert key not in seen
                seen.add(key)
                got = sd[key]
                assert str(got.dtype).split(".")[-1] == leaf.dtype.name, key
                assert got.float().numpy().tobytes() == \
                    np.asarray(leaf[r], np.float32).tobytes(), key
    for name in ("embed", "final_norm", "lm_head"):
        assert (name in pnp) == (name in sd), name
        if name in pnp:
            seen.add(name)
            assert sd[name].float().numpy().tobytes() == \
                np.asarray(pnp[name], np.float32).tobytes()
    assert seen == set(sd)


def test_converter_refuses_a_missing_leaf():
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = jlm.init_params(jget_config("qwen3-0.6b", reduced=True), jax.random.key(1))
    pnp = jax.tree.map(np.asarray, params)
    del pnp["groups"][0]["mixer"]["wq"]
    with pytest.raises(RuntimeError, match="wq"):
        convert.from_jax_params(cfg, pnp, device="cpu")


# ----------------------------- the serving path's operands (CPU rehearsal)


@pytest.mark.parametrize("arch", ARCHS + ("minicpm3-4b", "llama-3.2-vision-90b"))
def test_serving_operands_pass_every_wrapper_check(monkeypatch, arch):
    """Each CUDA wrapper checks device, dtype, shape and strides of every
    operand before it asks for the card.  Route a full-width prefill's
    real calls (depth 1, a 130-token prompt: one 128-row SSD chunk plus a
    padded one) through the wrappers on the CPU: every check must pass,
    so the only refusal left is the one that says the tensors are not on
    a card.  This is where a strided view such as ``gqa``'s
    ``[B, S, H, D]`` -> ``[B, H, S, D]`` transpose, or MLA's v (the last
    64 columns of the expanded latents' rows), is caught.  MLA
    (minicpm3-4b) and cross-attention (llama-3.2-vision-90b's cross layer
    onto its 4096-row feed) keep their attention widths; their vocab and
    d_ff, which no kernel sees, are cut."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.models import lm as tlm

    calls, kinds = {}, []

    def rehearse(mod, name, plain, kind):
        orig = getattr(mod, name)

        def wrapper(*args, **kw):
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                orig(*args, **kw)
            calls[name] = calls.get(name, 0) + 1
            kinds.append(kind(*args, **kw))
            return plain(*args, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    rehearse(FK, "flash_attention", flash_ref.flash_attention_ref,
             lambda q, k, v, **_: FK.variant(q, k, v))
    # bf16 B/C in group form ([B*G, S, N]) go to the tensor-core kernel
    rehearse(SK, "ssd_chunk_scan", ssd_ref.ssd_chunk_scan_ref,
             lambda x, loga, B, C, chunk: (SK.variant(x, loga, B, C, chunk=chunk),
                                           B.shape[0], C.shape[0]))
    monkeypatch.setattr(build, "use_kernel", lambda backend, x: backend == "kernel")
    cfg = get_config(arch)
    cut = (dict(vocab=512, d_ff=128, pattern=cfg.pattern[-1:])
           if arch in ("minicpm3-4b", "llama-3.2-vision-90b") else {})
    cfg = dataclasses.replace(cfg, n_layers=1, **cut)
    model = tlm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 130), generator=g)}
    if cfg.cross_kv_len:
        batch["cross"] = torch.randn((2, cfg.cross_kv_len, cfg.d_model),
                                     generator=g).to(torch.bfloat16)
    tlm.prefill(model, batch, 140)
    want = "ssd_chunk_scan" if arch.startswith("mamba2") else "flash_attention"
    assert calls == {want: 1}
    assert kinds == ([("tc", 2 * cfg.ssm.n_groups, 2 * cfg.ssm.n_groups)]
                     if arch.startswith("mamba2") else ["tc"])


class _OnCard:
    """A stand-in operand that reports a CUDA device (the CPU has none)."""
    device = torch.device("cuda")


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_chunk_scan"])
def test_a_cuda_tensor_never_reaches_a_plain_version(monkeypatch, kernel):
    """With the ``"kernel"`` backend a CUDA operand goes to the kernel's
    wrapper (which launches or raises); only ``backend="plain"`` or a CPU
    tensor takes the plain version."""
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.ssd_scan import kernel as SK

    mod, ops_mod, plain_mod, plain = (
        (FK, flash_ops, flash_ref, "flash_attention_ref") if kernel == "flash_attention"
        else (SK, ssd_ops, ssd_ref, "ssd_chunk_scan_ref"))
    taken = []
    monkeypatch.setattr(mod, kernel, lambda *a, **k: taken.append("kernel"))
    monkeypatch.setattr(plain_mod, plain, lambda *a, **k: taken.append("plain"))
    call = getattr(ops_mod, kernel)
    x = _OnCard()
    args, kw = ((x,) * 4, {"chunk": 16}) if kernel == "ssd_chunk_scan" else ((x,) * 3, {})
    call(*args, **kw)
    assert taken == ["kernel"]
    with pytest.raises(KeyError):
        call(*args, backend="pallas", **kw)
