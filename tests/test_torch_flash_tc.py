"""PyTorch port, the tensor-core ``flash_attention`` kernel on the CPU:
which kernel takes a call, what the wrapper refuses, and a rehearsal of
the kernel's rounding.

The bf16 kernel (``csrc/flash_attn_tc.cu``) runs only on a card.  Here:
- ``variant()`` on the serving path's real operands (a full-width
  qwen3-0.6b prefill at depth 1) gives ``"tc"``, f32 gives ``"simt"``;
  bf16 operands the kernel does not take raise ``ValueError`` (no
  fallback to the SIMT kernel);
- ``tc_rehearsal`` repeats the kernel's arithmetic in plain torch (bf16
  ``Q·Kᵀ`` summed in f32, the scale after the sum, the softmax in the
  log2 domain, P rounded to bf16 before ``P·V``, the row sums from the
  unrounded P) on the card's bf16 cases at CPU-sized head counts, so the
  error it costs is known before any card run.  It is held, within the
  bf16 tolerance 2e-2 (one bf16 rounding of the output and of P),
  against the plain version ``flash_attention_ref`` and against the JAX
  package's f32 oracle, fed the same numpy inputs;
- ``tc_rehearsal(score_bf16=True)`` repeats the kernel's bf16-score
  variant (``cfg.attn_bf16``: each score scaled, masked and rounded to
  bf16 in the natural domain before the log2 domain, the running max
  from the rounded scores, each probability rounded before the row sum
  and ``P·V``), held within 2e-2 to ``flash_attention_ref(score_dtype=
  bf16)`` and to the JAX package's ``blocked_attention(score_dtype=bf16)``;
  f32 operands with bf16 scores raise ``ValueError`` (the SIMT kernel
  keeps f32 scores).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn.ref import attention_ref as jattention_ref  # noqa: E402
from repro.models.attention import blocked_attention  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attn import ref as FR  # noqa: E402

FLASH_BF16_TOL = 2e-2
LOG2E = 1.4426950408889634


def tc_rehearsal(q, k, v, *, causal=True, window=0, score_bf16=False):
    """The tensor-core kernel's rounding in plain torch (its tiles, its
    masks, its order of rounding); returns bf16 ``[B, Hq, Sq, D]``.
    ``score_bf16``: its bf16-score variant's."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    k, v = FR._kv_heads(q, k, v)
    qf, kf, vf = q.float(), k.float(), v.float()
    scale, l2 = torch.tensor(d ** -0.5, dtype=torch.float32), torch.tensor(LOG2E)
    sl2 = scale * l2
    start = torch.tensor(FR.NEG_INF, dtype=torch.float32) * (l2 if score_bf16 else 1)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype)
    for q0 in range(0, sq, FR.BLOCK_Q):
        rows = min(FR.BLOCK_Q, sq - q0)
        qpos = torch.arange(q0, q0 + rows)[:, None] + (sk - sq)
        m = torch.full((b, hq, rows, 1), float(start))
        l = torch.zeros((b, hq, rows, 1))
        acc = torch.zeros((b, hq, rows, d))
        for t in FR.key_tiles(q0, rows, sq, sk, causal, window):
            k0 = t * FR.BLOCK_K
            kt, vt = kf[:, :, k0:k0 + FR.BLOCK_K], vf[:, :, k0:k0 + FR.BLOCK_K]
            kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            raw = qf[:, :, q0:q0 + rows] @ kt.transpose(-1, -2)
            mask = FR._mask(qpos, kpos, causal, window)
            if score_bf16:
                s = torch.where(mask, raw * scale, FR.NEG_INF).to(torch.bfloat16).float() * l2
            else:
                s = torch.where(mask, raw * sl2, FR.NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2(s - m_new)
            if score_bf16:
                p = p.to(torch.bfloat16).float()
            alpha = torch.exp2(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = alpha * acc + p.to(torch.bfloat16).float() @ vt
            m = m_new
        out[:, :, q0:q0 + rows] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out


def _inputs(b, hq, hkv, sq, sk, d, seed=5):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return arrs, [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


# the card's bf16 cases (chip_smoke.py FLASH_CASES) at CPU-sized head
# counts: (b, hq, hkv, sq, sk, d, causal, window)
REHEARSAL_CASES = [
    (1, 4, 2, 512, 512, 128, True, 0),      # qwen3-0.6b prefill, 4 of its 16 heads
    (2, 2, 1, 300, 300, 128, True, 0),      # ragged prompt
    (1, 2, 1, 100, 300, 64, True, 0),       # Sq != Sk
    (1, 2, 2, 130, 70, 32, True, 0),        # rows with no key
    (2, 4, 2, 1, 77, 16, True, 0),          # one query row
    (1, 2, 1, 300, 300, 64, True, 50),      # sliding window
    (1, 2, 2, 90, 200, 48, False, 40),      # non-causal with a window
    (1, 4, 2, 200, 200, 96, True, 0),       # D = 96 (padded to 128)
    (1, 2, 2, 160, 160, 16, True, 0),       # D = 16 (padded to 64)
]


@pytest.mark.parametrize("case", REHEARSAL_CASES)
def test_tc_rounding_rehearsal_within_bf16_tolerance(case):
    b, hq, hkv, sq, sk, d, causal, win = case
    (nq, nk, nv), (q, k, v) = _inputs(b, hq, hkv, sq, sk, d)
    got = tc_rehearsal(q, k, v, causal=causal, window=win)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    plain = FR.flash_attention_ref(q, k, v, causal=causal, window=win)
    assert _err(got, plain) <= FLASH_BF16_TOL
    rep = hq // hkv
    as_j = lambda a: jnp.asarray(a, jnp.bfloat16)
    oracle = jattention_ref(as_j(nq), jnp.repeat(as_j(nk), rep, axis=1),
                            jnp.repeat(as_j(nv), rep, axis=1), causal=causal, window=win)
    assert _err(got, torch.from_numpy(np.array(oracle, np.float32))) <= FLASH_BF16_TOL


@pytest.mark.parametrize("case", REHEARSAL_CASES)
def test_tc_bf16_scores_rehearsal_within_bf16_tolerance(case):
    b, hq, hkv, sq, sk, d, causal, win = case
    (nq, nk, nv), (q, k, v) = _inputs(b, hq, hkv, sq, sk, d)
    got = tc_rehearsal(q, k, v, causal=causal, window=win, score_bf16=True)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    plain = FR.flash_attention_ref(q, k, v, causal=causal, window=win,
                                   score_dtype=torch.bfloat16)
    assert _err(got, plain) <= FLASH_BF16_TOL
    rep = hq // hkv
    as_j = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = blocked_attention(as_j(nq), jnp.repeat(as_j(nk), rep, axis=1),
                             jnp.repeat(as_j(nv), rep, axis=1), causal=causal, window=win,
                             q_chunk=FR.BLOCK_Q, k_chunk=FR.BLOCK_K,
                             score_dtype=jnp.bfloat16)
    assert _err(got, torch.from_numpy(np.array(want, np.float32))) <= FLASH_BF16_TOL


def test_bf16_scores_take_the_tc_kernel_only():
    """f32 operands with bf16 scores raise ``ValueError`` (the SIMT kernel
    keeps f32 scores), as does naming the SIMT kernel; bf16 operands pass
    every check and reach the card's."""
    _, (q, k, v) = _inputs(1, 2, 2, 64, 64, 64)
    for args, kind in (((q.float(), k.float(), v.float()), None), ((q, k, v), "simt")):
        with pytest.raises(ValueError, match="bf16-score variant"):
            FK.flash_attention(*args, variant=kind, score_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        FK.flash_attention(q, k, v, score_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="score_dtype"):
        FK.flash_attention(q, k, v, score_dtype=torch.float16)


def test_variant_follows_the_dtype():
    _, (q, k, v) = _inputs(1, 4, 2, 70, 70, 64)
    assert FK.variant(q, k, v) == "tc"
    assert FK.variant(q.float(), k.float(), v.float()) == "simt"


def test_variant_on_the_serving_path_is_tc(monkeypatch):
    """A full-width qwen3-0.6b prefill (depth 1, the model's [B, S, H, D]
    storage read through transposed views): its attention operands go to
    the tensor-core kernel."""
    from repro_torch.models import lm as tlm

    seen = []

    def wrapper(q, k, v, **kw):
        seen.append(FK.variant(q, k, v))
        return FR.flash_attention_ref(q, k, v, **kw)
    monkeypatch.setattr(FK, "flash_attention", wrapper)
    monkeypatch.setattr(build, "use_kernel", lambda backend, x: backend == "kernel")
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=1)
    model = tlm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (2, 70), generator=torch.Generator().manual_seed(1))
    tlm.prefill(model, prompt, 80)
    assert seen == ["tc"]


def _misaligned():
    """bf16 operands the tensor-core kernel does not take, each with the
    rest of a valid call."""
    _, (q, k, v) = _inputs(1, 2, 2, 64, 64, 64)
    wide = torch.zeros((1, 2, 64, 72), dtype=torch.bfloat16)
    shifted = wide[..., 1:65]                        # address 2 bytes past 16
    rows = torch.zeros((1, 64, 2, 68), dtype=torch.bfloat16)[..., :64].transpose(1, 2)
    _, (q20, k20, v20) = _inputs(1, 2, 2, 64, 64, 20)
    return {"head dim 20": (q20, k20, v20), "q shifted by one element": (shifted, k, v),
            "k head stride 68 elements": (q, rows, v), "v shifted": (q, k, shifted)}


@pytest.mark.parametrize("what", ["head dim 20", "k head stride 68 elements",
                                  "q shifted by one element", "v shifted"])
def test_tc_refuses_misaligned_operands(what):
    q, k, v = _misaligned()[what]
    with pytest.raises(ValueError, match="tensor-core kernel"):
        FK.variant(q, k, v)
    with pytest.raises(ValueError, match="tensor-core kernel"):
        FK.flash_attention(q, k, v)            # refused before the card is asked


def test_explicit_variant_checks_the_operands():
    _, (q, k, v) = _inputs(1, 2, 2, 64, 64, 64)
    qf, kf, vf = q.float(), k.float(), v.float()
    with pytest.raises(ValueError, match="takes bf16"):
        FK.flash_attention(qf, kf, vf, variant="tc")
    with pytest.raises(ValueError, match="expected one of"):
        FK.flash_attention(q, k, v, variant="wgmma")
    for args, kind in (((q, k, v), "simt"), ((q, k, v), None), ((qf, kf, vf), None)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            FK.flash_attention(*args, variant=kind)
