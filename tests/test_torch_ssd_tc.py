"""PyTorch port, ``ssd_chunk_scan`` with B and C in group form and the
tensor-core kernel, on the CPU.

- The group-form port (``ops.ssd_chunk_scan``, ``ops.ssd_with_state``,
  ``ref.ssd_chunk_scan_ref``: B/C ``[B*G, L, N]``, head row ``bh``
  reading group row ``bh // rep``) against the JAX package's Pallas
  kernel (interpret mode) and ``ssd_jnp_with_state`` fed the same inputs
  expanded with ``jnp.repeat``, and against the sequential oracle, for
  ``(G, rep)`` in ``{(1, 1), (1, 4), (2, 3)}``.
- ``tc_rehearsal`` repeats the tensor-core kernel's arithmetic
  (``csrc/ssd_scan_tc.cu``) in plain torch: the cumsum in the warp's
  order (four values a lane, then a shuffle scan), C·Bᵀ from bf16
  products summed in f32, G = C·Bᵀ ∘ exp2(L2_i − L2_j) below the diagonal
  (L2 = L·log2 e rounded to f32),
  and the two f32 products in split TF32 (each operand hi + lo, both
  rounded to 10 mantissa bits by masking, ``lo·hi + hi·lo + hi·hi``; the
  A operands G and B ∘ dec, the B operand x).  It runs the card's bf16 cases at
  CPU-sized head counts, so the error the kernel's rounding costs is
  known before any card run.
- Which kernel takes a call (``variant``), on made-up operands and on a
  full-width mamba2-780m prefill's, and what the wrapper refuses
  (``ValueError``, no fallback to the SIMT kernel).

Tolerance: ``SSD_TOL = 2e-4`` for everything, the tolerance of
``tests/test_kernels.py``'s SSD tests and of ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_chunk_scan as jssd_chunk_scan  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_jnp_with_state  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as SO  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as SR  # noqa: E402

SSD_TOL = 2e-4
LOG2E = 1.4426950408889634


def _inputs(bh, bg, L, P, N, seed=3, decay=0.3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bh, L, P)) * 0.5).astype(np.float32)
    loga = (-np.abs(rng.standard_normal((bh, L))) * decay).astype(np.float32)
    B = (rng.standard_normal((bg, L, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((bg, L, N)) * 0.3).astype(np.float32)
    return x, loga, B, C


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32), np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=SSD_TOL, atol=SSD_TOL)


# ------------------------------------------------- group form vs the JAX package

# (G, rep) over a batch of 2: BH = 2 G rep head rows, BG = 2 G group rows
GROUPS = [(1, 1), (1, 4), (2, 3)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("groups", GROUPS)
def test_group_form_matches_the_jax_package_on_expanded_inputs(groups, dtype):
    G, rep = groups
    bh, bg, L, P, N, chunk = 2 * G * rep, 2 * G, 64, 16, 32, 16
    x, loga, B, C = _inputs(bh, bg, L, P, N)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jB, jC = (jnp.repeat(jnp.asarray(a, jdt), rep, axis=0) for a in (B, C))
    jx, jla = jnp.asarray(x), jnp.asarray(loga)
    tx, tla = torch.from_numpy(x), torch.from_numpy(loga)
    tB, tC = (torch.from_numpy(a).to(tdt) for a in (B, C))
    want = jssd_chunk_scan(jx, jla, jB, jC, chunk=chunk)
    for got in (SO.ssd_chunk_scan(tx, tla, tB, tC, chunk=chunk),
                SR.ssd_chunk_scan_ref(tx, tla, tB, tC, chunk=chunk)):
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            _close(g, w)
    y, state = SO.ssd_with_state(tx, tla, tB, tC, chunk=chunk)
    jy, jstate = ssd_jnp_with_state(jx, jla, jB, jC, chunk=chunk)
    _close(y, jy)
    _close(state, jstate)
    _close(y, jssd_ref(jx, jla, jB, jC))


@pytest.mark.parametrize("groups", GROUPS)
def test_grouped_inter_chunk_equals_the_expanded_one(groups):
    """``_inter_chunk`` reads group-form C through a grouped product; the
    same C expanded to every head gives the same y and state."""
    G, rep = groups
    bh, bg, L, P, N, chunk = 2 * G * rep, 2 * G, 96, 8, 16, 32
    x, loga, B, C = (torch.from_numpy(a) for a in _inputs(bh, bg, L, P, N, seed=4))
    Be, Ce = SR.expand_groups(x, B, C)
    assert Be.shape == (bh, L, N) and torch.equal(Ce[rep * (bg - 1)], C[bg - 1])
    y, state = SO.ssd_with_state(x, loga, B, C, chunk=chunk)
    ye, statee = SO.ssd_with_state(x, loga, Be, Ce, chunk=chunk)
    _close(y, ye)
    _close(state, statee)
    _close(y, SR.ssd_ref(x, loga, Be, Ce))


# ----------------------------------------- the tensor-core kernel's rounding

def _tf32(v):
    """f32 -> tf32 as ``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest,
    ties away from zero (add half the dropped range to the magnitude's
    bits, then clear them)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(v):
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _warp_cumsum(la):
    """Inclusive cumsum over the last dim (a chunk) in the kernel's order:
    lane l sums values E l .. E l + E - 1 in turn (E = ceil(chunk / 32)),
    a Hillis-Steele shuffle scan adds the lanes' totals."""
    chunk = la.shape[-1]
    E = -(-chunk // 32)
    pad = torch.nn.functional.pad(la, (0, 32 * E - chunk)).reshape(*la.shape[:-1], 32, E)
    run = torch.zeros_like(pad)
    tot = torch.zeros_like(pad[..., 0])
    for e in range(E):
        tot = tot + pad[..., e]
        run[..., e] = tot
    incl = tot.clone()
    off = 1
    while off < 32:
        shifted = torch.nn.functional.pad(incl, (off, 0))[..., :32]
        incl = incl + shifted                 # lanes below off add 0.0: exact
        off *= 2
    base = incl - tot
    return (base[..., None] + run).reshape(*la.shape[:-1], 32 * E)[..., :chunk]


def tc_rehearsal(x, loga, B, C, *, chunk):
    """The tensor-core kernel's arithmetic in plain torch; B/C bf16 in
    group form -> y, s, t as ``ssd_chunk_scan_ref``."""
    BH, L, P = x.shape
    rep = SR.group_rep(x, B)
    N = B.shape[-1]
    NC = L // chunk
    xr = x.reshape(BH, NC, chunk, P)
    Lc = _warp_cumsum(loga.reshape(BH, NC, chunk))
    Bg = B.float().reshape(-1, NC, chunk, N)
    Cg = C.float().reshape(-1, NC, chunk, N)
    CB = (Cg @ Bg.transpose(-1, -2)).repeat_interleave(rep, dim=0)   # once a group
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    L2 = Lc * torch.tensor(LOG2E, dtype=torch.float32)      # rounded to f32, then exp2
    G = torch.where(causal, CB * torch.exp2(torch.where(
        causal, L2[..., :, None] - L2[..., None, :], 0.0)), 0.0)
    gh, gl = _split(G)
    xh, xl = _split(xr)
    y = (gl @ xh + gh @ xl) + gh @ xh
    dec = torch.exp(Lc[..., -1:] - Lc)
    bh, bl = _split((Bg.repeat_interleave(rep, dim=0) * dec[..., None]).transpose(-1, -2))
    s = (bl @ xh + bh @ xl) + bh @ xh
    return y.reshape(BH, L, P), s, torch.exp(Lc[..., -1])


def test_tf32_rounding_is_cvt_rna():
    v = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12 - 2 ** -23], dtype=torch.float32)
    want = [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0]
    assert _tf32(v).tolist() == want
    hi, lo = _split(torch.tensor([1 / 3], dtype=torch.float32))
    assert abs(float(hi) + float(lo) - 1 / 3) < 2 ** -21 / 3


def test_warp_cumsum_is_a_cumsum():
    la = torch.from_numpy(_inputs(3, 1, 96, 1, 16)[1]).reshape(3, 2, 48)
    got = _warp_cumsum(la)
    assert got.shape == la.shape
    torch.testing.assert_close(got, torch.cumsum(la, dim=-1), rtol=1e-6, atol=1e-6)


# the card's bf16 cases (chip_smoke.py SSD_CASES) at CPU-sized head counts:
# (BH, BG, L, P, N, chunk, decay of loga)
REHEARSAL_CASES = [
    (8, 1, 512, 64, 128, 128, 0.3),     # mamba2-780m prefill, 8 of its 48 heads
    (6, 2, 384, 64, 128, 128, 0.3),     # B=2, S=300 padded to 384
    (12, 4, 256, 64, 128, 128, 0.3),    # (G, rep) = (2, 3)
    (8, 2, 192, 32, 64, 64, 0.3),       # chunk 64
    (4, 4, 256, 64, 128, 128, 0.3),     # one row a head
    (4, 1, 256, 64, 128, 128, 3.0),     # strong decays: L reaches ~ -300 a chunk
]


@pytest.mark.parametrize("case", REHEARSAL_CASES)
def test_tc_rounding_rehearsal_within_ssd_tolerance(case):
    bh, bg, L, P, N, chunk, decay = case
    x, loga, B, C = _inputs(bh, bg, L, P, N, seed=L + N, decay=decay)
    tx, tla = torch.from_numpy(x), torch.from_numpy(loga)
    tB, tC = (torch.from_numpy(a).to(torch.bfloat16) for a in (B, C))
    assert SK.variant(tx, tla, tB, tC, chunk=chunk) == "tc"
    got = tc_rehearsal(tx, tla, tB, tC, chunk=chunk)
    plain = SR.ssd_chunk_scan_ref(tx, tla, tB, tC, chunk=chunk)
    rep = bh // bg
    jB, jC = (jnp.repeat(jnp.asarray(a, jnp.bfloat16), rep, axis=0) for a in (B, C))
    oracle = jssd_chunk_scan(jnp.asarray(x), jnp.asarray(loga), jB, jC, chunk=chunk)
    for g, p, o in zip(got, plain, oracle):
        assert g.shape == p.shape and bool(torch.isfinite(g).all())
        _close(g, p)
        _close(g, o)


# ------------------------------------------------- which kernel, what is refused

def test_variant_follows_the_dtype():
    x, loga, B, C = (torch.from_numpy(a) for a in _inputs(8, 2, 128, 64, 128))
    assert SK.variant(x, loga, B.bfloat16(), C.bfloat16(), chunk=128) == "tc"
    assert SK.variant(x, loga, B, C, chunk=128) == "simt"


@pytest.mark.parametrize("S, padded", [(130, 256), (70, 80)])
def test_variant_on_the_serving_path_is_tc(monkeypatch, S, padded):
    """A full-width mamba2-780m prefill (depth 1; a 130-token prompt: one
    128-row chunk and a padded one; a 70-token prompt: one chunk padded to
    80 rows): its SSD operands come in group form ([B*G, S, N], G = 1) and
    go to the tensor-core kernel."""
    from repro_torch.models import lm as tlm

    seen = []

    def wrapper(x, loga, B, C, *, chunk):
        seen.append((SK.variant(x, loga, B, C, chunk=chunk), tuple(B.shape),
                     tuple(C.shape), x.shape[0]))
        return SR.ssd_chunk_scan_ref(x, loga, B, C, chunk=chunk)
    monkeypatch.setattr(SK, "ssd_chunk_scan", wrapper)
    monkeypatch.setattr(build, "use_kernel", lambda backend, x: backend == "kernel")
    cfg = dataclasses.replace(get_config("mamba2-780m"), n_layers=1)
    model = tlm.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (2, S), generator=torch.Generator().manual_seed(1))
    tlm.prefill(model, prompt, S + 10)
    s = cfg.ssm
    groups = (2 * s.n_groups, padded, s.d_state)
    assert seen == [("tc", groups, groups, 2 * s.n_heads(cfg.d_model))]


def _refused():
    """bf16 operands the tensor-core kernel does not take, each with the
    rest of a valid call (B/C [2, 128, 64], x [4, 128, 32], chunk 64)."""
    x, loga, B, C = (torch.from_numpy(a) for a in _inputs(4, 2, 128, 32, 64))
    B, C = B.bfloat16(), C.bfloat16()
    shifted = torch.zeros(B.numel() + 8, dtype=torch.bfloat16)[1:B.numel() + 1].view(B.shape)
    xs = torch.zeros(x.numel() + 4)[1:x.numel() + 1].view(x.shape)
    n24 = torch.zeros((2, 128, 24), dtype=torch.bfloat16)
    return {"N not a multiple of 16": ((x, loga, n24, n24), 64),
            "chunk not a multiple of 16": ((x, loga, B, C), 8),
            "B shifted by one element": ((x, loga, shifted, C), 64),
            "C shifted by one element": ((x, loga, B, shifted), 64),
            "x shifted by one element": ((xs, loga, B, C), 64),
            "P not a multiple of 8": ((x[..., :20].contiguous(), loga, B, C), 64),
            "tiles beyond shared memory": ((torch.zeros((4, 128, 128)), loga,
                                            torch.zeros((2, 128, 256), dtype=torch.bfloat16),
                                            torch.zeros((2, 128, 256), dtype=torch.bfloat16)),
                                           128)}


@pytest.mark.parametrize("what", ["N not a multiple of 16", "chunk not a multiple of 16",
                                  "B shifted by one element", "C shifted by one element",
                                  "x shifted by one element", "P not a multiple of 8",
                                  "tiles beyond shared memory"])
def test_tc_refuses_operands_it_does_not_take(what):
    args, chunk = _refused()[what]
    with pytest.raises(ValueError, match="tensor-core kernel"):
        SK.variant(*args, chunk=chunk)
    with pytest.raises(ValueError, match="tensor-core kernel"):
        SK.ssd_chunk_scan(*args, chunk=chunk)        # refused before the card is asked


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groups_that_do_not_divide_the_heads_are_refused(dtype):
    x, loga, B, C = (torch.from_numpy(a) for a in _inputs(6, 4, 64, 16, 32))
    B, C = B.to(dtype), C.to(dtype)
    for call in (lambda: SK.ssd_chunk_scan(x, loga, B, C, chunk=16),
                 lambda: SO.ssd_chunk_scan(x, loga, B, C, chunk=16),
                 lambda: SR.ssd_chunk_scan_ref(x, loga, B, C, chunk=16)):
        with pytest.raises(ValueError, match="does not divide"):
            call()


def test_explicit_variant_checks_the_operands():
    x, loga, B, C = (torch.from_numpy(a) for a in _inputs(4, 2, 128, 32, 64))
    with pytest.raises(ValueError, match="takes bf16"):
        SK.ssd_chunk_scan(x, loga, B, C, chunk=64, variant="tc")
    with pytest.raises(ValueError, match="expected one of"):
        SK.ssd_chunk_scan(x, loga, B.bfloat16(), C.bfloat16(), chunk=64, variant="wgmma")
    for args, kind in (((x, loga, B.bfloat16(), C.bfloat16()), "simt"),
                       ((x, loga, B.bfloat16(), C.bfloat16()), None),
                       ((x, loga, B, C), None)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            SK.ssd_chunk_scan(*args, chunk=64, variant=kind)


def test_the_model_shapes_fit_one_block_an_sm():
    """mamba2-780m's chunk (128 rows, N=128, P=64) fits the tensor-core
    kernel's shared memory, one block an SM."""
    need = SK.smem_bytes_tc(128, 128, 64)
    assert need <= SK.SMEM_MAX and SK.SMEM_SM // (need + SK.SMEM_RESERVED) == 1


def test_heads_a_block_fills_the_card_in_the_fewest_head_passes():
    """The tile rule: the fewest heads on the busiest SM (waves × heads a
    block), the larger ``ht`` on a tie."""
    assert SK.heads_a_block(4, 4, 48, 132) == 6        # 128 blocks, one wave
    assert SK.heads_a_block(2, 3, 48, 132) == 3        # 96 blocks
    assert SK.heads_a_block(4, 2, 3, 132) == 1         # 24 blocks
    assert SK.heads_a_block(3, 5, 7, 20) == 2          # 60 blocks, 3 waves: 6 heads
    assert SK.heads_a_block(1, 1, 48, 1) == 48
