"""PyTorch port on a CUDA card, serving slice: the ``flash_attention`` and
``ssd_chunk_scan`` kernels against their plain PyTorch versions at the
model shapes (qwen3-0.6b and mamba2-780m prefill, MLA's value head dim
of its own, cross-attention's non-causal Sk > Sq) and at ragged ones
(Sq != Sk, S=300, chunk < 128, a sliding window, strided views), and
reduced models of all ten architectures served through the kernels
against the same models served through the plain versions on the card.

Tolerances: f32 attention 2e-5 and SSD 2e-4 (the order of the sums
differs only; the SSD tensor-core kernel's split TF32 keeps ~21 bits of
each product); bf16 attention 2e-2 (one bf16 rounding of the output, and
of P before P·V in the tensor-core kernel).

Every test is marked ``gpu`` and skips without a card; whether there is
one is decided inside the fixture.  This file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_serve.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attn import ref as FR  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as SR  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

pytestmark = pytest.mark.gpu

FLASH_F32_TOL = 2e-5
FLASH_BF16_TOL = 2e-2
SSD_TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


# (b, hq, hkv, sq, sk, d, causal, window, dtype); bf16 goes to the
# tensor-core kernel, f32 to the SIMT kernel, so each masking and ragged
# case runs in both
FLASH_CASES = [
    (4, 16, 8, 512, 512, 128, True, 0, torch.bfloat16),     # qwen3-0.6b prefill
    (2, 16, 8, 300, 300, 128, True, 0, torch.bfloat16),     # ragged prompt
    (4, 16, 8, 512, 512, 128, True, 0, torch.float32),
    (1, 2, 2, 128, 128, 64, True, 64, torch.float32),
    (1, 2, 1, 100, 300, 16, True, 0, torch.float32),
    (1, 2, 2, 130, 70, 32, True, 0, torch.float32),
    (2, 4, 2, 1, 77, 16, True, 0, torch.float32),
    (1, 2, 1, 300, 300, 64, True, 50, torch.float32),
    (1, 2, 2, 70, 130, 16, False, 0, torch.float32),
    (1, 2, 2, 90, 200, 48, False, 40, torch.float32),
    (1, 2, 2, 128, 128, 64, True, 64, torch.bfloat16),
    (1, 2, 1, 100, 300, 16, True, 0, torch.bfloat16),       # Sq != Sk
    (1, 2, 1, 100, 300, 64, True, 0, torch.bfloat16),
    (1, 2, 2, 130, 70, 32, True, 0, torch.bfloat16),        # rows with no key
    (2, 4, 2, 1, 77, 16, True, 0, torch.bfloat16),          # one query row
    (1, 2, 1, 300, 300, 64, True, 50, torch.bfloat16),      # sliding window
    (1, 2, 2, 70, 130, 16, False, 0, torch.bfloat16),
    (1, 2, 2, 90, 200, 48, False, 40, torch.bfloat16),
    (2, 4, 2, 200, 200, 96, True, 0, torch.bfloat16),       # D = 96, padded to 128
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case):
    b, hq, hkv, sq, sk, d, causal, win, dt = case
    g = torch.Generator(device=cuda).manual_seed(sq * 7 + sk)
    # the model's layout: [B, S, H, D] storage read through transposed views
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(dt).transpose(1, 2)
    k = torch.randn((b, sk, hkv, d), generator=g, device=cuda).to(dt).transpose(1, 2)
    v = torch.randn((b, sk, hkv, d), generator=g, device=cuda).to(dt).transpose(1, 2)
    fa = FK.flash_attention
    n0 = (fa.launches, fa.launches_tc, fa.launches_simt)
    out = FK.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    tc = dt == torch.bfloat16
    assert FK.variant(q, k, v) == ("tc" if tc else "simt")
    assert (fa.launches, fa.launches_tc, fa.launches_simt) == \
        (n0[0] + 1, n0[1] + tc, n0[2] + (not tc))
    ref = FR.flash_attention_ref(q, k, v, causal=causal, window=win)
    assert out.dtype == dt and out.shape == ref.shape
    tol = FLASH_F32_TOL if dt == torch.float32 else FLASH_BF16_TOL
    assert _err(out, ref) <= tol
    if dt == torch.float32:
        assert _err(out, FR.attention_ref(q, k, v, causal=causal, window=win)) <= tol


# (b, hq, hkv, sq, sk, d, dv, causal, dtype): v with a head dim of its own,
# read as MLA's prefill hands it over (the last dv columns of a wider
# row); cross-attention's non-causal Sk > Sq
DV_CASES = [
    (4, 40, 40, 512, 512, 96, 64, True, torch.bfloat16),     # minicpm3-4b prefill
    (2, 5, 5, 37, 37, 24, 16, True, torch.bfloat16),         # reduced minicpm3-4b
    (4, 64, 8, 512, 4096, 128, 128, False, torch.bfloat16),  # llama-3.2-vision-90b cross
    (1, 4, 2, 70, 130, 64, 32, False, torch.bfloat16),
    (2, 5, 5, 37, 37, 24, 16, True, torch.float32),
    (1, 2, 1, 100, 300, 48, 24, True, torch.float32),
    (2, 4, 2, 90, 333, 32, 8, False, torch.float32),
]


@pytest.mark.parametrize("case", DV_CASES)
def test_flash_attention_value_head_dim_and_cross(cuda, case):
    b, hq, hkv, sq, sk, d, dv, causal, dt = case
    g = torch.Generator(device=cuda).manual_seed(sq + sk + dv)
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(dt).transpose(1, 2)
    k = torch.randn((b, sk, hkv, d), generator=g, device=cuda).to(dt).transpose(1, 2)
    kv = torch.randn((b, sk, hkv, 64 + dv), generator=g, device=cuda).to(dt)
    v = kv[..., 64:].transpose(1, 2)
    out = FK.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = FR.flash_attention_ref(q, k, v, causal=causal)
    assert out.shape == (b, hq, sq, dv) and out.dtype == dt
    tol = FLASH_F32_TOL if dt == torch.float32 else FLASH_BF16_TOL
    assert _err(out, ref) <= tol
    if dt == torch.float32:
        assert _err(out, FR.attention_ref(q, k, v, causal=causal)) <= tol


def test_flash_attention_tc_refuses_a_value_head_dim_off_8(cuda):
    """A bf16 value head dim that is not a multiple of 8 raises ValueError
    and launches nothing; the kernel path takes bf16 scores through the
    tensor-core kernel's bf16-score variant, held to the plain version's
    bf16 scores (one launch, counted), and refuses them on f32 operands."""
    from repro_torch.kernels.flash_attn import ops as FO
    q = torch.zeros((1, 2, 64, 96), dtype=torch.bfloat16, device=cuda)
    v = torch.zeros((1, 2, 64, 60), dtype=torch.bfloat16, device=cuda)
    n0 = FK.flash_attention.launches
    with pytest.raises(ValueError, match="value head dim 60"):
        FK.flash_attention(q, q, v)
    with pytest.raises(ValueError, match="bf16-score variant"):
        FO.flash_attention(q.float(), q.float(), q.float(), score_dtype=torch.bfloat16)
    assert FK.flash_attention.launches == n0
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((2, 300, h, 128), generator=g, device=cuda)
               .to(torch.bfloat16).transpose(1, 2) for h in (8, 4, 4))
    b0 = FK.flash_attention.launches_bf16s
    out = FO.flash_attention(q, k, v, causal=True, score_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert FK.flash_attention.launches_bf16s == b0 + 1
    ref = FR.flash_attention_ref(q, k, v, causal=True, score_dtype=torch.bfloat16)
    assert _err(out, ref) <= FLASH_BF16_TOL
    assert not torch.equal(out, FK.flash_attention(q, k, v, causal=True))


def test_flash_attention_simt_variant_on_bf16(cuda):
    """The SIMT kernel still takes bf16 when asked by name (the card's
    timing of the earlier design), within the same tolerance."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, 200, h, 128), generator=g, device=cuda)
               .to(torch.bfloat16).transpose(1, 2) for h in (8, 4, 4))
    n0 = FK.flash_attention.launches_simt
    out = FK.flash_attention(q, k, v, causal=True, variant="simt")
    torch.cuda.synchronize()
    assert FK.flash_attention.launches_simt == n0 + 1
    assert _err(out, FR.flash_attention_ref(q, k, v, causal=True)) <= FLASH_BF16_TOL


def test_flash_attention_tc_refuses_misaligned_views(cuda):
    """bf16 operands the tensor-core kernel does not take raise ValueError
    and launch nothing: no fallback to the SIMT kernel."""
    x = torch.zeros((1, 64, 2, 72), dtype=torch.bfloat16, device=cuda).transpose(1, 2)
    n0 = FK.flash_attention.launches
    for q, k in ((x[..., 1:65], x[..., :64]), (x[..., :20], x[..., :20])):
        with pytest.raises(ValueError, match="tensor-core kernel"):
            FK.flash_attention(q, k, k)
    assert FK.flash_attention.launches == n0


# (BH, BG, L, P, N, chunk, B/C dtype): B/C [BG, L, N], head row bh reads
# group row bh // (BH // BG); bf16 goes to the tensor-core kernel, f32 to
# the SIMT kernel
SSD_CASES = [
    (192, 192, 512, 64, 128, 128, torch.bfloat16),   # mamba2-780m prefill, one row a head
    (96, 96, 384, 64, 128, 128, torch.bfloat16),     # B=2, S=300 padded to 3 chunks
    (2, 2, 64, 16, 32, 16, torch.float32),
    (1, 1, 128, 64, 128, 32, torch.float32),
    (3, 3, 96, 8, 16, 48, torch.float32),
    (4, 4, 100, 64, 128, 100, torch.float32),
    # bf16 group-form twins (the model's operands: B=4 and B=2, G=1)
    (192, 4, 512, 64, 128, 128, torch.bfloat16),
    (96, 2, 384, 64, 128, 128, torch.bfloat16),
    (2, 1, 64, 16, 32, 16, torch.bfloat16),
    (4, 1, 128, 64, 128, 32, torch.bfloat16),
    (3, 1, 96, 8, 16, 48, torch.bfloat16),
    (12, 4, 256, 64, 128, 128, torch.bfloat16),      # (G, rep) = (2, 3)
    (8, 2, 192, 32, 64, 64, torch.bfloat16),         # chunk 64
    (12, 4, 96, 16, 32, 48, torch.float32),          # group form on the SIMT kernel
]


def _ssd_inputs(device, bh, bg, L, P, N, dt):
    g = torch.Generator(device=device).manual_seed(L + N)
    x = torch.randn((bh, L, P), generator=g, device=device) * 0.5
    loga = -torch.randn((bh, L), generator=g, device=device).abs() * 0.3
    B = (torch.randn((bg, L, N), generator=g, device=device) * 0.3).to(dt)
    C = (torch.randn((bg, L, N), generator=g, device=device) * 0.3).to(dt)
    return x, loga, B, C


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunk_scan_kernel_matches_plain(cuda, case):
    bh, bg, L, P, N, chunk, dt = case
    x, loga, B, C = _ssd_inputs(cuda, bh, bg, L, P, N, dt)
    fn = SK.ssd_chunk_scan
    n0 = (fn.launches, fn.launches_tc, fn.launches_simt)
    got = fn(x, loga, B, C, chunk=chunk)
    torch.cuda.synchronize()
    tc = dt == torch.bfloat16
    assert SK.variant(x, loga, B, C, chunk=chunk) == ("tc" if tc else "simt")
    assert (fn.launches, fn.launches_tc, fn.launches_simt) == \
        (n0[0] + 1, n0[1] + tc, n0[2] + (not tc))
    for a, b in zip(got, SR.ssd_chunk_scan_ref(x, loga, B, C, chunk=chunk)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _err(a, b) <= SSD_TOL


def test_ssd_chunk_scan_simt_variant_on_bf16(cuda):
    """variant="simt" runs the SIMT kernel on the model's bf16 group-form
    operands (the card's checks time it beside the tensor-core kernel)."""
    x, loga, B, C = _ssd_inputs(cuda, 96, 2, 384, 64, 128, torch.bfloat16)
    fn = SK.ssd_chunk_scan
    n0 = fn.launches_simt
    got = fn(x, loga, B, C, chunk=128, variant="simt")
    torch.cuda.synchronize()
    assert fn.launches_simt == n0 + 1
    for a, b in zip(got, SR.ssd_chunk_scan_ref(x, loga, B, C, chunk=128)):
        assert _err(a, b) <= SSD_TOL


def test_ssd_chunk_scan_tc_refuses_what_it_does_not_take(cuda):
    """bf16 operands the tensor-core kernel does not take raise ValueError
    and launch nothing (no fallback to the SIMT kernel)."""
    x, loga, B, C = _ssd_inputs(cuda, 4, 4, 100, 64, 128, torch.bfloat16)
    shifted = torch.empty(B.numel() + 8, dtype=B.dtype, device=cuda)[1:B.numel() + 1]
    shifted = shifted.view(B.shape)
    x2, loga2, B2, C2 = _ssd_inputs(cuda, 4, 2, 128, 64, 24, torch.bfloat16)
    n0 = SK.ssd_chunk_scan.launches
    for args, chunk in (((x, loga, B, C), 100),             # chunk not a multiple of 16
                        ((x, loga, shifted, C), 100),       # B rows not 16-byte aligned
                        ((x2, loga2, B2, C2), 64)):         # N = 24
        with pytest.raises(ValueError, match="tensor-core kernel"):
            SK.ssd_chunk_scan(*args, chunk=chunk)
    x3, loga3, B3, C3 = _ssd_inputs(cuda, 6, 4, 64, 16, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="does not divide"):
        SK.ssd_chunk_scan(x3, loga3, B3, C3, chunk=16)
    assert SK.ssd_chunk_scan.launches == n0


def test_wrappers_refuse_bad_operands(cuda):
    q = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        FK.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    with pytest.raises(TypeError, match="dtype"):
        FK.flash_attention(q, q.half(), q)
    x = torch.zeros((2, 64, 16), device=cuda)
    la = torch.zeros((2, 64), device=cuda)
    b = torch.zeros((2, 64, 8), device=cuda)
    with pytest.raises(ValueError, match="chunk"):
        SK.ssd_chunk_scan(x, la, b, b, chunk=48)
    with pytest.raises(ValueError, match="on cpu"):
        SK.ssd_chunk_scan(x, la.cpu(), b, b, chunk=16)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m"])
def test_reduced_model_serves_through_the_kernels(cuda, arch):
    """generate through the kernels: one kernel launch per layer in the
    prefill, none in decode; prefill logits within 2e-2 (relative to the
    largest) of the plain versions' on the card."""
    cfg = get_config(arch, reduced=True)
    model = lm.LM(cfg, generator=torch.Generator(device=cuda).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (2, 37), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    fn = FK.flash_attention if arch.startswith("qwen3") else SK.ssd_chunk_scan
    other = SK.ssd_chunk_scan if fn is FK.flash_attention else FK.flash_attention
    FK.reset_launches()
    SK.reset_launches()
    toks = engine.generate(model, prompt, max_new=5, max_len=43)
    torch.cuda.synchronize()
    assert (fn.launches, other.launches) == (cfg.n_layers, 0)
    # bf16: every launch on the tensor cores
    assert (fn.launches_tc, fn.launches_simt) == (cfg.n_layers, 0)
    assert toks.shape == (2, 5) and toks.device.type == "cuda"
    got, _, _ = lm.prefill(model, prompt, 43)
    model.backend = "plain"
    want, _, _ = lm.prefill(model, prompt, 43)
    assert fn.launches == 2 * cfg.n_layers      # generate, then one prefill
    err = _err(got.float(), want.float()) / float(want.float().abs().max())
    assert err <= 2e-2


ZOO = ("qwen2-0.5b", "phi3-mini-3.8b", "minicpm3-4b", "musicgen-large",
       "llama-3.2-vision-90b", "dbrx-132b", "mixtral-8x22b", "jamba-1.5-large-398b")


@pytest.mark.parametrize("arch", ZOO)
def test_reduced_zoo_prefill_through_the_kernels(cuda, arch, monkeypatch):
    """A reduced model of each new architecture: one prefill through the
    kernels (flash_attention once an attention, cross or MLA layer,
    ssd_chunk_scan once a Mamba-2 layer, all on the tensor cores) against
    the plain versions on the card, the last position's logits within
    2e-2 (relative to the largest) in every row whose MoE tokens both
    paths routed to the same experts; no launch in a decode step."""
    from repro_torch.models import moe
    from repro_torch.models.config import MIXER_CROSS, MIXER_MAMBA
    cfg = get_config(arch, reduced=True)
    model = lm.LM(cfg, generator=torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    b, s = 4, 37
    batch = ({"tokens": torch.randint(0, cfg.vocab, (b, s), device=cuda, generator=g)}
             if cfg.frontend == "tokens" else
             {"embeds": torch.randn((b, s, cfg.d_model), device=cuda, generator=g)})
    if any(sp.mixer == MIXER_CROSS for sp in cfg.pattern):
        batch["cross"] = torch.randn((b, cfg.cross_kv_len, cfg.d_model), device=cuda,
                                     generator=g).to(torch.bfloat16)
    routes = []
    orig = moe.route
    monkeypatch.setattr(moe, "route", lambda *a: routes.append(orig(*a)) or routes[-1])
    FK.reset_launches()
    SK.reset_launches()
    got, caches, cl = lm.prefill(model, batch, s + 4)
    torch.cuda.synchronize()
    mixers = [cfg.pattern[i % len(cfg.pattern)].mixer for i in range(cfg.n_layers)]
    n_ssd = sum(m == MIXER_MAMBA for m in mixers)
    assert (FK.flash_attention.launches, FK.flash_attention.launches_tc) == \
        (cfg.n_layers - n_ssd,) * 2
    assert (SK.ssd_chunk_scan.launches, SK.ssd_chunk_scan.launches_tc) == (n_ssd,) * 2
    model.backend = "plain"
    want, _, _ = lm.prefill(model, batch, s + 4)
    rows = torch.ones(b, dtype=torch.bool, device=cuda)
    half = len(routes) // 2
    for (_, _, ik), (_, _, ip) in zip(routes[:half], routes[half:]):
        rows &= ~(ik.sort(-1).values != ip.sort(-1).values).any(-1).any(-1)
    assert bool(rows.any())
    err = _err(got[rows].float(), want[rows].float()) / float(want.float().abs().max())
    assert err <= 2e-2
    model.backend = "kernel"
    FK.reset_launches()
    SK.reset_launches()
    nxt = ({"tokens": batch["tokens"][:, :1]} if "tokens" in batch
           else {"embeds": batch["embeds"][:, :1]})
    lm.decode_step(model, nxt, caches, cl + 1)
    torch.cuda.synchronize()
    assert FK.flash_attention.launches == SK.ssd_chunk_scan.launches == 0
