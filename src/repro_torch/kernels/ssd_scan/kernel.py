"""ctypes wrapper of the CUDA ``ssd_chunk_scan`` kernels.

The dtype of B and C decides which kernel takes a call (:func:`variant`),
one rule with no fallback: bf16 goes to the tensor-core kernel
(``csrc/ssd_scan_tc.cu``), which takes N and chunk that are multiples of
16, P a multiple of 8 and 16-byte aligned operands; bf16 operands it does
not take raise ``ValueError``.  f32 goes to the SIMT kernel
(``csrc/ssd_scan.cu``).

B and C come ``[BH, L, N]`` (one row a head, the JAX signature) or in
group form ``[BG, L, N]`` with ``BH % BG == 0``: head row ``bh`` reads
group row ``bh // (BH // BG)``.

The wrapper checks every operand (device, dtype, shape, contiguity),
checks that the chunk's tiles fit in shared memory, allocates the three
f32 outputs, launches on PyTorch's current stream, raises if the launch
failed, and counts its launches in ``ssd_chunk_scan.launches``, and by
kernel in ``launches_tc`` and ``launches_simt``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import group_rep

BC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK_MAX = 128
ROW_BLOCK = 64                      # rows of the gated score matrix at a time (SIMT)
SMEM_MAX = 232_448                  # bytes of shared memory a block may use
SMEM_SM = 233_472                   # bytes of shared memory an SM has for blocks
SMEM_RESERVED = 1_024               # bytes the card reserves for each block
TC_MULT = 16                        # N and chunk: whole mma k-steps and 16-row tiles
TC_P_MULT = 8                       # P: whole 8-column n-tiles
VARIANTS = ("tc", "simt")
_LAUNCHERS = {"tc": "repro_ssd_chunk_scan_tc", "simt": "repro_ssd_chunk_scan"}


def smem_bytes(chunk: int, n: int, p: int) -> int:
    """Shared memory of one SIMT block (``smem_bytes`` in ssd_scan.cu)."""
    return 4 * (2 * chunk + 2 * chunk * (n + 1) + chunk * p
                + ROW_BLOCK * (chunk + 1))


def smem_bytes_tc(chunk: int, n: int, p: int) -> int:
    """Shared memory of one tensor-core block (``smem_bytes`` in
    ssd_scan_tc.cu): B bf16 rows padded by 8, C·Bᵀ f32 rows padded by 8,
    raw x rows padded by 4, x split in hi/lo (sharing its space with C),
    loga, L and dec of two heads, and a counter."""
    return (chunk * (n + 8) * 2 + chunk * (chunk + 8) * 4 + chunk * (p + 4) * 4
            + max(chunk * p * 8, chunk * (n + 8) * 2) + 5 * chunk * 4 + 16)


@functools.cache
def heads_a_block(bg: int, nc: int, rep: int, slots: int) -> int:
    """Heads of one group a tensor-core block takes (``ht``).

    Each block computes its (group, chunk)'s C·Bᵀ once and then runs its
    heads one after another; ``slots`` blocks run at once (SMs × blocks an
    SM), so the card's time goes with the heads the busiest SM runs:
    ``ceil(blocks / slots) · ht``.  The rule takes the ``ht`` that makes it
    least, the larger on a tie (fewer blocks recompute C·Bᵀ).  Timed shape
    (BG=4, NC=4, 48 heads, 132 slots): 6 heads, 128 blocks in one wave;
    B=2 × 384 (BG=2, NC=3): 3 heads, 96 blocks (2 heads would need 144
    blocks, two waves)."""
    def cost(ht):
        return -(-bg * nc * -(-rep // ht) // slots) * ht
    return min(range(1, rep + 1), key=lambda ht: (cost(ht), -ht))


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fn(kind: str):
    fn = getattr(build.library(), _LAUNCHERS[kind])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_tc(x, loga, B, C, chunk: int) -> None:
    """Raise ``ValueError`` unless the tensor-core kernel takes the
    operands: bf16 B/C, N and chunk multiples of 16, P a multiple of 8,
    every operand's address 16-byte aligned (with the shapes above, so is
    every row of a chunk), and the tiles within shared memory."""
    if B.dtype != torch.bfloat16 or C.dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core kernel takes bf16 B and C, got {B.dtype}, "
                         f"{C.dtype}")
    P, N = x.shape[-1], B.shape[-1]
    if N % TC_MULT or chunk % TC_MULT:
        raise ValueError(f"N={N}, chunk={chunk}: the tensor-core kernel takes "
                         f"multiples of {TC_MULT}")
    if P % TC_P_MULT:
        raise ValueError(f"P={P}: the tensor-core kernel takes a multiple of "
                         f"{TC_P_MULT}")
    for name, t in (("x", x), ("loga", loga), ("B", B), ("C", C)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: rows not 16-byte aligned for the tensor-core "
                             f"kernel (address {t.data_ptr()} mod 16 = "
                             f"{t.data_ptr() % 16})")
    if smem_bytes_tc(chunk, N, P) > SMEM_MAX:
        raise ValueError(f"chunk={chunk}, N={N}, P={P} need {smem_bytes_tc(chunk, N, P)} "
                         f"B of shared memory in the tensor-core kernel (> {SMEM_MAX})")


def variant(x, loga, B, C, *, chunk: int) -> str:
    """The kernel that takes ``ssd_chunk_scan(x, loga, B, C)``: ``"simt"``
    for f32 B/C, ``"tc"`` for bf16 (after :func:`_check_tc`, which raises
    ``ValueError`` if the tensor-core kernel does not take the operands)."""
    if B.dtype == torch.bfloat16:
        _check_tc(x, loga, B, C, chunk)
        return "tc"
    return "simt"


_by_dtype = variant     # ssd_chunk_scan's keyword of the same name shadows it


def ssd_chunk_scan(x, loga, B, C, *, chunk: int, variant: str | None = None):
    """Launch a kernel on CUDA tensors: x ``[BH, L, P]`` f32, loga
    ``[BH, L]`` f32, B/C ``[BG, L, N]`` (f32 or bf16, ``BH % BG == 0``),
    ``L % chunk == 0``, ``chunk <= 128`` -> y ``[BH, L, P]``,
    s ``[BH, L/chunk, N, P]``, t ``[BH, L/chunk]``, all f32.

    ``variant`` (``"tc"`` or ``"simt"``) names the kernel; left ``None``,
    the dtype decides (:func:`variant`).  Only the card's checks name it,
    to time the SIMT kernel on bf16 beside the tensor-core one."""
    dev = x.device
    if x.dim() != 3 or B.dim() != 3:
        raise ValueError(f"x, B: expected [BH, L, *], got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    bh, L, P = x.shape
    bg, N = B.shape[0], B.shape[-1]
    group_rep(x, B)
    if not 1 <= chunk <= CHUNK_MAX or L % chunk:
        raise ValueError(f"chunk={chunk} must be in 1..{CHUNK_MAX} and divide L={L}")
    if B.dtype not in BC_DTYPES:
        raise TypeError(f"B: dtype {B.dtype}, expected one of {list(BC_DTYPES)}")
    f32 = torch.float32
    ptrs = [build.require(x, "x", f32, (bh, L, P), dev),
            build.require(loga, "loga", f32, (bh, L), dev),
            build.require(B, "B", B.dtype, (bg, L, N), dev),
            build.require(C, "C", B.dtype, (bg, L, N), dev)]
    if variant not in (None, *VARIANTS):
        raise ValueError(f"variant {variant!r}: expected one of {VARIANTS} or None")
    if variant == "tc":
        _check_tc(x, loga, B, C, chunk)
    kind = variant or _by_dtype(x, loga, B, C, chunk=chunk)
    if kind == "simt" and smem_bytes(chunk, N, P) > SMEM_MAX:
        raise ValueError(f"chunk={chunk}, N={N}, P={P} need "
                         f"{smem_bytes(chunk, N, P)} B of shared memory (> {SMEM_MAX})")
    build.on_card(dev, "ssd_chunk_scan")
    nc = L // chunk
    y = torch.empty((bh, L, P), dtype=f32, device=dev)
    s = torch.empty((bh, nc, N, P), dtype=f32, device=dev)
    t = torch.empty((bh, nc), dtype=f32, device=dev)
    outs = [ctypes.c_void_p(o.data_ptr()) for o in (y, s, t)]
    if kind == "tc":            # the launchers' last int: heads a block (tc), dtype (simt)
        per_sm = SMEM_SM // (smem_bytes_tc(chunk, N, P) + SMEM_RESERVED)
        last = heads_a_block(bg, nc, bh // bg, _sm_count(dev) * max(1, per_sm))
    else:
        last = BC_DTYPES[B.dtype]
    build.check(_fn(kind)(*ptrs, *outs, bh, bg, L, P, N, chunk, last, build.stream(dev)),
                f"ssd_chunk_scan ({kind})")
    ssd_chunk_scan.launches += 1
    setattr(ssd_chunk_scan, f"launches_{kind}",
            getattr(ssd_chunk_scan, f"launches_{kind}") + 1)
    return y, s, t


def reset_launches() -> None:
    """Set the total and both per-kernel counts to 0."""
    ssd_chunk_scan.launches = ssd_chunk_scan.launches_tc = \
        ssd_chunk_scan.launches_simt = 0


reset_launches()
