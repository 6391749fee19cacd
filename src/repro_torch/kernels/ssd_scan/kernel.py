"""ctypes wrapper of the CUDA ``ssd_chunk_scan`` kernel (``csrc/ssd_scan.cu``).

The wrapper checks every operand (device, dtype, shape, contiguity; B and
C may be bf16, as the model hands them, or f32), checks that the chunk's
tiles fit in shared memory, allocates the three f32 outputs, launches on
PyTorch's current stream, raises if the launch failed, and counts its
launches in ``ssd_chunk_scan.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

BC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK_MAX = 128
ROW_BLOCK = 64                      # rows of the gated score matrix at a time
SMEM_MAX = 232_448                  # bytes of shared memory a block may use


def smem_bytes(chunk: int, n: int, p: int) -> int:
    """Shared memory of one block (must match ``smem_bytes`` in the source)."""
    return 4 * (2 * chunk + 2 * chunk * (n + 1) + chunk * p
                + ROW_BLOCK * (chunk + 1))


def _fn():
    fn = build.library().repro_ssd_chunk_scan
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_chunk_scan(x, loga, B, C, *, chunk: int):
    """Launch the kernel on CUDA tensors: x ``[BH, L, P]`` f32, loga
    ``[BH, L]`` f32, B/C ``[BH, L, N]`` (f32 or bf16), ``L % chunk == 0``,
    ``chunk <= 128`` -> y ``[BH, L, P]``, s ``[BH, L/chunk, N, P]``,
    t ``[BH, L/chunk]``, all f32."""
    dev = x.device
    if x.dim() != 3 or B.dim() != 3:
        raise ValueError(f"x, B: expected [BH, L, *], got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    bh, L, P = x.shape
    N = B.shape[-1]
    if not 1 <= chunk <= CHUNK_MAX or L % chunk:
        raise ValueError(f"chunk={chunk} must be in 1..{CHUNK_MAX} and divide L={L}")
    if B.dtype not in BC_DTYPES:
        raise TypeError(f"B: dtype {B.dtype}, expected one of {list(BC_DTYPES)}")
    if smem_bytes(chunk, N, P) > SMEM_MAX:
        raise ValueError(f"chunk={chunk}, N={N}, P={P} need "
                         f"{smem_bytes(chunk, N, P)} B of shared memory (> {SMEM_MAX})")
    f32 = torch.float32
    ptrs = [build.require(x, "x", f32, (bh, L, P), dev),
            build.require(loga, "loga", f32, (bh, L), dev),
            build.require(B, "B", B.dtype, (bh, L, N), dev),
            build.require(C, "C", B.dtype, (bh, L, N), dev)]
    build.on_card(dev, "ssd_chunk_scan")
    nc = L // chunk
    y = torch.empty((bh, L, P), dtype=f32, device=dev)
    s = torch.empty((bh, nc, N, P), dtype=f32, device=dev)
    t = torch.empty((bh, nc), dtype=f32, device=dev)
    outs = [ctypes.c_void_p(o.data_ptr()) for o in (y, s, t)]
    build.check(_fn()(*ptrs, *outs, bh, L, P, N, chunk, BC_DTYPES[B.dtype],
                      build.stream(dev)), "ssd_chunk_scan")
    ssd_chunk_scan.launches += 1
    return y, s, t


ssd_chunk_scan.launches = 0
