"""ctypes wrapper of the CUDA ``flash_attention`` kernel (``csrc/flash_attn.cu``).

The wrapper checks every operand (device, dtype, shape, a unit innermost
stride: the kernel takes the other strides, so ``gqa``'s ``[B, S, H, D]``
-> ``[B, H, S, D]`` transposes reach it without a copy), allocates the
output as a ``[B, Hq, Sq, D]`` view of ``[B, Sq, Hq, D]`` storage (so the
caller's transpose back is free), launches on PyTorch's current stream,
raises if the launch failed, and counts its launches in
``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
D_MAX = 128
_LL = ctypes.c_longlong


class _Args(ctypes.Structure):
    """Mirror of ``struct FlashArgs`` (field order is the C order)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o")]
                + [(f"{t}_s{a}", _LL) for t in "qkvo" for a in "bhs"]
                + [(n, ctypes.c_int) for n in ("b", "hq", "hkv", "sq", "sk", "d",
                                               "causal", "window", "dtype")]
                + [("scale", ctypes.c_float)])


def _fn():
    fn = build.library().repro_flash_attention
    fn.argtypes = [_Args, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the kernel on CUDA tensors; q ``[B, Hq, Sq, D]``, k/v
    ``[B, Hkv, Sk, D]``, f32 or bf16, ``D <= 128``, ``Hq % Hkv == 0``."""
    dev = q.device
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k: expected [B, H, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected one of {list(DTYPES)}")
    if not 1 <= d <= D_MAX or hkv < 1 or hq % hkv:
        raise ValueError(f"head dim {d} (1..{D_MAX}) and heads {hq}/{hkv} "
                         f"(a multiple) not supported")
    ptrs = dict(q=build.require(q, "q", q.dtype, (b, hq, sq, d), dev, last_dim_only=True),
                k=build.require(k, "k", q.dtype, (b, hkv, sk, d), dev, last_dim_only=True),
                v=build.require(v, "v", q.dtype, (b, hkv, sk, d), dev, last_dim_only=True))
    build.on_card(dev, "flash_attention")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = {f"{n}_s{a}": t.stride(i) for n, t in zip("qkvo", (q, k, v, out))
               for i, a in enumerate("bhs")}
    args = _Args(**{n: p.value for n, p in ptrs.items()}, o=out.data_ptr(),
                 **strides, b=b, hq=hq, hkv=hkv, sq=sq, sk=sk, d=d,
                 causal=int(bool(causal)), window=int(window),
                 dtype=DTYPES[q.dtype], scale=d ** -0.5)
    build.check(_fn()(args, build.stream(dev)), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
