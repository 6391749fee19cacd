"""ctypes wrapper of the CUDA ``flash_attention`` kernels.

The dtype decides which kernel takes a call (:func:`variant`), one rule
with no fallback: f32 goes to the SIMT kernel (``csrc/flash_attn.cu``),
bf16 to the tensor-core kernel (``csrc/flash_attn_tc.cu``), which takes
head dims (q/k's and v's) that are multiples of 8 and rows that are
16-byte aligned; bf16 operands it does not take raise ``ValueError``.
V may have a head dim ``Dv <= D`` of its own (MLA), as the JAX package's
``blocked_attention`` takes; the output then has ``Dv`` columns.
``score_dtype=torch.bfloat16`` (``cfg.attn_bf16``) launches the
tensor-core kernel's bf16-score variant (``repro_flash_attention_tc_bf16s``:
the scores and probabilities rounded to bf16 as the plain version's
``score_dtype`` rounds them); the SIMT kernel keeps f32 scores, so f32
operands with bf16 scores raise ``ValueError``.

The wrapper checks every operand (device, dtype, shape, a unit innermost
stride: the kernels take the other strides, so ``gqa``'s ``[B, S, H, D]``
-> ``[B, H, S, D]`` transposes reach them without a copy), allocates the
output as a ``[B, Hq, Sq, Dv]`` view of ``[B, Sq, Hq, Dv]`` storage (so the
caller's transpose back is free), launches on PyTorch's current stream,
raises if the launch failed, and counts its launches in
``flash_attention.launches``, by kernel in ``launches_tc`` and
``launches_simt``, and those with bf16 scores (tensor-core ones) in
``launches_bf16s``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
D_MAX = 128
TC_ALIGN = 8            # elements: 16 bytes of bf16, one cp.async chunk
VARIANTS = ("tc", "simt")
_LL = ctypes.c_longlong
_LAUNCHERS = {"tc": "repro_flash_attention_tc", "simt": "repro_flash_attention",
              "tc_bf16s": "repro_flash_attention_tc_bf16s"}


class _Args(ctypes.Structure):
    """Mirror of ``struct FlashArgs`` (field order is the C order), the
    argument struct of both kernels."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o")]
                + [(f"{t}_s{a}", _LL) for t in "qkvo" for a in "bhs"]
                + [(n, ctypes.c_int) for n in ("b", "hq", "hkv", "sq", "sk", "d", "dv",
                                               "causal", "window", "dtype")]
                + [("scale", ctypes.c_float)])


def _fn(kind: str):
    fn = getattr(build.library(), _LAUNCHERS[kind])
    fn.argtypes = [_Args, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_tc(q, k, v) -> None:
    """Raise ``ValueError`` unless the tensor-core kernel takes the
    operands: bf16, head dims (q/k's and v's) multiples of 8, every row
    16-byte aligned (pointer and the b, h, s strides) with a unit innermost
    stride."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core kernel takes bf16, got {q.dtype}")
    for what, n in (("head dim", q.shape[-1]), ("value head dim", v.shape[-1])):
        if n % TC_ALIGN:
            raise ValueError(f"{what} {n}: the tensor-core kernel takes a "
                             f"multiple of {TC_ALIGN}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.data_ptr() % 16 or t.stride(-1) != 1
                or any(s % TC_ALIGN for s in t.stride()[:-1])):
            raise ValueError(f"{name}: rows not 16-byte aligned for the tensor-core "
                             f"kernel (address {t.data_ptr()} mod 16 = "
                             f"{t.data_ptr() % 16}, strides {t.stride()})")


def variant(q, k, v) -> str:
    """The kernel that takes ``flash_attention(q, k, v)``: ``"simt"`` for
    f32, ``"tc"`` for bf16 (after :func:`_check_tc`, which raises
    ``ValueError`` if the tensor-core kernel does not take the operands)."""
    if q.dtype == torch.bfloat16:
        _check_tc(q, k, v)
        return "tc"
    return "simt"


_by_dtype = variant     # flash_attention's keyword of the same name shadows it


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    variant: str | None = None, score_dtype=torch.float32):
    """Launch a kernel on CUDA tensors; q ``[B, Hq, Sq, D]``, k ``[B, Hkv,
    Sk, D]``, v ``[B, Hkv, Sk, Dv]``, f32 or bf16, ``Dv <= D <= 128``,
    ``Hq % Hkv == 0``; returns ``[B, Hq, Sq, Dv]``.

    ``variant`` (``"tc"`` or ``"simt"``) names the kernel; left ``None``,
    the dtype decides (:func:`variant`).  Only the card's checks name it,
    to time the SIMT kernel on bf16 beside the tensor-core one.
    ``score_dtype`` f32 or bf16; bf16 takes the tensor-core kernel only."""
    dev = q.device
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k: expected [B, H, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1] if v.dim() == 4 else d
    if q.dtype not in DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected one of {list(DTYPES)}")
    if not 1 <= dv <= d <= D_MAX or hkv < 1 or hq % hkv:
        raise ValueError(f"head dims {d}, {dv} (1 <= Dv <= D <= {D_MAX}) and heads "
                         f"{hq}/{hkv} (a multiple) not supported")
    ptrs = dict(q=build.require(q, "q", q.dtype, (b, hq, sq, d), dev, last_dim_only=True),
                k=build.require(k, "k", q.dtype, (b, hkv, sk, d), dev, last_dim_only=True),
                v=build.require(v, "v", q.dtype, (b, hkv, sk, dv), dev, last_dim_only=True))
    if variant not in (None, *VARIANTS):
        raise ValueError(f"variant {variant!r}: expected one of {VARIANTS} or None")
    if variant == "tc":
        _check_tc(q, k, v)
    kind = variant or _by_dtype(q, k, v)
    if score_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"score_dtype {score_dtype}: expected torch.float32 or "
                        f"torch.bfloat16")
    bf16s = score_dtype == torch.bfloat16
    if bf16s and kind != "tc":
        raise ValueError(f"bf16 scores (attn_bf16) on {q.dtype} operands: only the "
                         f"tensor-core kernel (bf16 operands) has a bf16-score variant; "
                         f"the SIMT kernel keeps f32 scores")
    build.on_card(dev, "flash_attention")
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = {f"{n}_s{a}": t.stride(i) for n, t in zip("qkvo", (q, k, v, out))
               for i, a in enumerate("bhs")}
    args = _Args(**{n: p.value for n, p in ptrs.items()}, o=out.data_ptr(),
                 **strides, b=b, hq=hq, hkv=hkv, sq=sq, sk=sk, d=d, dv=dv,
                 causal=int(bool(causal)), window=int(window),
                 dtype=DTYPES[q.dtype], scale=d ** -0.5)
    launcher = "tc_bf16s" if bf16s else kind
    build.check(_fn(launcher)(args, build.stream(dev)), f"flash_attention ({launcher})")
    build.count(flash_attention, launches=1, **{f"launches_{kind}": 1},
                launches_bf16s=int(bf16s))
    return out


def reset_launches() -> None:
    """Set the total, both per-kernel counts and the bf16-score count to 0."""
    flash_attention.launches = flash_attention.launches_tc = \
        flash_attention.launches_simt = flash_attention.launches_bf16s = 0


reset_launches()
