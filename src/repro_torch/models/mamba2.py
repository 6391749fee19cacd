"""Mamba-2 block (SSD, arXiv:2405.21060; the JAX package's
``models/mamba2.py``, serving half).

Prefill runs the chunked SSD: the intra-chunk pass through the
``ssd_chunk_scan`` kernel and the inter-chunk recurrence in plain
PyTorch, both reading B and C in group form (the reference expands them
to every head; the function is the same); decode updates the
``[B, H, P, N]`` state recurrently.  Casts
mirror the reference: projections and conv outputs bf16, the SSD and the
caches f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers as L
from repro_torch.sharding import P, split_heads


class Mamba2(nn.Module):
    """Parameters of one Mamba-2 mixer, in the JAX package's layout."""

    def __init__(self, cfg, device, generator=None):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        di, h, gn, k = s.d_inner(d), s.n_heads(d), s.n_groups * s.d_state, s.conv_kernel
        f32 = torch.float32
        g = generator

        def param(name, value):
            self.register_parameter(name, nn.Parameter(value))

        def dense(name, d_in, d_out, scale=None):
            param(name, L.dense_init(g, d_in, d_out, device, scale))

        def conv(name, width):
            param(name, L.normal((k, width), g, device, (k * width) ** -0.5))

        dense("wz", d, di)
        dense("wx", d, di)
        dense("wB", d, gn)
        dense("wC", d, gn)
        dense("wdt", d, h)
        param("dt_bias", torch.zeros(h, dtype=f32, device=device))
        param("A_log", torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=device)))
        param("Dskip", torch.ones(h, dtype=f32, device=device))
        conv("conv_x", di)
        conv("conv_B", gn)
        conv("conv_C", gn)
        param("norm", torch.ones(di, dtype=f32, device=device))
        dense("out", di, d, scale=di ** -0.5)


def _causal_conv(x, w):
    """Depthwise causal conv, x ``[B, S, C]``, w ``[K, C]``: the reference's
    shifted sum in f32 (not ``F.conv1d``, which cuDNN may run in TF32)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1], :].float() * w[i].float()
    return out.to(x.dtype)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_apply(p, cfg, x, sh=None, return_state: bool = False, backend: str = "kernel"):
    """x ``[B, S, D]`` -> ``[B, S, D]`` (optionally also the decode cache).

    Under ``sh`` with DTensor operands, the causal convolutions (channel
    by channel) and the SSD (the kernel and the inter-chunk recurrence,
    head by head) run on each rank's shard (``Shardings.local``): the
    batch over the data axes, the inner channels and heads over the model
    axis where the heads divide it and the groups divide it or are one."""
    s = cfg.ssm
    b, sl, d = x.shape
    di = s.d_inner(d)
    h = s.n_heads(d)
    pdim = s.head_dim
    n = s.d_state
    g = s.n_groups

    ba = hx = gx = None
    if sh is not None and sh.enabled:
        ba = sh.maybe(sh.batch, b, "mamba batch")
        m = sh.axis_size(sh.model)
        hx = sh.model if h % m == 0 and (g % m == 0 or g == 1) else None
        gx = hx if g > 1 else None

    def conv(t, w, ax):
        # the weight's gradient on a rank is its batch shard's share
        spec = P(ba, None, ax)
        return sh.local(_causal_conv, spec, (spec, P(None, ax)), t, w,
                        summed={1: ba}) if sh is not None else _causal_conv(t, w)

    z = x @ p.wz
    x_pre, B_pre, C_pre = x @ p.wx, x @ p.wB, x @ p.wC
    xs = L.silu(conv(x_pre, p.conv_x, hx))
    Bm = L.silu(conv(B_pre, p.conv_B, gx))
    Cm = L.silu(conv(C_pre, p.conv_C, gx))
    dt = _softplus((x @ p.wdt).float() + p.dt_bias)            # [B, S, H]
    if sh is not None:
        xs = sh.constrain_ffn(xs)
        z = sh.constrain_ffn(z)

    A = -torch.exp(p.A_log)                                    # [H] negative
    loga = dt * A                                              # [B, S, H]
    xh = split_heads(xs, h, pdim)
    xbar = xh * dt[..., None]                                  # f32

    # B and C stay in group form, [B*G, S, N]: head h of sequence b reads
    # group row (b*H + h) // (H // G), in the SSD kernels and _inter_chunk
    Bg = Bm.reshape(b, sl, g, n)
    Cg = Cm.reshape(b, sl, g, n)

    # pad to a chunk multiple: x=0 contributes nothing; loga=0 (decay 1)
    # leaves the carried state untouched, so the final state stays exact.
    # A prompt shorter than a chunk is padded to whole 16-row tiles, the
    # tensor-core kernel's (the reference takes chunk = sl there: the same
    # function, summed over a few more zero terms)
    chunk = min(s.chunk, -(-sl // ssd_ops.TILE) * ssd_ops.TILE)
    pad = (-sl) % chunk
    slp = sl + pad

    def ssd(xbar, loga, Bg, Cg, xh, dskip):
        """The SSD on [B, S, H or G, *] tensors (a rank's shard under sh)
        with the D skip: y [B, S, H * P] in x's dtype (the heads merged
        here, so a gradient split over the inner channels reaches this
        region whole) and the final state [B, H, N, P]."""
        b, _, h, _ = xbar.shape

        def to_bh(t):                    # [B, S, H, *] -> [B*H, S, *] (H: heads or groups)
            t = F.pad(t, (0, 0, 0, 0, 0, pad))
            # contiguous: at B=1 the reshape is a strided view, which the kernel refuses
            return t.transpose(1, 2).reshape(b * t.shape[2], slp, t.shape[-1]).contiguous()

        loga_p = F.pad(loga, (0, 0, 0, pad))
        y, state = ssd_ops.ssd_with_state(
            to_bh(xbar), loga_p.transpose(1, 2).reshape(b * h, slp).contiguous(),
            to_bh(Bg), to_bh(Cg), chunk=chunk, backend=backend)
        y = y.reshape(b, h, slp, pdim)[:, :, :sl].transpose(1, 2)  # [B, S, H, P]
        y = y + xh.float() * dskip[None, None, :, None]
        return y.reshape(b, sl, h * pdim).to(x.dtype), state.reshape(b, h, n, pdim)

    args = (xbar, loga, Bg, Cg, xh, p.Dskip)
    if sh is not None and sh.enabled:
        heads, groups = P(ba, None, hx, None), P(ba, None, gx, None)
        # with the heads sharded and the groups not, a rank's B/C gradient
        # is its heads' share: summed over the model axis; D's is its batch
        # shard's share
        summed = {5: ba, **({2: hx, 3: hx} if hx and not gx else {})}
        y, state = sh.local(ssd, (P(ba, None, hx), P(ba, hx, None, None)),
                            (heads, P(ba, None, hx), groups, groups, heads, P(hx)), *args,
                            summed=summed)
    else:
        y, state = ssd(*args)

    y = y * L.silu(z)
    if sh is not None:
        # the gated norm reduces over the inner channels: gathered first
        # (left sharded, DTensor moves the sequence onto the model axis in
        # the backward, a placement it cannot size on fake tensors)
        y = sh.constrain(y, P(ba, None, None))
    y = L.rmsnorm(y, p.norm, cfg.rms_eps)
    out = y @ p.out
    if not return_state:
        return out
    k = s.conv_kernel - 1
    cache = {
        # the SSD state comes back [B, H, N, P] -> decode layout [B, H, P, N]
        "ssm": state.transpose(2, 3).contiguous(),
        "conv_x": x_pre[:, -k:].float(),
        "conv_B": B_pre[:, -k:].float(),
        "conv_C": C_pre[:, -k:].float(),
    }
    return out, cache


def mamba_init_cache(cfg, batch, device, dtype=torch.float32):
    s = cfg.ssm
    d = cfg.d_model
    di, h, gn = s.d_inner(d), s.n_heads(d), s.n_groups * s.d_state
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return {"ssm": zeros(batch, h, s.head_dim, s.d_state),
            "conv_x": zeros(batch, s.conv_kernel - 1, di),
            "conv_B": zeros(batch, s.conv_kernel - 1, gn),
            "conv_C": zeros(batch, s.conv_kernel - 1, gn)}


def _conv_step(cache, x1, w):
    """cache ``[B, K-1, C]``, x1 ``[B, C]`` -> (new_cache, out ``[B, C]``)."""
    hist = torch.cat([cache, x1[:, None].to(cache.dtype)], dim=1)   # [B, K, C]
    out = torch.einsum("bkc,kc->bc", hist.float(), w.float())
    return hist[:, 1:], out.to(x1.dtype)


def mamba_decode(p, cfg, x1, cache):
    """Single-token step, x1 ``[B, 1, D]`` -> (``[B, 1, D]``, new cache)."""
    s = cfg.ssm
    b, _, d = x1.shape
    h = s.n_heads(d)
    pdim, n, g = s.head_dim, s.d_state, s.n_groups
    x0 = x1[:, 0]

    z = x0 @ p.wz
    cache_cx, xs = _conv_step(cache["conv_x"], x0 @ p.wx, p.conv_x)
    cache_cb, Bm = _conv_step(cache["conv_B"], x0 @ p.wB, p.conv_B)
    cache_cc, Cm = _conv_step(cache["conv_C"], x0 @ p.wC, p.conv_C)
    xs, Bm, Cm = L.silu(xs), L.silu(Bm), L.silu(Cm)
    dt = _softplus((x0 @ p.wdt).float() + p.dt_bias)          # [B, H]

    A = -torch.exp(p.A_log)
    a = torch.exp(dt * A)                                      # [B, H]
    xh = split_heads(xs, h, pdim).float()
    xbar = xh * dt[..., None]
    rep = h // g
    Bh = Bm.reshape(b, g, n).repeat_interleave(rep, dim=1).float()
    Ch = Cm.reshape(b, g, n).repeat_interleave(rep, dim=1).float()

    S = cache["ssm"] * a[..., None, None] + torch.einsum("bhp,bhn->bhpn", xbar, Bh)
    y = torch.einsum("bhpn,bhn->bhp", S, Ch)
    y = y + xh * p.Dskip[None, :, None]
    y = y.reshape(b, s.d_inner(d)).to(x1.dtype)
    y = L.rmsnorm(y * L.silu(z), p.norm, cfg.rms_eps)
    new_cache = {"ssm": S, "conv_x": cache_cx, "conv_B": cache_cb,
                 "conv_C": cache_cc}
    return (y @ p.out)[:, None], new_cache
