"""Gradient compression: int8 block-quantized all-reduce with error
feedback (the JAX package's ``train/compression.py``).

Wire cost per gradient element: 2 bytes (a reduce-scatter of int8 chunks
through ``all_to_all_single``, then an ``all_gather_into_tensor`` of the
int8 result) against 8 bytes for a ring all-reduce in f32: a 4x smaller
data-parallel collective, the traffic the paper's transport carries.
Error feedback carries the quantization residual into the next step.

Each rank passes its own gradient row (the JAX package's ``[world, N]``
rows are the ranks).  Every division has a tensor divisor (``/ 127.0``,
``/ world``), so the card and the CPU round alike.  quantize and
dequantize are plain PyTorch, as the JAX package's are plain ``jnp``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BLOCK = 256
F32 = torch.float32


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=F32, device=like.device)


def quantize(x, block: int = BLOCK):
    """f32 ``[N]`` (``N % block == 0``) -> (int8 ``[N]``, f32 ``[N / block]``
    scales)."""
    xb = x.reshape(-1, block)
    scale = torch.amax(torch.abs(xb), dim=1, keepdim=True) / _f32(127.0, x)
    scale = torch.maximum(scale, _f32(1e-12, x))
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0]


def dequantize(q, scale, block: int = BLOCK):
    return (q.to(F32).reshape(-1, block) * scale[:, None]).reshape(-1)


def dequantize_rows(q, scale):
    """``[R, C]`` int8 rows and their ``[R, C / BLOCK]`` scales -> f32 ``[R, C]``."""
    return torch.stack([dequantize(a, s) for a, s in zip(q, scale)])


def compressed_psum_mean(g, err, group=None):
    """Mean-all-reduce ``g`` (f32 ``[N]``, this rank's gradient) over
    ``group`` in int8.  Returns (the mean f32 ``[N]``, the new error f32
    ``[N]``).  ``N`` must be divisible by ``world * BLOCK``."""
    world = dist.get_world_size(group)
    idx = dist.get_rank(group)
    g_fb = g + err                      # error feedback
    q, scale = quantize(g_fb)
    residual = g_fb - dequantize(q, scale)

    # stage 1, reduce-scatter: exchange int8 chunks, each rank sums its chunk
    n = g.shape[0]
    chunk = n // world
    q_x = torch.empty((world, chunk), dtype=torch.int8, device=g.device)
    s_x = torch.empty((world, chunk // BLOCK), dtype=F32, device=g.device)
    dist.all_to_all_single(q_x, q.reshape(world, chunk).contiguous(), group=group)
    dist.all_to_all_single(s_x, scale.reshape(world, chunk // BLOCK).contiguous(),
                           group=group)
    part = torch.sum(dequantize_rows(q_x, s_x), dim=0) / _f32(world, g)   # f32 [chunk]

    # stage 2: all-gather the (re-quantized) reduced chunks
    pq, pscale = quantize(part)
    res2 = part - dequantize(pq, pscale)
    gq = torch.empty(world * chunk, dtype=torch.int8, device=g.device)
    gs = torch.empty(world * (chunk // BLOCK), dtype=F32, device=g.device)
    dist.all_gather_into_tensor(gq, pq, group=group)
    dist.all_gather_into_tensor(gs, pscale, group=group)
    out = dequantize_rows(gq.reshape(world, chunk), gs.reshape(world, -1)).reshape(-1)

    # the local residual of stage 2's re-quantization folds into feedback too
    err_new = residual.clone()
    err_new[idx * chunk:(idx + 1) * chunk] += res2
    return out, err_new


def make_compressed_allreduce(mesh, axis_name: str = "data"):
    """Returns ``(fn, world)``: ``fn(g, err) -> (mean_g, err')`` over the
    process group of ``mesh``'s ``axis_name`` dim, each rank passing its
    own row."""
    group = mesh.get_group(axis_name)

    def fn(g, err):
        return compressed_psum_mean(g, err, group)

    return fn, dist.get_world_size(group)
