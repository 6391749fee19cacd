"""Full SSD op = intra-chunk kernel + plain inter-chunk recurrence (the
JAX package's ``ssd_scan/ops.py``: ``_inter_chunk`` stays plain there
too; it is bandwidth-trivial beside the chunk products).

``"kernel"`` launches the CUDA kernel for CUDA tensors and takes the
plain version for CPU tensors; ``"plain"`` always takes the plain version,
and so does ``"dense"`` (the dry run's model backend, which only changes
attention: ``flash_attn/ops.py``).

Under autograd the kernel is the forward of :class:`SSDChunkScan`; its
backward is plain PyTorch (``ssd_chunk_scan_ref`` recomputed and
differentiated), as the JAX package differentiates its jnp version.
``_inter_chunk`` is differentiated by autograd on either backend.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref as R

BACKENDS = ("kernel", "plain", "dense")
TILE = K.TC_MULT        # rows a chunk is a multiple of, for the tensor-core kernel


class SSDChunkScan(torch.autograd.Function):
    """The kernel's forward, a plain backward: ``ssd_chunk_scan_ref``
    recomputed from the saved x, loga, B, C and differentiated, giving
    gradients for all four; B and C keep their group form, the gradient
    of a group row summed over the heads that read it (the backward of
    the reference's ``repeat_interleave``)."""

    @staticmethod
    def forward(ctx, x, loga, B, C, chunk):
        ctx.save_for_backward(x, loga, B, C)
        ctx.chunk = chunk
        return K.ssd_chunk_scan(x, loga, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gs, gt):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            outs = R.ssd_chunk_scan_ref(*ins, chunk=ctx.chunk)
            used = [(o, g) for o, g in zip(outs, (gy, gs, gt)) if o.requires_grad]
            wrt = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in used], wrt,
                                           [g for _, g in used], allow_unused=True))
        return (*(next(got) if n else None for n in need), None)


def ssd_chunk_scan(x, loga, B, C, *, chunk: int, backend: str = "kernel"):
    """Intra-chunk pass: ``(y_intra, s_chunk, t_chunk)`` (see ``ref.py``);
    B/C ``[BH, L, N]`` or in group form ``[BG, L, N]``."""
    if backend not in BACKENDS:
        raise KeyError(f"unknown SSD backend {backend!r}; have {BACKENDS}")
    if build.use_kernel(backend, x):
        return SSDChunkScan.apply(x, loga, B, C, chunk)
    return R.ssd_chunk_scan_ref(x, loga, B, C, chunk=chunk)


def _inter_chunk(y_intra, s_chunk, t_chunk, loga, C_mat, chunk):
    """Combine chunk states and add the cross-chunk correction; C_mat
    ``[BH, L, N]`` or in group form ``[BG, L, N]`` (read through a grouped
    product, never expanded).  Returns (y, final_state [BH, N, P])."""
    BH, L, P = y_intra.shape
    NC = L // chunk
    BG = C_mat.shape[0]
    rep = R.group_rep(y_intra, C_mat)
    S = torch.zeros(s_chunk.shape[:1] + s_chunk.shape[2:], device=y_intra.device)
    prev = []
    for c in range(NC):
        prev.append(S)                       # the state *before* chunk c
        S = t_chunk[:, c, None, None] * S + s_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)                  # [BH, NC, N, P]
    # y_inter[t] = exp(L_t) * C_t @ S_prev(chunk(t))
    Lc = torch.cumsum(loga.reshape(BH, NC, chunk).float(), dim=-1)
    Cr = C_mat.reshape(BG, NC, chunk, -1).float()
    y_inter = torch.einsum("gcin,grcnp->grcip", Cr,
                           prev_states.reshape(BG, rep, *prev_states.shape[1:]))
    y_inter = y_inter.reshape(BH, NC, chunk, P) * torch.exp(Lc)[..., None]
    return y_intra + y_inter.reshape(BH, L, P), S


def ssd_with_state(x, loga, B, C, *, chunk: int, backend: str = "kernel"):
    """The chunked SSD (``ssd_jnp_with_state``): y ``[BH, L, P]`` and the
    final state ``[BH, N, P]``, both f32; B/C as in :func:`ssd_chunk_scan`."""
    y_intra, s_chunk, t_chunk = ssd_chunk_scan(x, loga, B, C, chunk=chunk,
                                               backend=backend)
    return _inter_chunk(y_intra, s_chunk, t_chunk, loga, C, chunk)
