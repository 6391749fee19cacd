"""Plain PyTorch versions of the ssd_chunk_scan kernel.

``ssd_chunk_scan_ref`` is the Mamba-2 SSD intra-chunk pass as the JAX
package's Pallas kernel and the intra-chunk half of
``ssd_scan/ops.py::ssd_jnp_with_state`` compute it, in f32:

    L        = cumsum(loga)                             # per chunk
    y_intra  = ((C Bᵀ) ∘ exp(L_i - L_j) ∘ causal) x
    S_chunk  = (B ∘ exp(L_end - L))ᵀ x
    T_chunk  = exp(L_end)

``ssd_ref`` is the sequential oracle (the JAX package's ``ssd_scan/ref.py``):
``S_t = exp(loga_t) S_{t-1} + B_t ⊗ x_t``, ``y_t = C_t S_t``.
"""

from __future__ import annotations

import torch

NEG_BIG = -1e30


def group_rep(x, B) -> int:
    """Heads a row of B/C serves, ``BH // BG``; ``ValueError`` unless
    ``BG`` divides ``BH``."""
    BH, BG = x.shape[0], B.shape[0]
    if BG < 1 or BH % BG:
        raise ValueError(f"B/C have {BG} rows of groups, which does not divide the "
                         f"{BH} head rows of x")
    return BH // BG


def expand_groups(x, B, C):
    """B/C in group form ``[BG, L, N]`` -> one row a head ``[BH, L, N]``
    (head row ``bh`` takes group row ``bh // (BH // BG)``)."""
    rep = group_rep(x, B)
    if rep == 1:
        return B, C
    return B.repeat_interleave(rep, dim=0), C.repeat_interleave(rep, dim=0)


def ssd_chunk_scan_ref(x, loga, B, C, *, chunk: int):
    """x ``[BH, L, P]``, loga ``[BH, L]``, B/C ``[BH, L, N]`` or in group
    form ``[BG, L, N]``, ``BH % BG == 0`` (any float dtype; f32 inside) ->
    y ``[BH, L, P]``, s ``[BH, L/chunk, N, P]``, t ``[BH, L/chunk]``, all
    f32."""
    B, C = expand_groups(x, B, C)
    BH, L, P = x.shape
    N = B.shape[-1]
    NC = L // chunk
    xr = x.reshape(BH, NC, chunk, P).float()
    lar = loga.reshape(BH, NC, chunk).float()
    Br = B.reshape(BH, NC, chunk, N).float()
    Cr = C.reshape(BH, NC, chunk, N).float()
    Lc = torch.cumsum(lar, dim=-1)
    diff = Lc[..., :, None] - Lc[..., None, :]
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    M = torch.exp(torch.where(mask, diff, NEG_BIG))
    G = torch.einsum("bcin,bcjn->bcij", Cr, Br) * M
    y = torch.einsum("bcij,bcjp->bcip", G, xr).reshape(BH, L, P)
    decay_end = torch.exp(Lc[..., -1:] - Lc)                   # [BH, NC, C]
    s = torch.einsum("bcjn,bcjp->bcnp", Br * decay_end[..., None], xr)
    t = torch.exp(Lc[..., -1])
    return y, s, t


def ssd_ref(x, loga, B, C):
    """Sequential recurrence; x ``[BH, L, P]`` pre-scaled by dt, loga
    ``[BH, L]``, B/C ``[BH, L, N]`` -> y ``[BH, L, P]`` f32."""
    x, loga, B, C = x.float(), loga.float(), B.float(), C.float()
    BH, L, P = x.shape
    S = torch.zeros(BH, B.shape[-1], P, device=x.device)
    ys = []
    for t in range(L):
        S = torch.exp(loga[:, t])[:, None, None] * S + B[:, t, :, None] * x[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", C[:, t], S))
    return torch.stack(ys, dim=1)
