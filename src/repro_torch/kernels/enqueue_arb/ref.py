"""Plain PyTorch versions of the enqueue-rank and arbitration kernels.

``enqueue_rank_ref``
    Same-destination enqueue ranking + capacity acceptance, grouped by
    feeding switch.  Row ``sw`` holds the gathered per-slot values of the
    emitters in ``topology.in_tbl[sw]`` (ascending emitter id; padded
    slots carry the sentinel destination ``NQ``, which never equals a real
    queue id).  An emitter's rank is the number of lower-slot emitters in
    its group enqueueing to the same queue — since same-queue emitters
    always share a feeding switch and slots are id-ascending, this equals
    the global smaller-id count, at O(NSW * DMAX^2) instead of O(NE^2).

``rr_pick_ref``
    Per-row round-robin argmin arbitration (sender flow pick, EQDS grant
    pick): smallest ``(slot - rr) mod K`` among eligible slots, first
    index on ties, 0 where nothing is eligible.

Line for line the reference's ``repro/kernels/enqueue_arb/ref.py``, with
its floor ``%`` as ``torch.remainder``.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def enqueue_rank_ref(gdst, ghead, gsize, cap: int, nq: int):
    """Rank, acceptance, and queue position per fan-in slot.

    Args:
      gdst:  i32 [..., D] destination queue per slot (``NQ`` = no enqueue).
      ghead: i32 [..., D] head index of that queue (``q_head[gdst]``).
      gsize: i32 [..., D] occupancy of that queue (``q_size[gdst]``).
      cap:   per-port capacity (packets).
      nq:    queue count (sentinel destination).

    Returns ``(rank, acc, pos)``, each [..., D] (i32 / bool / i32):
      rank: same-destination arrival rank within the tick,
      acc:  packet accepted (destination real and rank fits the free space),
      pos:  ring slot it lands in (meaningful only where ``acc``).
    """
    d = gdst.shape[-1]
    jd = torch.arange(d, dtype=I32, device=gdst.device)
    same = (gdst[..., :, None] == gdst[..., None, :]) & \
        (jd[None, :] < jd[:, None])
    rank = torch.sum(same, dim=-1, dtype=I32)
    acc = (gdst < nq) & (rank < cap - gsize)
    pos = torch.remainder(ghead + gsize + rank, cap)
    return rank, acc, pos


def rr_pick_ref(elig, rr, kmax: int):
    """Round-robin pick per row: the eligible slot with the smallest
    ``(slot - rr) mod kmax`` key.

    Args:
      elig: bool [..., K] eligibility per slot.
      rr:   i32 [...] per-row round-robin cursor.
      kmax: modulus (the slot count).

    Returns ``(has, sel)``: any-eligible flag and the picked slot index
    (0 where nothing is eligible — the caller gates on ``has``).
    """
    k = elig.shape[-1]
    keys = torch.remainder(torch.arange(k, dtype=I32, device=elig.device)
                           - rr[..., None], kmax)
    keys = torch.where(elig, keys, kmax + 1)
    sel = torch.argmin(keys, dim=-1)        # first index on ties
    has = torch.any(elig, dim=-1)
    return has, sel.to(I32)
