"""Pure-jnp reference arithmetic for the enqueue-rank + arbitration kernel.

Two vector programs the tick runs every cycle at fabric scale:

``enqueue_rank_ref``
    Same-destination enqueue ranking + capacity acceptance, grouped by
    feeding switch.  Row ``sw`` of the inputs holds the gathered per-slot
    values of the emitters in ``topology.in_tbl[sw]`` (ascending emitter
    id; padded slots carry the sentinel destination ``NQ``, which never
    equals a real queue id).  An emitter's rank is the number of
    lower-slot emitters in its group enqueueing to the same queue — since
    same-queue emitters always share a feeding switch and slots are
    id-ascending, this equals the global smaller-id count the fabric's
    historical [NE, NE] compare+reduce produced, bit for bit, at
    O(NSW * DMAX^2) instead of O(NE^2).

``rr_pick_ref``
    Per-row round-robin argmin arbitration (sender flow pick, EQDS grant
    pick): smallest (slot - rr) mod K among eligible slots.  Padded slots
    must be ineligible; they then take the same key as ineligible real
    slots (K + 1) at higher indices, so the first-min argmin — and the
    no-candidate fallback index 0 — are unchanged by padding.

The Pallas kernel bodies call these functions on VMEM-resident tiles, so
kernel and reference cannot drift apart (the ``kernels/cc_update``
contract, DESIGN.md Sec. 6).
"""

from __future__ import annotations

from . import np32 as jnp

I32 = jnp.int32


def enqueue_rank_ref(gdst, ghead, gsize, cap: int, nq: int):
    """Rank, acceptance, and queue position per fan-in slot.

    Args:
      gdst:  i32 [..., D] destination queue per slot (``NQ`` = no enqueue).
      ghead: i32 [..., D] head index of that queue (``q_head[gdst]``).
      gsize: i32 [..., D] occupancy of that queue (``q_size[gdst]``).
      cap:   static per-port capacity (packets).
      nq:    static queue count (sentinel destination).

    Returns ``(rank, acc, pos)``, each [..., D]:
      rank: same-destination arrival rank within the tick,
      acc:  packet accepted (destination real and rank fits the free space),
      pos:  ring slot it lands in (meaningful only where ``acc``).
    """
    d = gdst.shape[-1]
    jd = jnp.arange(d, dtype=I32)
    same = (gdst[..., :, None] == gdst[..., None, :]) & \
        (jd[None, :] < jd[:, None])
    rank = jnp.sum(same.astype(I32), axis=-1)
    acc = (gdst < nq) & (rank < cap - gsize)
    pos = (ghead + gsize + rank) % cap
    return rank, acc, pos


def rr_pick_ref(elig, rr, kmax: int):
    """Round-robin pick per row: the eligible slot with the smallest
    ``(slot - rr) mod kmax`` key.

    Args:
      elig: bool [..., K] eligibility per slot (padded slots False).
      rr:   i32 [...] per-row round-robin cursor.
      kmax: static modulus (the *unpadded* slot count).

    Returns ``(has, sel)``: any-eligible flag and the picked slot index
    (0 where nothing is eligible — the caller gates on ``has``).
    """
    k = elig.shape[-1]
    keys = (jnp.arange(k, dtype=I32) - rr[..., None]) % kmax
    keys = jnp.where(elig, keys, kmax + 1)
    sel = jnp.argmin(keys, axis=-1)
    has = jnp.any(elig, axis=-1)
    return has, sel.astype(I32)
