"""The enqueue-rank and round-robin arbitration of the reference's
fabric and sender: the vector program of the simulator's semantics (the
``jnp`` backend), with nothing of a kernel."""

from __future__ import annotations

from . import enqueue_arb_ref as R
from . import np32 as jnp

I32 = jnp.int32


def enqueue_rank(in_tbl, in_pos, sw_of_q, edst, q_head, q_size, cap: int, nq: int):
    """Acceptance + queue position for every enqueue-capable emitter's
    attempt (``edst`` [EQ], sentinel ``nq`` = none), and the accepted
    count a queue: ``(acc, pos, q_counts)``."""
    gdst = jnp.concatenate([edst, jnp.full((1,), nq, I32)])[in_tbl]
    ghead = q_head[gdst]
    gsize = q_size[gdst]
    _, acc_g, pos = R.enqueue_rank_ref(gdst, ghead, gsize, cap=cap, nq=nq)
    qsel = gdst[sw_of_q] == jnp.arange(nq, dtype=I32)[:, None]
    q_counts = jnp.sum(jnp.where(qsel & acc_g[sw_of_q], 1, 0), axis=1).astype(I32)
    return acc_g.reshape(-1)[in_pos], pos.reshape(-1)[in_pos], q_counts


def rr_pick(elig, rr, kmax: int):
    """Round-robin argmin per row (``enqueue_arb_ref.rr_pick_ref``)."""
    return R.rr_pick_ref(elig, rr, kmax=kmax)


def get(backend: str):
    if backend != "jnp":
        raise KeyError(f"the reference runs the jnp backend alone, not {backend!r}")
    return enqueue_rank, rr_pick
