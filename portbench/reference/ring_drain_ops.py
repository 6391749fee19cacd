"""The sent-ring drain of the reference's control phase: the vector
program of the simulator's semantics (the ``jnp`` backend)."""

from __future__ import annotations

from . import ring_drain_ref as R


def ring_drain(t, rto, started, has_ack, ack_seq, lbits, bitmap, sent0, sent1, sent2):
    return R.ring_drain_ref(t, rto, started, has_ack, ack_seq, lbits, bitmap, sent0, sent1,
                            sent2, w=sent0.shape[1], ww=lbits.shape[1], maxw=bitmap.shape[1])


def get(backend: str):
    if backend != "jnp":
        raise KeyError(f"the reference runs the jnp backend alone, not {backend!r}")
    return ring_drain
