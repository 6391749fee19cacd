"""Pure-jnp reference for the packed sent-ring drain (transport phase 3).

One call folds this tick's three loss/ack event sources into the sent-ring
state plane:

  1. free the slot matched by this tick's cumulative ACK,
  2. mark trim-notified slots lost (the [NF, WW] loss-bitmap words from the
     trim ring, expanded arithmetically — ``(word >> bit) & 1`` over an
     iota — instead of the [NF, W] advanced gather the phase used to pay
     XLA:CPU scatter prices for),
  3. fire retransmission timeouts (with the spurious-retx audit against
     the receiver dedupe bitmap, a static ``MAXW``-step select instead of
     a per-element gather),

and reduces the per-flow timeout / spurious / still-outstanding counts the
transport needs.  Everything is elementwise + row reductions over the
[NF, W] tile — no gathers, no scatters — which is both the fast jnp path
on CPU and, verbatim, the Pallas kernel body (``kernel.py`` calls this
function on VMEM-resident tiles, so kernel and oracle cannot drift).

Inputs may be lane-padded beyond the true ring width ``w`` (the Pallas
tiles are); padded lanes hold zeros and provably stay inert: a zero state
is never freed, lost, or timed out.
"""

from __future__ import annotations

from . import np32 as jnp

I32 = jnp.int32
F32 = jnp.float32


def ring_drain_ref(t, rto, started, has_ack, ack_seq, lbits, bitmap,
                   sent0, sent1, sent2, *, w: int, ww: int, maxw: int):
    """Drain ACK/trim/timeout events into the sent-ring state plane.

    Args:
      t:        i32 scalar current tick.
      rto:      f32 [F] per-flow retransmission timeout.
      started:  bool [F] flow started and unfinished.
      has_ack:  bool [F] an ACK for this flow landed this tick.
      ack_seq:  i32 [F] the ACKed sequence number (0 where no ACK).
      lbits:    i32 [F, >=ww] trim-ring loss-bitmap words.
      bitmap:   i32 [F, >=maxw] receiver dedupe bitmap (spurious audit).
      sent0/1/2: i32 [F, >=w] sent-ring state / seq / send-tick planes.
      w, ww, maxw: true (unpadded) ring width, loss words, bitmap words.

    Returns ``(state', n_to, spur, unacked_pkts)``: the new state plane
    (same padded width as ``sent0``) and per-flow i32 counts of fired
    timeouts, spurious retransmissions, and still-outstanding packets.
    """
    f, wt = sent0.shape                               # wt >= w (padding)
    wbits = jnp.arange(wt, dtype=I32)

    # 1. ACK frees its slot when the slot still holds that sequence.
    #    ``hit`` is one-hot per row (aslot < w <= wt), so "the hit lane
    #    still holds this sequence" collapses to ONE boolean any-reduce
    #    instead of two masked sums — every reduction here is a separate
    #    XLA fusion that re-streams the [F, W] planes, so fewer
    #    reductions is fewer passes (DESIGN.md Sec. 6.4)
    aslot = ack_seq % w
    hit = wbits[None, :] == aslot[:, None]
    match = has_ack & jnp.any(
        hit & (sent0 != 0) & (sent1 == ack_seq[:, None]), axis=1)
    state = jnp.where(match[:, None] & hit, 0, sent0)

    # 2. trim-notified packets -> lost (awaiting retransmission)
    bits = ((lbits[:, :ww, None] >> jnp.arange(32, dtype=I32)) & 1)
    bits = bits.reshape(f, ww * 32)                   # == [F, w]
    if wt > w:
        bits = jnp.pad(bits, ((0, 0), (0, wt - w)))
    lost = (bits == 1) & (state == 1)
    state = jnp.where(lost, 3, state)

    # 3. timeouts, with the spurious-retx audit against the receiver
    #    dedupe bitmap (does the receiver already hold this sequence?)
    to_mask = (state == 1) & \
        ((t - sent2).astype(F32) > rto[:, None]) & started[:, None]
    sp_word = sent1 // 32
    bm = jnp.zeros_like(sent1)
    for wd in range(maxw):                            # static, small
        bm = bm + jnp.where(sp_word == wd, bitmap[:, wd, None], 0)
    already = ((bm >> (sent1 % 32)) & 1) == 1
    state = jnp.where(to_mask, 3, state)

    # the three per-flow counts are 0/1 sums bounded by the ring width,
    # so for any practical width they pack into 10-bit fields of ONE
    # i32 reduction (no cross-field carry: each field's row total <= wt
    # < 1024) — one pass over the [F, W] tile instead of three
    if wt < 1024:
        packed = jnp.sum(
            (to_mask.astype(I32) << 20)
            + ((to_mask & already).astype(I32) << 10)
            + (state == 1).astype(I32), axis=1)
        n_to = packed >> 20
        spur = (packed >> 10) & 1023
        unacked_pkts = packed & 1023
    else:                                             # unbounded fallback
        n_to = jnp.sum(to_mask.astype(I32), axis=1)
        spur = jnp.sum((to_mask & already).astype(I32), axis=1)
        unacked_pkts = jnp.sum((state == 1).astype(I32), axis=1)
    return state, n_to, spur, unacked_pkts
