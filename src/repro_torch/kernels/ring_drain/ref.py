"""Plain PyTorch version of the packed sent-ring drain (transport phase 3).

One call folds this tick's three loss/ack event sources into the sent-ring
state plane:

  1. free the slot matched by this tick's cumulative ACK,
  2. mark trim-notified slots lost (the [NF, WW] loss-bitmap words from the
     trim ring, expanded arithmetically — ``(word >> bit) & 1``),
  3. fire retransmission timeouts (with the spurious-retx audit against
     the receiver dedupe bitmap, a ``MAXW``-step select instead of a
     per-element gather),

and reduces the per-flow timeout / spurious / still-outstanding counts the
transport needs.  Line for line the reference's
``repro/kernels/ring_drain/ref.py`` (without the Pallas lane padding),
including its 10-bit packed count reduction while ``W < 1024``.
"""

from __future__ import annotations

import torch

I32 = torch.int32
F32 = torch.float32


def ring_drain_ref(t: int, rto, started, has_ack, ack_seq, lbits, bitmap,
                   sent0, sent1, sent2, *, w: int, ww: int, maxw: int):
    """Drain ACK/trim/timeout events into the sent-ring state plane.

    Args:
      t:        current tick (int).
      rto:      f32 [F] per-flow retransmission timeout.
      started:  bool [F] flow started and unfinished.
      has_ack:  bool [F] an ACK for this flow landed this tick.
      ack_seq:  i32 [F] the ACKed sequence number (0 where no ACK).
      lbits:    i32 [F, ww] trim-ring loss-bitmap words.
      bitmap:   i32 [F, maxw] receiver dedupe bitmap (spurious audit).
      sent0/1/2: i32 [F, w] sent-ring state / seq / send-tick planes.

    Returns ``(state', n_to, spur, unacked_pkts)``: the new state plane
    and per-flow i32 counts of fired timeouts, spurious retransmissions,
    and still-outstanding packets.
    """
    f = sent0.shape[0]
    dev = sent0.device
    wbits = torch.arange(w, dtype=I32, device=dev)

    # 1. ACK frees its slot when the slot still holds that sequence
    aslot = torch.remainder(ack_seq, w)
    hit = wbits[None, :] == aslot[:, None]
    match = has_ack & torch.any(
        hit & (sent0 != 0) & (sent1 == ack_seq[:, None]), dim=1)
    state = torch.where(match[:, None] & hit, 0, sent0)

    # 2. trim-notified packets -> lost (awaiting retransmission)
    bits = (lbits[:, :ww, None] >> torch.arange(32, dtype=I32, device=dev)) & 1
    bits = bits.reshape(f, ww * 32)                   # == [F, w]
    lost = (bits == 1) & (state == 1)
    state = torch.where(lost, 3, state)

    # 3. timeouts, with the spurious-retx audit against the receiver
    #    dedupe bitmap (does the receiver already hold this sequence?)
    to_mask = (state == 1) & \
        ((t - sent2).to(F32) > rto[:, None]) & started[:, None]
    sp_word = torch.div(sent1, 32, rounding_mode="floor")
    bm = torch.zeros_like(sent1)
    for wd in range(maxw):                            # small
        bm = bm + torch.where(sp_word == wd, bitmap[:, wd, None], 0)
    already = ((bm >> torch.remainder(sent1, 32)) & 1) == 1
    state = torch.where(to_mask, 3, state)

    # the three per-flow counts are 0/1 sums bounded by the ring width,
    # so below width 1024 they pack into 10-bit fields of ONE reduction
    if w < 1024:
        packed = torch.sum(
            (to_mask.to(I32) << 20)
            + ((to_mask & already).to(I32) << 10)
            + (state == 1).to(I32), dim=1, dtype=I32)
        n_to = packed >> 20
        spur = (packed >> 10) & 1023
        unacked_pkts = packed & 1023
    else:                                             # unbounded fallback
        n_to = torch.sum(to_mask, dim=1, dtype=I32)
        spur = torch.sum(to_mask & already, dim=1, dtype=I32)
        unacked_pkts = torch.sum(state == 1, dim=1, dtype=I32)
    return state, n_to, spur, unacked_pkts
