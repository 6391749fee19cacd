"""Seeded kernel inputs, as numpy, for checking each kernel.

The CPU tests hand the same arrays to the reference's plain versions and
to this package's; ``chip_smoke.py`` hands them to each CUDA kernel and
its plain version on the card.  Every generator takes the shape and a
seed and returns plain numpy arrays (i32 / f32 / bool), with values
chosen so that every branch of the kernel is taken: ACKs that match and
miss their slot, trims, timeouts that fire, spurious retransmissions,
QuickAdapt and FastIncrease, same-destination ranks past the free space,
rows with nothing eligible, queues above their capacity.
"""

from __future__ import annotations

import numpy as np

# cc_update parameters (make_cc_params keywords) shared by both sides
CC_MTU = 4096.0
CC_BRTT = (36.0, 42.0, 20.0)


def cc_update_case(F: int, seed: int, react_every: int = 1) -> dict:
    """SMaRTT state, events and per-flow base RTTs for ``F`` flows."""
    rng = np.random.default_rng(seed)
    brtt = rng.choice(np.array(CC_BRTT, np.float32), F).astype(np.float32)
    bdp = 42 * CC_MTU
    f32 = lambda a: np.asarray(a, np.float32)
    now = int(rng.integers(40, 400))
    state = dict(
        cwnd=f32(rng.uniform(CC_MTU, 1.3 * bdp, F)),
        acked=f32(rng.uniform(0, 2e5, F)),
        qa_end=f32(rng.choice([0.0, now - 5.0, float(now), now + 30.0], F)),
        trigger_qa=rng.random(F) < 0.4,
        bytes_to_ignore=f32(rng.uniform(0, 6e4, F)),
        bytes_ignored=f32(rng.uniform(0, 6e4, F)),
        fi_count=f32(rng.uniform(0, 2e5, F)),
        fi_active=rng.random(F) < 0.2,
        avg_wtd=f32(rng.uniform(0, 0.5, F)),
        ack_count=rng.integers(0, 100, F).astype(np.int32),
    )
    has_ack = rng.random(F) < 0.7
    event = dict(
        has_ack=has_ack,
        ack_bytes=f32(np.where(rng.random(F) < 0.9, CC_MTU,
                               rng.integers(1, 4096, F))),
        ecn=rng.random(F) < 0.4,
        rtt=f32(np.where(rng.random(F) < 0.3, brtt,
                         rng.uniform(15, 90, F)).round()),
        n_trims=rng.integers(0, 3, F).astype(np.int32) * (rng.random(F) < 0.3),
        n_timeouts=rng.integers(0, 2, F).astype(np.int32) * (rng.random(F) < 0.1),
        unacked=f32(rng.integers(0, 60, F) * CC_MTU),
    )
    event["n_trims"] = event["n_trims"].astype(np.int32)
    event["n_timeouts"] = event["n_timeouts"].astype(np.int32)
    event["trim_bytes"] = f32(event["n_trims"] * CC_MTU)
    event["to_bytes"] = f32(event["n_timeouts"] * CC_MTU)
    return dict(params=dict(mtu=CC_MTU, bdp=bdp, brtt=brtt,
                            react_every=react_every),
                state=state, event=event, now=now)


def cc_update_tensors(case: dict, device):
    """``(params, state, event, now)`` of a :func:`cc_update_case` as the
    port's containers on ``device`` (the non-SMaRTT state fields zero)."""
    import torch

    from repro_torch.core.types import CCEvent, init_cc_state, make_cc_params

    pk = case["params"]
    p = make_cc_params(mtu=pk["mtu"], bdp=pk["bdp"],
                       brtt=torch.from_numpy(pk["brtt"]), device=device,
                       react_every=pk["react_every"])
    F = pk["brtt"].shape[0]
    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    s = init_cc_state(F, p)._replace(**{k: t(v) for k, v in case["state"].items()})
    zf = torch.zeros((F,), dtype=torch.float32, device=device)
    ev = CCEvent(ack_entropy=torch.zeros((F,), dtype=torch.int32, device=device),
                 credit_grant=zf, **{k: t(v) for k, v in case["event"].items()})
    return p, s, ev, case["now"]


def enqueue_rank_case(S: int, D: int, nq: int, cap: int, seed: int) -> dict:
    """[S, D] fan-in group rows: destinations drawn from a few queues per
    row (so ranks repeat), the sentinel ``nq`` for idle slots."""
    rng = np.random.default_rng(seed)
    per_row = rng.integers(0, max(nq, 1), (S, 3))
    pick = per_row[np.arange(S)[:, None], rng.integers(0, 3, (S, D))]
    gdst = np.where(rng.random((S, D)) < 0.6, pick, nq).astype(np.int32)
    ghead = rng.integers(0, cap, (S, D)).astype(np.int32)
    gsize = np.where(rng.random((S, D)) < 0.3, cap - rng.integers(0, 3, (S, D)),
                     rng.integers(0, cap + 1, (S, D))).astype(np.int32)
    return dict(gdst=gdst, ghead=ghead, gsize=gsize, cap=cap, nq=nq)


def rr_pick_case(N: int, K: int, seed: int) -> dict:
    """[N, K] eligibility (some rows empty) and cursors in [0, K)."""
    rng = np.random.default_rng(seed)
    elig = rng.random((N, K)) < rng.uniform(0.0, 0.6, (N, 1))
    elig[rng.random(N) < 0.2] = False
    rr = rng.integers(0, K, N).astype(np.int32)
    return dict(elig=elig, rr=rr, kmax=K)


def ring_drain_case(F: int, W: int, maxw: int, seed: int) -> dict:
    """Sent rings of width ``W`` with ACKs that match and miss, trims on
    outstanding and free slots, timeouts that fire, and receiver bitmaps
    that make some of them spurious."""
    rng = np.random.default_rng(seed)
    t = int(rng.integers(500, 5000))
    ww = W // 32
    sent0 = rng.choice(np.array([0, 1, 1, 1, 3], np.int32), (F, W))
    sent1 = rng.integers(0, maxw * 32, (F, W)).astype(np.int32)
    sent2 = (t - rng.integers(0, 300, (F, W))).astype(np.int32)
    rto = np.round(rng.uniform(60.0, 240.0, F), 1).astype(np.float32)
    started = rng.random(F) < 0.9
    has_ack = rng.random(F) < 0.6
    slot = rng.integers(0, W, F)
    hit_seq = sent1[np.arange(F), slot]
    ack_seq = np.where(rng.random(F) < 0.7, hit_seq,
                       rng.integers(0, maxw * 32, F)).astype(np.int32)
    ack_seq = np.where(has_ack, ack_seq, 0).astype(np.int32)
    bits = rng.random((F, ww, 32)) < 0.05
    lbits = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    lbits = lbits.astype(np.uint32).view(np.int32)
    bitmap = rng.integers(-2**31, 2**31, (F, maxw), dtype=np.int64).astype(np.int32)
    return dict(t=t, rto=rto, started=started, has_ack=has_ack,
                ack_seq=ack_seq, lbits=lbits, bitmap=bitmap,
                sent0=sent0, sent1=sent1, sent2=sent2)


# red_mark thresholds of the simulator's queues (CAP = 40 packets on the
# three-tier trees: kmin = 0.2 * CAP, kmax = 0.8 * CAP)
RED_CAP, RED_KMIN, RED_KMAX = 40, 8.0, 32.0


def red_mark_case(Q: int, seed: int, cap: int = RED_CAP) -> dict:
    """[Q] occupancies (empty queues, ones between the thresholds, full
    ones and some above ``cap``) and this tick's arrivals."""
    rng = np.random.default_rng(seed)
    q_size = rng.integers(0, cap + 6, Q).astype(np.int32)
    q_size[rng.random(Q) < 0.15] = 0
    arrivals = rng.integers(0, 7, Q).astype(np.int32)
    return dict(q_size=q_size, arrivals=arrivals, cap=cap)


def control_case(NF: int, N: int, W: int, MAXW: int, R: int, seed: int, *,
                 trimming: bool = True, credit_based: bool = False,
                 rto_backoff_max: int = 0, smartt: bool = True) -> dict:
    """Every operand of the fused control phase (``kernels/control``) for
    ``NF`` flows into ``N`` nodes, a sent ring ``W`` wide, ``MAXW`` dedupe
    words and ``R`` ring slots, at a tick ``t``: ACK rows that name their
    flow and rows that name another flow of the same receiver, trims with
    loss words, credits, sent rings whose ACKs match and miss, timeouts
    that fire (some spurious, some backed off), finished and unstarted
    flows, and SMaRTT state from :func:`cc_update_case`.  The slots of
    the rings that the flags turn off stay zero, as the fabric leaves
    them."""
    rng = np.random.default_rng(seed)
    mtu = int(CC_MTU)
    t = int(rng.integers(500, 5000))
    s = t % R
    i32 = lambda a: np.asarray(a, np.int32)
    dst = i32(rng.integers(0, N, NF))
    size = i32(rng.integers(1, MAXW * 32 * mtu + 1, NF))
    t_start = i32(np.where(rng.random(NF) < 0.9, rng.integers(0, t, NF), t + 5))
    dr = ring_drain_case(NF, W, MAXW, seed)
    sent = np.zeros((3, NF + 1, W), np.int32)
    sent[0, :NF], sent[1, :NF], sent[2, :NF] = dr["sent0"], dr["sent1"], dr["sent2"]
    sent[:, NF] = rng.integers(0, 4, (3, W))                # the sentinel row
    # ACK rows: each receiver's row names one flow (of its own, or not)
    ack_ring = np.zeros((R, N, 6), np.int32)
    ack_ring[:] = rng.integers(0, 3, (R, N, 6))             # other slots: noise
    for node in range(N):
        mine = np.flatnonzero(dst == node)
        valid = rng.random() < 0.85
        f = int(rng.choice(mine)) if len(mine) and rng.random() < 0.9 \
            else int(rng.integers(0, NF))
        slot = int(rng.integers(0, W))
        seq = int(sent[1, f, slot]) if rng.random() < 0.7 else int(rng.integers(0, MAXW * 32))
        ack_ring[s, node] = (int(valid), f, seq, int(rng.random() < 0.4),
                             int(rng.integers(0, 256)), t - int(rng.integers(1, 200)))
    trim_ring = np.zeros((R, NF + 1, 2 + W // 32), np.int32)
    credit_ring = np.zeros((R, NF + 1), np.float32)
    if trimming:
        cnt = rng.integers(0, 3, (R, NF + 1)) * (rng.random((R, NF + 1)) < 0.3)
        trim_ring[:, :, 0] = cnt
        trim_ring[:, :, 1] = cnt * rng.integers(1, mtu + 1, (R, NF + 1))
        trim_ring[:, :, 2:] = np.where(cnt[..., None] > 0, dr["lbits"][0], 0)
        trim_ring[s, :NF, 2:] = dr["lbits"]
    if credit_based:
        credit_ring[:] = np.where(rng.random((R, NF + 1)) < 0.4, float(mtu), 0.0)
    cc = cc_update_case(NF, seed)
    return dict(
        t=t, mtu=mtu, brtt_inter=42, brtt=cc["params"]["brtt"],
        flags=dict(trimming=trimming, credit_based=credit_based,
                   rto_backoff_max=rto_backoff_max, smartt=smartt),
        dst=dst, size=size, t_start=t_start, rto=dr["rto"],
        ack_ring=ack_ring, trim_ring=trim_ring, credit_ring=credit_ring,
        sent=sent, bitmap=np.concatenate([dr["bitmap"], np.zeros((1, MAXW), np.int32)]),
        done=rng.random(NF) < 0.1,
        rto_backoff=i32(rng.integers(0, 5, NF)),
        unacked=np.zeros(NF, np.float32), cc=cc["state"],
        n_to=np.int32(rng.integers(0, 1000)), spurious_retx=np.int32(rng.integers(0, 100)),
        n_ack=np.int32(rng.integers(0, 10**5)),
        rtt_hist=i32(rng.integers(0, 1000, 64)),
    )


def control_operands(case: dict, device):
    """``(t, Flags, Operands)`` of a :func:`control_case` on ``device``
    (fresh tensors: the phase updates them in place)."""
    import torch

    from repro_torch.core.types import init_cc_state, make_cc_params
    from repro_torch.kernels.control import ref as R

    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    p = make_cc_params(mtu=float(case["mtu"]), bdp=float(case["brtt_inter"] * case["mtu"]),
                       brtt=torch.from_numpy(case["brtt"]), device=device)
    nf = case["dst"].shape[0]
    cc = init_cc_state(nf, p)._replace(**{k: t(v) for k, v in case["cc"].items()})
    fl = R.Flags(mtu=case["mtu"], brtt_inter=case["brtt_inter"], **case["flags"])
    o = R.Operands(params=p, cc=cc, **{k: t(case[k]) for k in R.Operands._fields
                                       if k not in ("params", "cc")})
    return case["t"], fl, o


# the arrivals cases the CPU tests, the card tests and chip_smoke.py run:
# ((NSW, D, N, NF, QE), seed, flags).  One slot; a row past 32 slots (three
# warps: the kernel's carry across warps); perm_1024n_3t's shapes with drops
# on the credit path and the fault metrics, and with neither; 31 flows a node
ARRIVALS_CASES = (
    ((1, 1, 1, 1, 0), 1, {}),
    ((1, 3, 2, 3, 1), 2, {}),
    ((4, 6, 8, 12, 10), 3, dict(faulty=True)),
    ((6, 70, 40, 100, 150), 4, dict(credit_based=True, faulty=True)),
    ((176, 20, 1024, 1024, 1280), 5, dict(trimming=False, credit_based=True, faulty=True)),
    ((176, 20, 1024, 1024, 1280), 6, {}),
    ((12, 40, 32, 992, 300), 7, dict(credit_based=True)),
)


def arrivals_case(NSW: int, D: int, N: int, NF: int, QE: int, seed: int, *,
                  CAP: int = 40, W: int = 64, MAXW: int = 2, L: int = 9, R: int = 24,
                  trimming: bool = True, credit_based: bool = False,
                  faulty: bool = False) -> dict:
    """Every operand of the fused arrivals phase (``kernels/arrivals``):
    ``QE`` switch-facing ports and ``N`` sender NICs feeding ``NSW`` switch
    fan-in rows of at most ``D`` slots (the first row full, the others
    padded), ``NQ = QE + N`` queues of ``CAP`` packets (the last ``N``
    deliver to the nodes), ``NF`` flows, several a node.  The wire slot
    landing now carries enqueues that repeat a destination within a row,
    into full and nearly full queues (so rejects happen; flow 0 is rejected
    three times, twice in one row), deliveries that are new, duplicate,
    finish their flow, name another node's flow or a flow past ``NF``, or
    land past ``MAXW`` dedupe words.  The other slots and rows hold noise
    that the phase must leave alone, ``trim_seen`` values past 2**24, and
    the state keeps the simulator's invariants (``kernels/arrivals/ref.py``)."""
    rng = np.random.default_rng(seed)
    mtu = int(CC_MTU)
    i32 = lambda a: np.asarray(a, np.int32)
    NQ, EQ = QE + N, QE + N
    NE = NQ + N
    if not NSW <= NQ or not D <= EQ <= NSW * D:
        raise ValueError(f"{EQ} emitters do not fit {NSW} rows of {D} slots")
    t = int(rng.integers(500, 5000))
    ret, trim_delay = int(rng.integers(10, R - 2)), int(rng.integers(1, R))
    # the fan-in rows: compact emitters shuffled over the rows, row 0 full
    order = rng.permutation(EQ)
    lens = np.zeros(NSW, np.int64)
    lens[0] = D
    for _ in range(EQ - D):
        lens[rng.choice(np.flatnonzero(lens < D))] += 1
    in_tbl = np.full((NSW, D), EQ, np.int32)
    in_pos = np.zeros(EQ, np.int32)
    row_of = np.zeros(EQ, np.int64)
    at = 0
    for sw in range(NSW):
        members = np.sort(order[at:at + lens[sw]])
        at += lens[sw]
        in_tbl[sw, :len(members)] = members
        in_pos[members] = sw * D + np.arange(len(members))
        row_of[members] = sw
    enq_ids = i32(np.concatenate([np.arange(QE), np.arange(NQ, NE)]))
    sw_of_q = i32(np.concatenate([np.arange(NSW), rng.integers(0, NSW, NQ - NSW)]))
    owned = [np.flatnonzero(sw_of_q == sw) for sw in range(NSW)]

    dst = i32(rng.integers(0, N, NF))
    size = i32(rng.integers(1, MAXW * 32 * mtu + 1, NF))
    t_start = i32(rng.integers(0, t, NF))
    q_head = i32(np.append(rng.integers(0, CAP, NQ), 0))
    q_size = i32(np.append(rng.choice([0, 3, CAP // 2, CAP - 2, CAP - 1, CAP], NQ), 0))
    infl = i32(rng.integers(-3, 50, (L, NE, 7)))            # other slots: noise
    w = t % L
    slot = infl[w]
    slot[:] = rng.integers(-3, 50, (NE, 7))
    slot[:, 0] = 0
    # enqueues: few destinations a row, so ranks repeat
    for j in range(EQ):
        mine = owned[row_of[j]][:3]
        e = enq_ids[j]
        if rng.random() < 0.8:
            slot[e] = (1, rng.choice(mine) if rng.random() > 0.03 else -1,
                       rng.integers(0, NF), rng.integers(0, MAXW * 32 + 40),
                       rng.integers(0, 256), rng.integers(0, 2), t - rng.integers(1, 300))
    # flow 0 rejected three times: twice in row 0 and once in another row
    for sw, k in ((0, 0), (0, 1), (NSW - 1, 0)):
        if k < D and in_tbl[sw, k] < EQ:
            q = owned[sw][0]
            q_size[q] = CAP
            slot[enq_ids[in_tbl[sw, k]], :4] = (1, q, 0, int(rng.integers(0, 64)))
    # receiver ledgers: done exactly when goodput has reached the size
    bitmap = i32(np.concatenate([rng.integers(-2**31, 2**31, (NF, MAXW), dtype=np.int64),
                                 np.zeros((1, MAXW), np.int64)]))
    goodput = i32(np.minimum(rng.integers(0, MAXW * 32 * mtu, NF), size - 1))
    done = rng.random(NF) < 0.1
    goodput[done] = size[done]
    fct = i32(np.where(done, rng.integers(10, 2000, NF), -1))
    for i in range(N):
        r = NQ - N + i
        mine = np.flatnonzero(dst == i)
        u = rng.random()
        if u < 0.15:
            continue                                        # nothing lands
        f = int(rng.choice(mine)) if len(mine) and u < 0.85 else \
            int(rng.choice([rng.integers(0, NF), NF + 2, -3]))
        npk = (int(size[f]) + mtu - 1) // mtu if 0 <= f < NF else 8
        seq = int(rng.integers(0, npk)) if rng.random() < 0.95 else MAXW * 32 + 5
        slot[r] = (1, -(i + 1) if rng.random() < 0.95 else 3, f, seq,
                   rng.integers(0, 256), rng.integers(0, 2), t - rng.integers(1, 300))
        if 0 <= f < NF and dst[f] == i and not done[f] and seq < MAXW * 32:
            word, bit = divmod(seq, 32)
            bitmap[f, word] &= ~np.int32(1 << bit) if bit < 31 else np.int32(2**31 - 1)
            if rng.random() < 0.4:                          # this packet finishes it
                goodput[f] = size[f] - min(max(int(size[f]) - seq * mtu, 0), mtu)
            elif rng.random() < 0.2:                        # a duplicate
                bitmap[f, word] |= np.int32(1 << bit) if bit < 31 else np.int32(-2**31)
    q_fields = i32(rng.integers(-3, 50, (NQ + 1, CAP, 5)))
    q_fields[NQ] = 0                                        # the write-off row
    trim_seen = np.round(rng.uniform(0, 3e7, NF + 1)).astype(np.float32)
    trim_seen[NF] = 0.0
    fault_active = bool(rng.random() < 0.5) if faulty else None
    return dict(
        t=t, slots=dict(wire=w, ack=(t + ret) % R, trim=(t + trim_delay) % R),
        flags=dict(trimming=trimming, credit_based=credit_based, faulty=faulty,
                   mtu=mtu, qe=QE, ret=ret, goodput_bin=int(rng.integers(40, 400))),
        enq_ids=enq_ids, in_tbl=in_tbl, in_pos=in_pos, sw_of_q=sw_of_q,
        dst=dst, size=size, t_start=t_start, infl=infl, q_head=q_head, q_size=q_size,
        q_fields=q_fields, ack_ring=i32(rng.integers(-3, 50, (R, N, 6))),
        trim_ring=i32(rng.integers(0, 5, (R, NF + 1, 2 + W // 32))),
        trim_seen=trim_seen, bitmap=bitmap, goodput=goodput, done=done, fct=fct,
        delivered_pkts=np.int32(rng.integers(0, 10**6)),
        n_trim=np.int32(rng.integers(0, 10**5)), n_drop=np.int32(rng.integers(0, 10**5)),
        delivered_bytes=np.float32(np.round(rng.uniform(0, 4e9))),
        goodput_hist=np.round(rng.uniform(0, 3e7, 64)).astype(np.float32),
        delivered_bytes_fault=np.float32(np.round(rng.uniform(0, 4e8))),
        fault_active=fault_active,
    )


def arrivals_operands(case: dict, device):
    """``(t, Slots, Flags, Operands)`` of an :func:`arrivals_case` on
    ``device`` (fresh tensors: the phase updates them in place)."""
    import torch

    from repro_torch.kernels.arrivals import ref as R

    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    fa = case["fault_active"]
    o = R.Operands(**{k: t(case[k]) for k in R.Operands._fields if k != "fault_active"},
                   fault_active=None if fa is None else t(np.bool_(fa)))
    return case["t"], R.Slots(**case["slots"]), R.Flags(**case["flags"]), o


# the fused sends phase: ((N, FMAX, NF, W, D), seed, flags).  One flow a
# sender with pad rows; spraying on the credit path; alltoall_3t's rows
# ([512, 31] there) windowed; rows past two warps' chunks with a
# dependency table under ECMP on the credit path; PLB paced with the
# window inside the second chunk; perm_1024n_3t's shapes; and
# allreduce_ring_128n_3t's rows ([128, 254], eight chunks) with its
# dependency table
SENDS_CASES = (
    ((4, 1, 3, 32, 0), 1, {}),
    ((16, 1, 12, 64, 0), 2, dict(credit_based=True, lb_mode=1)),
    ((40, 31, 600, 64, 0), 3, dict(window=4)),
    ((8, 70, 300, 64, 3), 4, dict(credit_based=True, lb_mode=2)),
    ((12, 40, 250, 64, 0), 5, dict(paced=True, lb_mode=3, window=33)),
    ((1024, 1, 1024, 64, 0), 6, {}),
    ((128, 254, 32512, 32, 2), 7, {}),
)


def sends_case(N: int, FMAX: int, NF: int, W: int, D: int, seed: int, *,
               window: int | None = None, credit_based: bool = False,
               paced: bool = False, lb_mode: int = 0, L: int = 9,
               NQ: int = 40) -> dict:
    """Every operand of the fused sends phase (``kernels/sends``): ``NF``
    flows over ``N`` senders of up to ``FMAX`` flows (one row full, some
    rows empty: pad rows of ``flows_of``), a ``W``-slot sent ring, ``D``
    dependency columns (parents below and above their thresholds, free
    slots), wire rows ``[0, NQ + N)``.  Flows that are not started yet,
    done, held by the window, short of window, credit or pacing budget;
    retransmissions pending on ring slot 0, on slot 40 (where the ring has
    it) and on two slots of one flow (the first wins), each on a flow its
    row's cursor picks; new sequences whose ring slot is still occupied
    and past the flow's last packet; last packets shorter than the MTU;
    REPS inside and past its explore phase; a cursor past its row's last
    eligible slot, so the pick wraps.  The NIC rows of the wire slot hold
    noise the phase must overwrite."""
    rng = np.random.default_rng(seed)
    mtu = int(CC_MTU)
    i32 = lambda a: np.asarray(a, np.int32)
    f32 = lambda a: np.asarray(a, np.float32)
    if window is None:
        window = FMAX
    if not FMAX <= NF <= N * FMAX:
        raise ValueError(f"{NF} flows do not fit {N} rows of {FMAX}")
    t = int(rng.integers(500, 5000))
    # the rows: one full, some empty (pad rows, where the flows leave room),
    # the other flows over the free slots of the rest
    need = -(-(NF - FMAX) // FMAX)
    n_empty = max(0, min(max(1, N // 8), N - 1 - need))
    open_rows = rng.permutation(np.arange(1, N))[n_empty:]
    free = np.repeat(open_rows, FMAX)
    cnt = np.bincount(free[rng.choice(len(free), NF - FMAX, replace=False)], minlength=N)
    cnt[0] = FMAX
    order = rng.permutation(NF)
    flows_of = np.full((N, FMAX), NF, np.int32)
    src, slot_of = np.zeros(NF, np.int32), np.zeros(NF, np.int32)
    at = 0
    for s in range(N):
        fl_s = order[at:at + cnt[s]]
        at += cnt[s]
        flows_of[s, :len(fl_s)] = fl_s
        src[fl_s], slot_of[fl_s] = s, np.arange(len(fl_s))

    npk = rng.integers(1, 200, NF)
    size = i32(np.where(rng.random(NF) < 0.5, npk * mtu, npk * mtu - rng.integers(1, mtu, NF)))
    t_start = i32(np.where(rng.random(NF) < 0.9, rng.integers(0, t + 1, NF),
                           rng.integers(t + 1, t + 500, NF)))
    done = rng.random(NF) < 0.15
    goodput = i32(np.where(done, size, rng.integers(0, size + 1)))
    dep_par = i32(np.where(rng.random((NF, D)) < 0.7, rng.integers(0, NF, (NF, D)), NF))
    gp_par = np.append(goodput, 0)[dep_par]
    dep_thr = i32(np.where(dep_par == NF, 0, np.where(rng.random((NF, D)) < 0.8,
                                                      gp_par - rng.integers(0, 5000, (NF, D)),
                                                      gp_par + rng.integers(1, 5000, (NF, D)))))
    # the sent ring: states 0-2 with pending retransmissions (3) on a quarter
    # of the flows, sequence and send-tick planes noise; the write-off row NF
    # noise the phase leaves alone
    sent = i32(np.stack([rng.choice(np.array([0, 0, 1, 1, 2], np.int32), (NF + 1, W)),
                         rng.integers(0, 200, (NF + 1, W)),
                         t - rng.integers(0, 300, (NF + 1, W))]))
    retx = np.flatnonzero(rng.random(NF) < 0.25)
    sent[0, retx, rng.integers(0, W, len(retx))] = 3
    two = retx[rng.random(len(retx)) < 0.3]
    sent[0, two, rng.integers(0, W, len(two))] = 3
    next_seq = i32(np.minimum(rng.integers(0, 210, NF), npk + rng.integers(0, 3, NF)))
    busy = rng.random(NF) < 0.3                 # the new sequence's slot still held
    sent[0, np.arange(NF), next_seq % W] = np.where(busy, rng.integers(1, 3, NF), 0)
    unacked = f32(rng.integers(0, 40, NF) * mtu)
    cwnd = f32(np.where(rng.random(NF) < 0.85, unacked + rng.integers(1, 30, NF) * mtu,
                        unacked + rng.integers(0, mtu, NF)))
    credits = f32(np.where(rng.random(NF) < 0.5, rng.integers(0, 8, NF) * mtu,
                           rng.integers(0, mtu, NF)))
    spec_budget = f32(np.where(rng.random(NF) < 0.5, rng.integers(0, 80, NF) * mtu,
                               rng.integers(0, mtu, NF)))
    pacing_rate = f32(np.round(rng.uniform(0.0, 0.6 * mtu, NF), 2))
    pace_accum = f32(np.round(rng.uniform(0.0, 4.0 * mtu, NF), 2))
    rr_send = i32(rng.integers(0, FMAX, N))
    # the special flows, each on a row of its own picked by its cursor:
    # retransmissions on slot 0, on slot 40, and on two slots (the first
    # wins); then a row whose cursor sits past its last eligible slot (the
    # later slots done), so the pick wraps
    rows = [s for s in range(N) if cnt[s]][:3]
    rows += [s for s in range(N) if cnt[s] > 1 and s not in rows][:1]
    for k, s in enumerate(rows):
        col = int(rng.integers(0, min(cnt[s] - (k == 3), window)))
        f = flows_of[s, col]
        t_start[f], done[f] = rng.integers(0, t + 1), False
        goodput[f] = min(goodput[f], size[f] - 1)
        dep_par[f] = NF
        cwnd[f] = unacked[f] + 64 * mtu
        credits[f], spec_budget[f], pace_accum[f] = 8 * mtu, 80 * mtu, 4 * mtu
        sent[0, f] = np.where(sent[0, f] == 3, 1, sent[0, f])
        if k < 3:
            for j in ((0,), (min(40, W - 1),), (min(7, W - 2), W - 1))[k]:
                sent[0, f, j] = 3
                sent[1, f, j] = int(rng.integers(0, npk[f]))
            rr_send[s] = col
        else:                                   # a new sequence, its slot free
            next_seq[f] = min(next_seq[f], npk[f] - 1)
            sent[0, f, next_seq[f] % W] = 0
            done[flows_of[s, col + 1:cnt[s]]] = True
            rr_send[s] = col + 1
    goodput = i32(np.where(done, size, goodput))

    NE = NQ + N
    infl = i32(rng.integers(-3, 50, (L, NE, 7)))
    wire = int((t + 3) % L)
    fdn = rng.random(NF) < 0.3
    return dict(
        t=t, wire=wire,
        flags=dict(window=int(window), credit_based=credit_based, paced=paced,
                   lb_mode=int(lb_mode), mtu=mtu),
        src=src, t_start=t_start, size=size, dep_par=dep_par, dep_thr=dep_thr,
        flows_of=flows_of, slot_of=slot_of, flow_ids=i32(np.arange(NF)),
        node_ids=i32(np.arange(N)), f_down=fdn, f_dn_q=i32(rng.integers(0, NQ, NF)),
        f_up_base=i32(rng.integers(0, NQ - 16, NF)),
        f_up_cnt=i32(rng.choice([0, 1, 2, 4, 16], NF)),
        f_salt=rng.integers(0, 2**32, NF, dtype=np.int64),
        num_entropies=np.int32(rng.choice([256, 250])), bdp_pkts=np.int32(32),
        done=done, goodput=goodput, unacked=unacked, cwnd=cwnd, pacing_rate=pacing_rate,
        credits=credits, spec_budget=spec_budget, pace_accum=pace_accum, sent=sent,
        next_seq=next_seq, rr_send=rr_send,
        next_entropy=i32(rng.integers(0, 2000, NF)),
        cached_entropy=i32(rng.integers(0, 2000, NF)),
        explore_sent=i32(np.where(rng.random(NF) < 0.2, 256, rng.integers(0, 300, NF))),
        spray_ctr=i32(rng.integers(0, 10**6, NF)),
        plb_entropy=i32(rng.integers(0, 2**31 - 1, NF)),
        infl=infl, n_retx=np.int32(rng.integers(0, 10**5)),
    )


def sends_operands(case: dict, device):
    """``(t, wire, Flags, Operands)`` of a :func:`sends_case` on ``device``
    (fresh tensors: the phase updates them in place)."""
    import torch

    from repro_torch.kernels.sends import ref as R

    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    o = R.Operands(**{k: t(case[k]) for k in R.Operands._fields})
    return case["t"], case["wire"], R.Flags(**case["flags"]), o


# the fused departures phase: ((NQ, QE, NF, CAP, FKC), seed, flags).  A
# few ports; fault tables and flaps on a small fabric; perm_1024n_3t's
# shapes with no schedule (t past 2**14, where t * 131071 wraps i32) and
# with a four-column table and flaps; flaps alone and tables alone
DEPARTURES_CASES = (
    ((5, 3, 4, 4, 1), 1, {}),
    ((40, 24, 30, 8, 3), 2, dict(fk=3, flapped=True)),
    ((2304, 1280, 1024, 40, 1), 3, dict(big_t=True)),
    ((2304, 1280, 1024, 40, 4), 4, dict(fk=4, flapped=True, big_t=True)),
    ((300, 200, 128, 16, 1), 5, dict(flapped=True)),
    ((300, 200, 128, 16, 3), 6, dict(fk=2)),
)


def departures_case(NQ: int, QE: int, NF: int, CAP: int, FKC: int, seed: int, *,
                    fk: int = 0, flapped: bool = False, big_t: bool = False,
                    L: int = 9) -> dict:
    """Every operand of the fused departures phase (``kernels/departures``):
    ``NQ`` ports of ``CAP`` packets (``[QE, NQ)`` the edge ports, one a
    node), ``NF`` flows, a wire of ``L`` slots of ``NE = NQ + N`` rows.
    Ports hold 0, 1, ``CAP`` packets and between; heads sit at ``CAP - 1``
    (the head wraps); head-of-line flows past both ends of ``[0, NF)``;
    ECMP salts with bit 31 set, up-port counts of 0; the run's salt near
    ``2**31`` (the RED salt wraps) or negative; thresholds of the
    simulator's (``0.2 * CAP``, ``0.6 * CAP``) and odd ones; ``t`` past
    ``2**14`` where ``big_t``.
    Under ``fk`` the transition tables hold periods 0, 1 and k > 1 with
    times on either side of ``t - fault_start``; under ``flapped`` some
    ports flap, windows starting before and after ``t - fault_start``
    (``tr - fl_start < 0``), down and up, closed and open, and three busy
    ports sit on the window's and the cycle's boundaries."""
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    N = NQ - QE
    NE = NQ + N
    t = int(rng.integers(1 << 14, 1 << 27)) if big_t else int(rng.integers(0, 5000))
    fault_start = int(rng.integers(-50, 200))
    tr = t - fault_start
    q_size = i32(np.append(rng.choice([0, 0, 1, CAP, 2, CAP // 2 + 1, CAP - 1], NQ), 0))
    q_head = i32(np.append(np.where(rng.random(NQ) < 0.3, CAP - 1,
                                    rng.integers(0, CAP, NQ)), 0))
    q_fields = i32(rng.integers(-2**31, 2**31, (NQ + 1, CAP, 5), dtype=np.int64))
    q_fields[:, :, 0] = rng.integers(-3, NF + 3, (NQ + 1, CAP))
    q_fields[:, :, 1] = rng.integers(0, 1 << 20, (NQ + 1, CAP))
    q_fields[:, :, 3] = rng.integers(0, 2, (NQ + 1, CAP))
    q_fields[:, :, 4] = rng.integers(0, max(t, 1), (NQ + 1, CAP))
    q_fields[NQ] = 0                                        # the write-off row
    # routing: a subtree interval, a run-length down table and up ports
    lo = rng.integers(0, N, NQ)
    hi = lo + rng.integers(0, N + 1, NQ)
    up_cnt = rng.choice([0, 1, 2, 3, 8], NQ)
    q_salt = rng.integers(0, 1 << 32, NQ, dtype=np.int64)
    q_salt[::3] |= 1 << 31
    # faults: column 0 healthy from 0; later columns around tr, sorted
    ft_time = np.full((NQ, FKC), 1 << 30, np.int64)
    ft_period = np.ones((NQ, FKC), np.int64)
    ft_time[:, 0] = 0
    if fk:
        ev = np.sort(tr + rng.integers(-40, 40, (NQ, fk - 1)), axis=1)
        ft_time[:, 1:fk] = np.where(rng.random((NQ, fk - 1)) < 0.8, ev, 1 << 30)
        ft_time[:, 1:fk].sort(axis=1)
        ft_period[:, 1:fk] = rng.choice([0, 1, 2, 3, 5], (NQ, fk - 1))
    fl_cycle = np.zeros(NQ, np.int64)
    fl_start = np.zeros(NQ, np.int64)
    fl_end = np.zeros(NQ, np.int64)
    fl_up = np.zeros(NQ, np.int64)
    fl_period = np.zeros(NQ, np.int64)
    if flapped:
        f = rng.random(NQ) < 0.5
        fl_cycle[f] = rng.integers(2, 60, f.sum())
        fl_up[f] = rng.integers(0, fl_cycle[f] + 1)
        fl_start[f] = tr + rng.integers(-300, 60, f.sum())   # some start after tr
        fl_end[f] = np.where(rng.random(f.sum()) < 0.3, 1 << 30,
                             fl_start[f] + rng.integers(1, 400, f.sum()))
        fl_period[f] = rng.choice([0, 0, 2, 3], f.sum())
        # three busy ports on a boundary, each dead if it is in the window
        # and down: a window opening now, one closing now, a port going down
        b0, b1, b2 = np.flatnonzero(f)[:3]
        fl_start[b0], fl_up[b0] = tr, 0
        fl_start[b1], fl_end[b1], fl_up[b1] = tr - 7, tr, 0
        fl_start[b2], fl_end[b2] = tr - 50, 1 << 30
        fl_up[b2] = 50 % fl_cycle[b2]
        fl_period[[b0, b1, b2]] = 0
        q_size[[b0, b1, b2]] = 1
    return dict(
        t=t, lat=dict(core=int(rng.integers(1, L)), edge=int(rng.integers(1, L))),
        flags=dict(qe=QE, fk=fk, flapped=flapped),
        q_fields=q_fields, q_head=q_head, q_size=q_size,
        infl=i32(rng.integers(-3, 50, (L, NE, 7))),
        n_black=np.int32(rng.integers(0, 10**5)),
        kmin=np.float32(0.2 * CAP if seed % 2 else 5.2),
        kspan=np.float32(0.8 * CAP - 0.2 * CAP if seed % 2 else 15.6),
        salt=np.int32((2**31 - 1 - int(rng.integers(0, 0xECD)), -int(rng.integers(1, 999)),
                       int(rng.integers(1, 999)))[seed % 3]),
        qidx=np.arange(NQ, dtype=np.int32), dst=i32(rng.integers(0, N, NF)),
        q_lo=i32(lo), q_hi=i32(hi), q_dn_base=i32(rng.integers(0, NQ, NQ)),
        q_dn_stride=i32(rng.integers(1, 9, NQ)), q_up_base=i32(rng.integers(0, NQ, NQ)),
        q_up_cnt=i32(up_cnt), q_salt=q_salt, edge_q=np.arange(NQ) >= QE,
        ft_time=i32(ft_time), ft_period=i32(ft_period), fl_start=i32(fl_start),
        fl_end=i32(fl_end), fl_cycle=i32(fl_cycle), fl_up=i32(fl_up),
        fl_period=i32(fl_period), fault_start=np.int32(fault_start),
    )


def departures_operands(case: dict, device):
    """``(t, Lat, Flags, Operands)`` of a :func:`departures_case` on
    ``device`` (fresh tensors: the phase updates them in place)."""
    import torch

    from repro_torch.kernels.departures import ref as R

    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    o = R.Operands(**{k: t(case[k]) for k in R.Operands._fields})
    return case["t"], R.Lat(**case["lat"]), R.Flags(**case["flags"]), o


# lane batches of the fused phases: (kind, shape, seed, flags); each stacks
# three cases of one shape (seeds seed, seed + 1, seed + 2) at their own
# ticks, the middle lane not live
LANES_CASES = (
    ("departures", DEPARTURES_CASES[1][0], 21, DEPARTURES_CASES[1][2]),
    ("departures", DEPARTURES_CASES[4][0], 22, DEPARTURES_CASES[4][2]),
    ("arrivals", ARRIVALS_CASES[2][0], 23, ARRIVALS_CASES[2][2]),
    ("arrivals", ARRIVALS_CASES[3][0], 24, ARRIVALS_CASES[3][2]),
    ("control", (16, 4, 64, 2, 8), 25, {}),
    ("control", (40, 8, 96, 3, 12), 26, dict(credit_based=True, rto_backoff_max=3)),
    ("sends", SENDS_CASES[2][0], 27, SENDS_CASES[2][2]),
    ("sends", SENDS_CASES[3][0], 28, SENDS_CASES[3][2]),
)


def lanes_case(kind: str, shape: tuple, seed: int, *, n: int = 3, idle: int = 1,
               **flags) -> dict:
    """``n`` cases of one fused phase (``kind``: ``"departures"``,
    ``"arrivals"``, ``"control"`` or ``"sends"``; ``shape`` its generator's
    shape arguments) with the seeds ``seed, seed + 1, ...``, as one lane
    batch: each lane at its own tick, lane ``idle`` not live.  The batch's
    delays (the departures' wire latencies, the arrivals' ACK and trim
    delays) are lane 0's."""
    gen = dict(departures=departures_case, arrivals=arrivals_case,
               control=control_case, sends=sends_case)[kind]
    return dict(kind=kind, cases=[gen(*shape, seed + i, **flags) for i in range(n)],
                live=[i != idle for i in range(n)])


def lanes_operands(case: dict, device) -> dict:
    """A :func:`lanes_case` on ``device`` (fresh tensors): ``tick`` (the
    batch's ``kernels.lanes.Tick``), ``flags``, ``o`` (the phase's
    Operands, every tensor ``[n, ...]``), the phase's delay argument
    (``lat``, ``trim_delay`` with ``gbin``, or ``lat_send``), and per lane
    the single-lane arguments of its plain version (``one``: ``(t, ...,
    Flags)`` at the batch's delays)."""
    import torch

    from repro_torch.kernels import lanes
    from repro_torch.netsim.state import tree_map

    kind, cases = case["kind"], case["cases"]
    make = dict(departures=departures_operands, arrivals=arrivals_operands,
                control=control_operands, sends=sends_operands)[kind]
    per = [make(c, device) for c in cases]
    o = tree_map(lambda *xs: None if xs[0] is None else torch.stack(xs),
                 *[p[-1] for p in per])
    ts = [p[0] for p in per]
    live = case["live"]
    out = dict(tick=lanes.Tick(torch.tensor(ts, dtype=torch.int32, device=device),
                               torch.tensor(live, device=device), tuple(ts), tuple(live)),
               o=o)
    if kind == "departures":
        lat, fl = per[0][1], per[0][2]
        out.update(lat=lat, flags=fl, one=[(t, lat, fl) for t in ts])
    elif kind == "arrivals":
        from repro_torch.kernels.arrivals import ref as AR
        fl = per[0][2]
        l, r = cases[0]["infl"].shape[0], cases[0]["ack_ring"].shape[0]
        trim_delay = (per[0][1].trim - ts[0]) % r
        gb = [p[2].goodput_bin for p in per]
        out.update(flags=fl, trim_delay=trim_delay,
                   gbin=torch.tensor(gb, dtype=torch.int32, device=device),
                   one=[(t, AR.slots(t, l, r, fl.ret, trim_delay),
                         fl._replace(goodput_bin=g)) for t, g in zip(ts, gb)])
    elif kind == "control":
        fl = per[0][1]
        out.update(flags=fl, one=[(t, fl) for t in ts])
    else:
        fl, l = per[0][2], cases[0]["infl"].shape[0]
        lat_send = (per[0][1] - ts[0]) % l
        out.update(flags=fl, lat_send=lat_send,
                   one=[(t, (t + lat_send) % l, fl) for t in ts])
    return out
