"""Seeded kernel inputs, as numpy, for checking each kernel.

The CPU tests hand the same arrays to the reference's plain versions and
to this package's; ``chip_smoke.py`` hands them to each CUDA kernel and
its plain version on the card.  Every generator takes the shape and a
seed and returns plain numpy arrays (i32 / f32 / bool), with values
chosen so that every branch of the kernel is taken: ACKs that match and
miss their slot, trims, timeouts that fire, spurious retransmissions,
QuickAdapt and FastIncrease, same-destination ranks past the free space,
rows with nothing eligible.
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
