"""Flow tables from a traffic mix's parameters and a seed.

One general generator (:func:`flows`) reads a mix's ``"traffic"`` entry:
its ``"kind"`` names one of the paper's patterns (SMaRTT, arXiv
2404.01630, Sec. 4: permutation, incast, windowed all-to-all) and its
other keys are that pattern's parameters.  The patterns are the program's
own generators (``netsim/workloads.py``), copied, with the seed drawing
only what the fabric's symmetry makes equivalent: which pod or rack a
permutation shifts by, which node receives an incast, where the
all-to-all's participants sit and in what order.  So every seed gives the
same sizes, start ticks and path classes, in another arrangement, and
the work a run does does not depend on its seed.

The table is a dict of numpy arrays (``src``, ``dst``, ``size``,
``t_start``, ``order``, each ``[F]`` int32) and ``window``; the harness
hands the same table to the program and to the reference.
"""

from __future__ import annotations

import numpy as np


def _tree(fabric: dict) -> tuple:
    racks, m = int(fabric["racks"]), int(fabric["nodes_per_rack"])
    pods = int(fabric.get("pods", 0)) or 1
    return racks, m, pods, racks // pods


def permutation(fabric: dict, rng, *, size_bytes: int, cross: str = "pod") -> dict:
    """Node ``i`` sends one flow to node ``i + shift``.  ``cross="pod"``:
    the shift is a whole number of racks that takes every rack to a rack
    of another pod, so every flow crosses the core (the paper's "each
    packet crosses the core switches"); ``cross="rack"``: any shift of
    whole racks, so every flow leaves its rack."""
    racks, m, pods, rpp = _tree(fabric)
    n = racks * m
    if cross == "pod":
        if pods < 2:
            raise ValueError("cross='pod' needs a three-tier fabric of two pods or more")
        # p whole pods and r racks more: every rack lands in another pod
        # while p + 1 < pods; p = pods - 1 only without the extra racks
        p = int(rng.integers(1, pods))
        r = int(rng.integers(0, rpp)) if p < pods - 1 else 0
        shift = m * (rpp * p + r)
    elif cross == "rack":
        shift = m * (1 + int(rng.integers(0, racks - 1)))
    else:
        raise ValueError(f"cross: 'pod' or 'rack', not {cross!r}")
    src = np.arange(n, dtype=np.int32)
    dst = ((src.astype(np.int64) + shift) % n).astype(np.int32)
    return _table(src, dst, size_bytes)


def incast(fabric: dict, rng, *, degree: int, size_bytes: int) -> dict:
    """``degree`` senders onto one receiver, the senders spread round-robin
    over every rack (so the fan-in crosses pods and the core); the
    receiver is drawn from the seed, and the senders' order."""
    racks, m, _, _ = _tree(fabric)
    n = racks * m
    if degree > n - 1:
        raise ValueError("incast degree exceeds node count")
    receiver = int(rng.integers(0, n))
    node = np.arange(n)
    spread = np.argsort((node % m) * racks + node // m, kind="stable")
    src = spread[spread != receiver][:degree].astype(np.int32)
    rng.shuffle(src)
    return _table(src, np.full(degree, receiver, np.int32), size_bytes)


def alltoall(fabric: dict, rng, *, nodes: int, size_bytes: int, window: int) -> dict:
    """Windowed all-to-all among ``nodes`` participants strided evenly over
    the fabric (paper Sec. 4.5): participant ``s`` sends its flow of round
    ``j`` to participant ``s + j``, at most ``window`` unfinished at once.
    The seed draws the participants' offset within a stride and their
    order around the schedule."""
    racks, m, _, _ = _tree(fabric)
    stride = racks * m // nodes
    ids = (int(rng.integers(0, stride)) + stride * rng.permutation(nodes)).astype(np.int32)
    srcs, dsts, orders = [], [], []
    for s in range(nodes):
        for j in range(1, nodes):
            srcs.append(ids[s])
            dsts.append(ids[(s + j) % nodes])
            orders.append(j - 1)
    out = _table(np.array(srcs, np.int32), np.array(dsts, np.int32), size_bytes)
    out.update(order=np.array(orders, np.int32), window=int(window))
    return out


def _table(src, dst, size_bytes: int) -> dict:
    f = src.shape[0]
    return dict(src=src, dst=dst, size=np.full(f, int(size_bytes), np.int32),
                t_start=np.zeros(f, np.int32), order=np.zeros(f, np.int32),
                window=1 << 30)


KINDS = {"permutation": permutation, "incast": incast, "alltoall": alltoall}


def flows(fabric: dict, traffic: dict, seed: int) -> dict:
    """The flow table of a mix's ``traffic`` entry on ``fabric`` for
    ``seed`` (any whole number)."""
    params = {k: v for k, v in traffic.items() if k != "kind"}
    kind = traffic["kind"]
    if kind not in KINDS:
        raise KeyError(f"traffic kind {kind!r}; have {sorted(KINDS)}")
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x7F10])
    return KINDS[kind](fabric, rng, **params)


def salts(seed: int, study: int, n: int) -> list:
    """The hash salts of study ``study``'s ``n`` seeds (the lanes' per-run
    decorrelation), drawn from the run's seed: 31-bit, so they fit the
    program's int32 salt."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x5A17, int(study) + 1])
    return rng.integers(0, 2**31, n).tolist()
