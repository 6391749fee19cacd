"""Permutation study on the PyTorch/CUDA port: FCT distribution across
transports and load balancers under core oversubscription (paper Fig.
1/6/11 interactively), plus a tuning Study — {initial window x seeds}.

  PYTHONPATH=src python examples/torch_permutation_study.py [--oversub 4]
      [--seeds 3] [--device cpu]

The same program as ``examples/permutation_study.py`` on
``repro_torch.netsim.api``.  It runs on the card unless ``--device cpu``
asks for the CPU.  The port's study runs its lanes as one batch (one
launch of each fused tick kernel a batched tick), each lane equal to the
standalone run of its (point, seed).
"""

import argparse

import numpy as np

from repro_torch.netsim import api, workloads
from repro_torch.netsim.scenarios import Scenario
from repro_torch.netsim.state import SimConfig
from repro_torch.netsim.units import FatTreeConfig, LinkConfig


def cdf_sketch(fct, width=40):
    """ASCII CDF of flow completion times."""
    f = np.sort(fct)
    lo, hi = f[0], f[-1]
    rows = []
    for q in (0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0):
        v = f[min(int(q * len(f)), len(f) - 1)]
        bar = "#" * int(width * (v - lo) / max(hi - lo, 1))
        rows.append(f"   p{int(q*100):3d} {v:7.0f} |{bar}")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--oversub", type=int, default=4, choices=(2, 4, 8))
    ap.add_argument("--size-kib", type=int, default=1024)
    ap.add_argument("--seeds", type=int, default=3,
                    help="decorrelation seeds for the tuning study")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    link = LinkConfig()
    per_rack = 16
    tree = FatTreeConfig(racks=4, nodes_per_rack=per_rack,
                         uplinks=per_rack // args.oversub)
    wl = workloads.permutation(tree, size_bytes=args.size_kib * 1024, seed=1)
    base = Scenario(name=f"perm_{args.oversub}to1",
                    cfg=SimConfig(link=link, tree=tree),
                    wl=wl, max_ticks=200_000)
    pkts = args.size_kib * 1024 // 4096
    ideal = pkts * args.oversub + 26
    print(f"{tree.n_nodes}-node permutation, {args.oversub}:1 "
          f"oversubscribed, {args.size_kib} KiB flows "
          f"(ideal ~{ideal} ticks) on {args.device}\n")

    # one api.run per (algo, lb) — those change Dims, so each is a build
    for algo, lb in (("smartt", "reps"), ("smartt", "spray"),
                     ("smartt", "ecmp"), ("swift", "reps"),
                     ("eqds", "reps")):
        r = api.run(base, algo=algo, lb=lb, device=args.device)
        print(f"== {algo}+{lb}: completion {r.completion} "
              f"({r.completion / ideal:.2f}x ideal), jain {r.jain:.3f}, "
              f"trims {r.trims}")
        print(cdf_sketch(r.fct_done))
        print()

    # the tuning grid x seed batch: point-major lanes
    points = [{"start_cwnd_mult": a} for a in (0.5, 1.0, 1.25)]
    seeds = range(args.seeds)
    res = api.study(base, points=points, seeds=seeds, device=args.device).run()
    print(f"tuning study: {len(points)} points x {res.n_seeds} seeds "
          f"= {len(res)} lanes ({res.wall_s:.1f}s)")
    print(f"{'start_cwnd_mult':>16s} {'completion (mean/max over seeds)':>34s}"
          f" {'jain (min)':>11s}")
    for pi, pt in enumerate(points):
        lanes = res.by_point(pi)
        comp = [r.completion for r in lanes]
        print(f"{pt['start_cwnd_mult']:16.2f} "
              f"{np.mean(comp):17.0f}/{max(comp):<16d} "
              f"{min(r.jain for r in lanes):11.3f}")
    best = res.best("completion")
    print(f"\nbest lane: {best.name} -> completion {best.completion} "
          f"({best.completion / ideal:.2f}x ideal)")


if __name__ == "__main__":
    main()
