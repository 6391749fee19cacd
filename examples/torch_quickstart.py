"""Quickstart on the PyTorch/CUDA port: simulate an 8:1 incast under
SMaRTT and its baselines via the port's experiment API, and print the
congestion-control story.

  PYTHONPATH=src python examples/torch_quickstart.py [--quick] [--device cpu]

The same program as ``examples/quickstart.py`` on
``repro_torch.netsim.api``: one ``api.run(scenario(name, algo=...))`` per
algorithm returns a typed ``RunResult`` — FCTs, Jain fairness, slowdowns
vs the uncongested ideal, trim/retransmit counters.  It runs on the card
unless ``--device cpu`` asks for the CPU (the kernels' plain versions).
"""

import argparse

from repro_torch.netsim.api import run
from repro_torch.netsim.scenarios import scenario
from repro_torch.netsim.units import ticks_to_us


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller fabric/flows (CI smoke)")
    ap.add_argument("--scenario", default=None, metavar="NAME",
                    help="registered scenario to run instead of the "
                         "default incast (e.g. tiny_3t for a three-tier "
                         "smoke)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    # registered scenarios are string-addressable; per-call overrides
    # (algo=, lb=, max_ticks=...) fork the frozen base Scenario
    name = args.scenario or ("incast8_16n" if args.quick else "incast8_32n")
    base = scenario(name)
    degree = base.wl.n_flows
    pkts = int(base.wl.size[0]) // base.cfg.link.mtu_bytes

    tree = base.cfg.tree
    print(f"{degree} flows of {int(base.wl.size[0]) // 1024} KiB "
          f"({tree.n_nodes} nodes, {tree.tiers}-tier) — scenario {name!r} "
          f"on {args.device}")
    print(f"{'algo':12s} {'FCT max':>9s} {'slowdown':>9s} {'fairness':>9s} "
          f"{'trims':>6s} {'completion':>12s}")
    for algo in ("smartt", "swift", "mprdma", "eqds"):
        r = run(base, algo=algo, device=args.device)
        assert r.all_done, f"{algo}: {r.n_done}/{r.n_flows} finished"
        print(f"{algo:12s} {r.completion:9d} {r.slowdown_p99:9.3f} "
              f"{r.jain:9.3f} {r.trims:6d} "
              f"{ticks_to_us(r.completion, base.cfg.link):9.1f}us")

    print(f"\n(ideal uncongested flow: {pkts} packets + 1 RTT; slowdown "
          f"is FCT p99 vs that bound)")
    print("SMaRTT's QuickAdapt collapses the initial burst within one "
          "target-RTT;\nsee examples/torch_permutation_study.py for a "
          "{point x seed} grid (api.study).")


if __name__ == "__main__":
    main()
