"""Transport-aware collective estimation on the PyTorch/CUDA port: replay
a training step's collective traffic through the SMaRTT simulator and
compare transports.

  PYTHONPATH=src python examples/torch_collective_estimate.py [--device cpu]

The same program as ``examples/collective_estimate.py`` on
``repro_torch.collectives.bridge``: a cross-pod gradient all-reduce (a
ring permutation) and a MoE expert-parallel all-to-all (windowed), each
under SMaRTT, Swift and EQDS.  It runs on the card unless ``--device
cpu`` asks for the CPU; both give the same numbers.
"""

import argparse

from repro_torch.collectives.bridge import estimate

CASES = [
    # (collective, bytes each device contributes) — representative of the
    # jamba-398b cross-pod gradient exchange and a dbrx EP dispatch
    ("all-reduce", 8 << 20),
    ("all-to-all", 4 << 20),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    print(f"{'collective':12s} {'transport':12s} {'eff':>6s} {'straggle':>9s} "
          f"{'trims':>6s} {'fair':>6s}")
    for kind, nbytes in CASES:
        for algo in ("smartt", "swift", "eqds"):
            e = estimate(kind, nbytes, algo=algo, nodes=32, oversub=4, device=args.device)
            print(f"{kind:12s} {algo:12s} {e.efficiency:6.2f} "
                  f"{e.straggler_spread:9.3f} {e.trims:6d} {e.fairness:6.3f}")
    print("\nefficiency = ideal-bottleneck-time / achieved completion; the "
          "roofline collective term divides by this factor per transport.")


if __name__ == "__main__":
    main()
