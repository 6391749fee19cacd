"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload perm1024.sweep256 --seed 7 --seconds 51 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``src/repro_torch``).  The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; last ``checks``, each
number compared beside its limit, which are also the last lines of
standard error).  Without a CUDA card, with fewer cards than the cell
asks for, without the program, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits with another code
than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.chdir(ROOT)
    from portbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, _ = harness.cell_of(bench, a.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; the benchmark runs on a card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {a.workload} asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program (src/repro_torch) is not in this checkout: {e}",
              file=sys.stderr)
        return 4
    out = harness.run_cell(bench, a.workload, a.seed, a.seconds, bool(a.trace),
                           t_start=T_START)
    return finish(out)


def finish(out: dict) -> int:
    """Print the result of a run, as the last step: unless JAX or the JAX
    package has been loaded in this process by then (by the program, the
    reference or a metric's reader), which prints no result and exits 5."""
    from portbench import harness

    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 5
    print(harness.checks_text(out["checks"]), file=sys.stderr)
    sys.stdout.flush()
    print(harness.result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
