"""The benchmark's control: the plain reference computed one precision
below the configuration's (its float32 congestion state rounded to
bfloat16 after each control phase), put in the program's place and held
to the float32 reference by the numbers a run compares.

    python3 portbench/control.py --workload perm1024.sweep256 --seeds 11,12,13 [--lanes 3]

For each seed it makes the cell's flow table, draws ``--lanes`` lanes (a
sweep point and a salt each, the points taken in turn from one drawn from
the seed), runs each through both references on the CPU, and prints one
JSON line per seed with ``lanes_off`` and ``fct_gap_ticks`` (the upper
readings of those numbers' limits) and ``unfinished_lanes`` of the
control's lanes.  A run compares one lane a point (``harness.COMPARE_PER_POINT``);
the default here is the same number.  The benchmark's own runs never run
it.  It needs no card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_jobs(bench: dict, name: str, seed: int, lanes: int | None = None) -> list:
    """The lanes of one seed, each as the reference's job at the
    configuration's precision and at the control's."""
    import numpy as np

    from portbench import harness
    from portbench.gen import traffic

    cell, conf = harness.cell_of(bench, name)
    config = harness.load_json(ROOT / conf["file"])
    mix = harness.load_json(harness.HERE / "mixes" / f"{cell['traffic']}.json")
    table = traffic.flows(config["fabric"], mix["traffic"], seed)
    points, per = harness.points_of(mix), int(mix["seeds_per_study"])
    rng = np.random.default_rng([seed, 0xC0])
    n = lanes or harness.COMPARE_PER_POINT * len(points)
    first = int(rng.integers(0, len(points)))
    out = []
    for j in range(n):
        point = points[(first + j) % len(points)]
        salt = traffic.salts(seed, j, per)[int(rng.integers(0, per))]
        for precision in (None, "bfloat16"):
            out.append((config, table, name, point, salt, precision))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=None,
                    help="lanes a seed (default: as many as a run compares)")
    a = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    from portbench import harness
    from portbench.reference import check

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    seeds = [int(s) for s in a.seeds.split(",")]
    jobs = {s: control_jobs(bench, a.workload, s, a.lanes) for s in seeds}
    flat = [j for s in seeds for j in jobs[s]]
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=a.workers, mp_context=ctx) as pool:
        done = list(pool.map(check.reference_lane, flat))
    it = iter(done)
    for s in seeds:
        off, gap, unfinished = 0, 0, 0
        for _ in range(len(jobs[s]) // 2):
            (ref_st, ref_row), (ctl_st, ctl_row) = next(it), next(it)
            o, g = check.lane_gap(ctl_st, ctl_row, ref_st, ref_row)
            off, gap = off + o, max(gap, g)
            unfinished += int(not ctl_row["all_done"])
        print(json.dumps(dict(workload=a.workload, seed=s, lanes=len(jobs[s]) // 2,
                              lanes_off=off, fct_gap_ticks=gap, unfinished_lanes=unfinished)))
    print(f"control: {len(flat)} reference lanes in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
