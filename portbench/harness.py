"""The benchmark of the PyTorch/CUDA port's simulator (``src/repro_torch``):
one cell of ``BENCHMARK.json``, run once.

A cell names a configuration (``configs/<name>.json``: the fabric, the
link, the transport, the tick budget) and a traffic mix
(``mixes/<traffic>.json``: the flow pattern and its parameters, the sweep
points, the seeds a study).  A run makes the flow table from its seed
(``gen/traffic.py``), hands it to the program as a ``Workload``, and then

1. set-up: imports, the CUDA context, the kernels' build (cached in the
   checkout's ``build/repro_torch/``) and one warm-up study of the cell's
   own grid;
2. the window: studies one after another, each planned anew as a user
   plans one, ``api.study(scenario, points, seeds_k)`` then ``.run()``,
   the lane salts ``seeds_k`` drawn from the seed and the study's index;
   a study that starts before ``--seconds`` have passed runs to its end;
3. with ``--trace 1``, one more study of the same grid under
   ``torch.profiler`` (device activity only);
4. the check: every lane of the window finished every flow with every
   byte delivered, and lanes sampled from the seed (the longest of the
   window among them) equal, leaf for leaf and row for row, the plain
   reference's run of the same point and salt (``reference/``), run on
   the CPU once the window has closed and the program's state is freed.

End-to-end and per-layer metrics are read by one small reader each
(``metrics/<name>.py``, ``read(run) -> float | None``), found by the
names ``BENCHMARK.json`` gives; a reader that finds nothing returns None
and the metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from portbench.gen import traffic
from portbench.reference import check

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# lanes of each sweep point a run compares with the reference (the
# window's longest lane among them)
COMPARE_PER_POINT = 1


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    config: dict
    mix: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    studies: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    trace: dict | None = None
    shapes: dict | None = None


# --------------------------------------------------------------------------
# finding the pieces by name
# --------------------------------------------------------------------------


def log(msg: str) -> None:
    print(f"[portbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> tuple:
    """``(cell, configuration entry)`` of the workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    return cell, confs[cell["config"]]


def metrics_of(bench: dict, cell: str, group: str) -> list:
    """The ``group`` (``end_to_end`` or ``per_layer``) metrics a cell
    reports: those without a ``workloads`` list, and those that list it."""
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]


def reader(name: str, where: Path = HERE / "metrics"):
    """The ``read`` function of the metric ``name`` (``metrics/<name>.py``)."""
    path = where / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------------------
# the program's inputs
# --------------------------------------------------------------------------


def program_scenario(name: str, config: dict, table: dict):
    """The program's ``Scenario`` of a configuration and a flow table."""
    from repro_torch.netsim import scenarios, state, units, workloads
    cfg = state.SimConfig(link=units.LinkConfig(**config["link"]),
                          tree=units.FatTreeConfig(**config["fabric"]), **config["transport"])
    wl = workloads.Workload(name=name, src=table["src"], dst=table["dst"], size=table["size"],
                            t_start=table["t_start"], order=table["order"],
                            window=table["window"])
    return scenarios.Scenario(name=name, cfg=cfg, wl=wl, max_ticks=int(config["max_ticks"]))


def points_of(mix: dict) -> list:
    return [dict(p) for p in mix["points"]]


# --------------------------------------------------------------------------
# one run
# --------------------------------------------------------------------------


class Window:
    """The studies of the window and the lanes kept for the check: one
    lane of each sweep point, drawn from the seed uniformly over the
    window's lanes of that point, and the window's longest lane."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([seed & (2**64 - 1), 0xC4EC])
        self.kept = {}          # point index -> (lane copy, studies seen)
        self.longest = None     # (point index, lane copy) with the most ticks
        self.unfinished = 0
        self.lanes = 0

    def keep(self, plan, res, table) -> None:
        """Count the study's unfinished lanes, and keep a copy of the lanes
        drawn for the check (reservoir sampling over the window's studies:
        a study replaces a point's kept lane with chance one in the number
        of studies seen)."""
        st = res.states
        ok = np.all(st.done, axis=1) & np.all(st.goodput == table["size"][None, :], axis=1)
        self.unfinished += int((~ok).sum())
        self.lanes += len(ok)
        per = plan.n_lanes // len(plan.points)
        for p in range(len(plan.points)):
            lane = p * per + int(self.rng.integers(0, per))
            seen = self.kept.get(p, (None, 0))[1] + 1
            if self.rng.integers(0, seen) == 0:
                self.kept[p] = (_lane_copy(plan, res, lane), seen)
            else:
                self.kept[p] = (self.kept[p][0], seen)
        long = int(np.argmax(st.now))
        if self.longest is None or int(st.now[long]) > self.longest[1]["ticks"]:
            self.longest = (long // per, _lane_copy(plan, res, long))

    def sample(self) -> list:
        """The lanes to check: one a sweep point (``COMPARE_PER_POINT``),
        the longest lane in place of its point's drawn one."""
        out = {p: k for p, (k, _) in self.kept.items()}
        if self.longest is not None:
            out[self.longest[0]] = self.longest[1]
        return [out[p] for p in sorted(out)]


def _lane_copy(plan, res, lane: int) -> dict:
    r = res[lane]
    pt, salt = plan.lane_point_seed(lane)
    return dict(point=dict(pt), salt=int(salt), row=r.row(), ticks=int(r.ticks),
                state=_np_tree(r.state))


def _np_tree(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_np_tree(x) for x in tree))
    return np.array(tree, copy=True)


def _sync(torch, device) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def one_study(api, sc, points, salts, device, torch):
    """Plan and run one study; ``(plan, result, plan_s, run_s)`` by the
    host's clock, the card synchronized before each reading."""
    _sync(torch, device)
    t0 = time.perf_counter()
    plan = api.study(sc, points=points, seeds=salts, device=device)
    _sync(torch, device)
    t1 = time.perf_counter()
    res = plan.run()
    _sync(torch, device)
    return plan, res, t1 - t0, time.perf_counter() - t1


def study_record(plan, res, plan_s: float, run_s: float) -> dict:
    lanes = plan.sim.stats["lanes"]
    return dict(lanes=plan.n_lanes, plan_s=plan_s, run_s=run_s, wall_s=res.wall_s,
                batch_ticks=int(lanes["batch_ticks"]), steps=list(lanes["steps"]),
                ticks=list(lanes["ticks"]), leaps=list(lanes["leaps"]))


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None, mixes: Path = HERE / "mixes",
             ref_workers: int | None = None, metrics_dir: Path = HERE / "metrics") -> dict:
    """Run the cell ``name`` once; returns the result line as a dict
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with a
    trace ``breakdown``, then ``checks``).  ``metrics_dir`` holds the
    metric readers."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    torch.set_num_threads(1)
    from repro_torch.netsim import api

    log(f"{name}: imports {time.perf_counter() - t_start:.2f} s")

    cell, conf = cell_of(bench, name)
    config = load_json(ROOT / conf["file"])
    mix = load_json(mixes / f"{cell['traffic']}.json")
    run = Run(config=config, mix=mix)
    table = traffic.flows(config["fabric"], mix["traffic"], seed)
    sc = program_scenario(name, config, table)
    points, per = points_of(mix), int(mix["seeds_per_study"])

    # set-up: the CUDA context, the kernels' build and one warm-up study
    one_study(api, sc, points, traffic.salts(seed, -1, per), device, torch)
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start
    log(f"{name}: set-up {run.setup_s:.2f} s")

    # the window
    win = Window(seed)
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        plan, res, plan_s, run_s = one_study(api, sc, points, traffic.salts(seed, k, per),
                                             device, torch)
        run.studies.append(study_record(plan, res, plan_s, run_s))
        win.keep(plan, res, table)
        del plan, res
        k += 1
    run.window_s = time.perf_counter() - t0
    log(f"{name}: window {run.window_s:.2f} s, {k} studies, walls "
        f"{[round(s['plan_s'] + s['run_s'], 3) for s in run.studies]}, batched ticks "
        f"{[s['batch_ticks'] for s in run.studies]}")
    if device.startswith("cuda"):
        run.peak_bytes = int(torch.cuda.max_memory_allocated())

    if trace:
        run.trace, plan, res = traced_study(api, sc, points, traffic.salts(seed, k, per), torch)
        win.keep(plan, res, table)
        del plan, res
        run.shapes = shapes_of(config, table, mix)
        log(f"{name}: traced study {run.trace['window_s']:.2f} s, "
            f"{len(run.trace['ops'])} device operations")

    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    checks = compare(win, config, table, name, ref_workers)

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, name, group):
        v = reader(m["name"], metrics_dir)(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = device_info(torch, device, run)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = dict(correct=bool(correct), attempted=win.lanes, failed=win.unfinished,
               metrics=metrics, device=dev)
    if trace and run.trace is not None:
        out["breakdown"] = run.trace["breakdown"]
    out["checks"] = checks
    return out


def device_info(torch, device: str, run: Run) -> dict:
    if device.startswith("cuda"):
        dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
                   memory_peak_bytes=run.peak_bytes)
    else:
        dev = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    if run.trace is not None:
        dev.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
    return dev


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (the part before the first dot, compared whole)."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


# --------------------------------------------------------------------------
# the traced study
# --------------------------------------------------------------------------


def traced_study(api, sc, points, salts, torch) -> tuple:
    """One study of the cell's grid under torch.profiler (device activity
    only): ``(record, plan, result)``, the record with every device
    operation's name, start and length, the traced window's length, the
    study's counts and its lanes' rows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plan, res, plan_s, run_s = one_study(api, sc, points, salts, "cuda", torch)
        window_s = time.perf_counter() - t0
    ops = [(e.name(), int(e.start_ns()), int(e.duration_ns()))
           for e in prof.profiler.kineto_results.events() if e.device_type().name == "CUDA"]
    rec = study_record(plan, res, plan_s, run_s)
    size = np.asarray(plan.scenario.wl.size, np.int64)
    mtu = plan.sim.dims.mtu
    packets = int((-(-size // mtu)).sum())
    rows = [dict(acks=r.acks, timeouts=r.timeouts, retx=r.retx, packets=packets)
            for r in res.results]
    return dict(ops=ops, window_s=window_s, busy_s=busy_seconds(ops), study=rec,
                rows=rows, breakdown=breakdown(ops)), plan, res


def busy_seconds(ops) -> float:
    """Length of the union of the device operations' intervals."""
    busy, end = 0, None
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        e = s + d
        if end is None or s >= end:
            busy += d
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9


def short(name: str) -> str:
    """A device operation's name without its argument list."""
    head = name.split("(", 1)[0].strip()
    return head[:80] or name[:80]


def breakdown(ops) -> dict:
    """The ten device operations that took most time, and the ten longest
    kinds of idle gap, each named by the operations on either side."""
    by_op = {}
    for n, _, d in ops:
        k = short(n)
        by_op[k] = by_op.get(k, 0) + d
    gaps = {}
    seq = sorted(ops, key=lambda o: o[1])
    end, prev = None, "window start"
    for n, s, d in seq:
        if end is not None and s > end:
            k = f"{prev} -> {short(n)}"
            gaps[k] = gaps.get(k, 0) + (s - end)
        if end is None or s + d > end:
            end, prev = s + d, short(n)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[k, v / 1e9] for k, v in top],
                idle_gaps=[[k, v / 1e9] for k, v in top_gaps])


def shapes_of(config: dict, table: dict, mix: dict) -> dict:
    """The shapes the rooflines count, derived by the reference (not read
    from the program)."""
    from portbench.reference import engine, state, workloads
    cfg = engine.apply_point(check.sim_config(config), points_of(mix)[0])
    wl = workloads.Workload(name="shapes", src=table["src"], dst=table["dst"],
                            size=table["size"], t_start=table["t_start"], order=table["order"],
                            window=table["window"])
    _, _, d, _ = state.derive(cfg, wl)
    return dict(N=d.N, NQ=d.NQ, NF=d.NF, W=d.W, WW=d.WW, FMAX=d.FMAX, D=d.D, mtu=d.mtu,
                trimming=d.trimming, credit_based=d.credit_based,
                rto_backoff_max=d.rto_backoff_max)


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------


def compare(win: Window, config: dict, table: dict, name: str, workers: int | None) -> dict:
    """The numbers ``correct`` is decided by, each beside its limit."""
    t0 = time.perf_counter()
    lanes = win.sample()
    jobs = [(config, table, name, k["point"], k["salt"], None) for k in lanes]
    if workers == 0:
        refs = [check.reference_lane(j) for j in jobs]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers or len(jobs), mp_context=ctx) as pool:
            refs = list(pool.map(check.reference_lane, jobs))
    log(f"{name}: reference, {len(jobs)} lanes in {time.perf_counter() - t0:.2f} s")
    off, gap = 0, 0
    for k, (st, row) in zip(lanes, refs):
        o, g = check.lane_gap(k["state"], k["row"], st, row)
        off += o
        gap = max(gap, g)
    return dict(unfinished_lanes=dict(value=win.unfinished, limit=0),
                lanes_off=dict(value=off, limit=0),
                fct_gap_ticks=dict(value=gap, limit=0))


def result_line(out: dict) -> str:
    return json.dumps({k: v for k, v in out.items() if not k.startswith("_")})


def checks_text(checks: dict) -> str:
    return "\n".join(f"check {k} = {v['value']} (limit {v['limit']})" for k, v in checks.items())
