"""The reference's side of the check: one lane run by the plain reference
from the same inputs the program was given, and the gap between the
program's lane and it."""

from __future__ import annotations

import numpy as np

from . import engine, result, state, units, workloads


def sim_config(config: dict) -> state.SimConfig:
    """The reference's ``SimConfig`` of a configuration file's fabric,
    link and transport."""
    return state.SimConfig(link=units.LinkConfig(**config["link"]),
                           tree=units.FatTreeConfig(**config["fabric"]),
                           **config["transport"])


def reference_lane(job: tuple) -> tuple:
    """``(final state, row)`` of one lane: ``job`` is ``(configuration,
    flow table, scenario name, sweep point, salt, precision)``, the
    precision ``None`` (the configuration's) or ``"bfloat16"`` (the
    control)."""
    config, table, name, point, salt, precision = job
    wl = workloads.Workload(name=name, src=table["src"], dst=table["dst"], size=table["size"],
                            t_start=table["t_start"], order=table["order"],
                            window=table["window"])
    max_ticks = int(config["max_ticks"])
    st, sim = engine.run_lane(sim_config(config), wl, point, salt, max_ticks, precision)
    return st, result.row(sim, st, scenario=name, point=point, seed=salt, max_ticks=max_ticks)


def leaves(tree, path: str = "") -> list:
    """``(name, array)`` of every leaf of a NamedTuple state, in field order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, sub in zip(tree._fields, tree) for x in leaves(sub, path + f + ".")]
    return [(path.rstrip("."), np.asarray(tree))]


def leaves_off(a, b) -> list:
    """Names of the leaves where two states differ in dtype, shape or any bit."""
    la, lb = leaves(a), leaves(b)
    if [n for n, _ in la] != [n for n, _ in lb]:
        return ["<structure>"]
    return [n for (n, x), (_, y) in zip(la, lb)
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes()]


def row_off(prog_row: dict, ref_row: dict) -> list:
    """Keys where two rows differ (a timing key the program may add is not
    compared: the reference's run is not timed)."""
    keys = (set(prog_row) | set(ref_row)) - {"wall_s"}
    return sorted(k for k in keys if prog_row.get(k, "<none>") != ref_row.get(k, "<none>"))


def lane_gap(prog_state, prog_row: dict, ref_state, ref_row: dict) -> tuple:
    """``(off, fct gap)``: 1 where the lane's final state or row is not the
    reference's (else 0), and the widest gap between a flow's completion
    tick in the two (ticks; an unfinished flow's -1 counts as is)."""
    off = bool(leaves_off(prog_state, ref_state)) or bool(row_off(prog_row, ref_row))
    fp = np.asarray(prog_state.fct, np.int64)
    fr = np.asarray(ref_state.fct, np.int64)
    gap = int(np.abs(fp - fr).max()) if fp.shape == fr.shape else int(1 << 30)
    return int(off), gap
