"""Config-sweep runner — a thin compatibility wrapper over the experiment
API (``netsim/api.py``), as in the reference (``repro/netsim/sweep.py``).

New code should call ``api.study`` directly — it additionally crosses the
sweep with seed batches and returns typed results; ``build_sweep`` keeps
the historical shape::

    points = [{"start_cwnd_mult": a, "react_every": r}
              for a in (0.5, 1.25) for r in (1, 2, 4, 8)]
    sw = build_sweep(SimConfig(algo="smartt"), wl, points)
    states = sw.run(max_ticks=30000)        # [B]-stacked host SimState
    rows = sw.summaries(states)             # one summarize() dict per point

Sweepable keys are ``api.CFG_KEYS | api.CC_PARAM_KEYS`` (re-exported
here); anything per-point that would change ``Dims`` raises at build
time.  Every point's final state (``now`` and metrics included) is
bit-for-bit the standalone ``engine.build(...).run()`` of that config.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.netsim import api, engine, metrics, state
from repro_torch.netsim.api import (CC_PARAM_KEYS, CFG_KEYS,  # noqa: F401 (re-export)
                                    apply_point)
from repro_torch.netsim.scenarios import Scenario


@dataclasses.dataclass(frozen=True, eq=False)
class Sweep:
    """A planned N-point grid (an ``api.Study`` with a single seed)."""

    study: api.Study

    @property
    def sim(self) -> engine.Sim:
        return self.study.sim

    @property
    def points(self) -> tuple:
        return tuple(dict(p) for p in self.study.points)

    @property
    def n_points(self) -> int:
        return self.study.n_points

    def run(self, max_ticks: int) -> state.SimState:
        """Run all points to completion; their final states stacked on the
        host along a leading ``[B]`` axis."""
        return self.study.run_states(max_ticks=max_ticks)

    def summaries(self, states: state.SimState) -> list:
        """Per-point summaries.  Each point ran under its own exit gate,
        so per-point time fields (``ticks``, ``q_mean``) are exactly the
        standalone run's."""
        return summarize_batch(self.sim, states)


def build_sweep(cfg: state.SimConfig, wl,
                points: Sequence[Mapping[str, float]], device="cuda") -> Sweep:
    if not points:
        raise ValueError("empty sweep")
    sc = Scenario(name=getattr(wl, "name", "sweep"), cfg=cfg, wl=wl)
    return Sweep(study=api.study(sc, points=points, device=device))


def summarize_batch(sim: engine.Sim, states: state.SimState) -> list:
    """One host-side summarize() dict per sweep point."""
    return [metrics.summarize(sim, state.lane(states, b))
            for b in range(states.done.shape[0])]
