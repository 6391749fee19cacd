"""PyTorch port, whole runs on the CPU of the reference's digest
scenarios that no other port test runs whole, at their digest budgets
(``tests/data/scenario_digests.json`` ``budgets``), against the JAX
reference through ``assert_run_parity`` (the whole final state, the
summary, and the experiment API's ``RunResult`` row and summary).  This
file holds the alltoall, incast and oversubscribed-permutation ones;
``test_torch_digest_runs_b.py`` the rest.  ``done`` is whether the
reference itself finishes every flow within the budget: only where it
does not is the run checked with ``require_done=False``."""

import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from test_torch_engine import assert_run_parity  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

BUDGETS = json.loads((Path(__file__).parent / "data" / "scenario_digests.json")
                     .read_text())["budgets"]


@pytest.mark.parametrize("name,done", [("alltoall16_w4", True), ("incast8_32n", True),
                                       ("incast_32x1", False), ("perm128_8to1", False)])
def test_digest_scenario_run_matches_reference(name, done):
    ts = assert_run_parity(name, require_done=done, max_ticks=BUDGETS[name])
    assert ts["all_done"] == done
    assert ts["ticks"] <= BUDGETS[name] and ts["delivered_bytes"] > 0
