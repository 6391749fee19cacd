"""PyTorch port, whole runs on the CPU of the reference's digest
scenarios that no other port test runs whole, at their digest budgets:
the permutations on 64 and 16 nodes, perm_512n_3t_degraded (a dead port
and a half-rate one from tick 0) and the sparse workloads, against the
JAX reference through ``assert_run_parity`` (``test_torch_digest_runs_a.py``
holds the others).  ``done`` is whether the reference itself finishes
every flow within the budget."""

import pytest

pytest.importorskip("torch")

from test_torch_digest_runs_a import BUDGETS  # noqa: E402
from test_torch_engine import assert_run_parity  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)


@pytest.mark.parametrize("name,done", [("perm64", False), ("perm_16n", True),
                                       ("perm_512n_3t_degraded", False),
                                       ("sparse_heavy_32n", False),
                                       ("sparse_large_32n", False)])
def test_digest_scenario_run_matches_reference(name, done):
    ts = assert_run_parity(name, require_done=done, max_ticks=BUDGETS[name])
    assert ts["all_done"] == done
    assert ts["ticks"] <= BUDGETS[name] and ts["delivered_bytes"] > 0
    if name == "perm_512n_3t_degraded":
        assert ts["blackholed"] > 0
