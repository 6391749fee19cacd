"""PyTorch port, EQDS's receiver credits through the experiment API
(``api.study(...).run()``, the benchmark's path) against the benchmark's
plain reference (``portbench/reference``, NumPy, independent of the
program), on the CPU: the configuration ``eqds_1024n_3t`` on the
8-node three-tier tree, a 6:1 incast (the benchmark cell's 24:1 in
shape) of 256 KiB flows, 64 packets each, so that credits gate the 24
that follow the speculative budget's 40; 2 sweep points x 2 salts.  Each
lane equals the reference's run of its point and salt in every bit of
every leaf of the final state, in every key of its row and in every
flow's completion tick; the points give lanes that differ.  With a
stated guarantee of the configuration broken in the grants phase (each
lane's credits landing in the next lane's ring, or no credit granted at
all) every lane is off its reference's run, so the benchmark's check
would call such a run not correct."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.gen import traffic  # noqa: E402
from portbench.reference import check  # noqa: E402

from repro_torch.netsim import api  # noqa: E402

NAME = "eqds_tiny"
# 8 nodes: 2 pods x 2 racks x 2 nodes (portbench/tests/portbench_tiny.py)
FABRIC = {"pods": 2, "racks": 4, "nodes_per_rack": 2, "uplinks": 2, "core_uplinks": 2}
TRAFFIC = {"kind": "incast", "degree": 6, "size_bytes": 262144}
POINTS = ({"credit_window_mult": 0.5, "maxcwnd_mult": 1.0},
          {"credit_window_mult": 2.0, "maxcwnd_mult": 1.25})
SALTS = (5, 2**31 - 3)
SEED = 2**33 + 7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as ``test_torch_engine.one_torch_thread``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def study():
    """``(configuration, flow table, the study, its result)``."""
    with open(ROOT / "portbench/configs/eqds_1024n_3t.json") as f:
        config = json.load(f)
    config["fabric"] = FABRIC
    table = traffic.flows(FABRIC, TRAFFIC, SEED)
    sc = harness.program_scenario(NAME, config, table)
    plan = api.study(sc, points=POINTS, seeds=SALTS, device="cpu")
    return config, table, plan, plan.run()


@pytest.fixture(scope="module")
def references(study):
    """The reference's ``(final state, row)`` of each lane."""
    config, table, plan, _ = study
    out = []
    for lane in range(plan.n_lanes):
        point, salt = plan.lane_point_seed(lane)
        out.append(check.reference_lane((config, table, NAME, dict(point), int(salt), None)))
    return out


@pytest.mark.parametrize("lane", range(len(POINTS) * len(SALTS)))
def test_lane_equals_the_reference(study, references, lane):
    _, _, _, res = study
    prog, (ref_state, ref_row) = res[lane], references[lane]
    row = prog.row()
    assert check.leaves_off(prog.state, ref_state) == []
    assert check.row_off(row, ref_row) == []
    assert check.lane_gap(prog.state, row, ref_state, ref_row) == (0, 0)
    assert row["all_done"]


def test_credits_gate_packets(study):
    """Every flow is longer than its speculative budget, so it was granted
    credit for the rest, and trims were re-granted."""
    config, table, plan, res = study
    mtu = float(config["link"]["mtu_bytes"])
    for lane in range(plan.n_lanes):
        st = res[lane].state
        assert np.all(st.goodput == table["size"])
        assert np.all(st.cc.spec_budget < mtu)             # spent before the credits
        assert np.all(st.granted >= table["size"] - 40 * mtu)
        assert 0 < float(np.max(st.trim_seen)) < 2**24       # under api.check_trim_seen


def test_the_points_give_lanes_that_differ(study):
    _, _, plan, res = study
    per = len(SALTS)
    for k in range(per):
        a, b = res[k], res[per + k]
        assert check.leaves_off(a.state, b.state) != []


def _crossed(grants):
    """Each lane's credit ring handed to the next lane after its grants:
    no lane is its standalone run any more."""
    def phase(dims, c, st, k, *, arb, ret):
        st = grants(dims, c, st, k, arb=arb, ret=ret)
        return st._replace(credit_ring=torch.roll(st.credit_ring, 1, 0))
    return phase


def _withheld(grants):
    """No credit granted: a flow is left with its speculative budget, and
    the bytes after it are never delivered."""
    return lambda dims, c, st, k, *, arb, ret: st


@pytest.mark.parametrize("fault, max_ticks, finished", [(_crossed, None, True),
                                                         (_withheld, 1500, False)])
def test_a_broken_guarantee_puts_every_lane_off_the_reference(study, references, fault,
                                                               max_ticks, finished):
    from repro_torch.netsim import sender

    config, table, _, _ = study
    config = dict(config, max_ticks=max_ticks or config["max_ticks"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sender, "grants", fault(sender.grants))
        plan = api.study(harness.program_scenario(NAME, config, table), points=POINTS,
                         seeds=SALTS, device="cpu")
        res = plan.run()
    for lane in range(plan.n_lanes):
        row, (ref_state, ref_row) = res[lane].row(), references[lane]
        assert check.lane_gap(res[lane].state, row, ref_state, ref_row)[0] == 1
        assert row["all_done"] is finished
