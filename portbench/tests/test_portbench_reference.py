"""The plain reference against the program, lane for lane, on the tiny
three-tier tree: every lane of a study of each traffic kind equals the
reference's run of its point and salt in every leaf of its final state
and in its result row; and the reference imports nothing of the program."""

import subprocess
import sys

import numpy as np
import pytest

from portbench_tiny import ROOT, TINY_FABRIC, TINY_TRAFFIC, load

torch = pytest.importorskip("torch")


@pytest.mark.parametrize("kind", sorted(TINY_TRAFFIC))
def test_reference_equals_program_lane_for_lane(kind):
    from portbench import harness
    from portbench.gen import traffic
    from portbench.reference import check
    from repro_torch.netsim import api

    torch.set_num_threads(1)
    conf = load("portbench/configs/smartt_1024n_3t.json")
    conf.update(fabric=TINY_FABRIC, max_ticks=4000)
    table = traffic.flows(TINY_FABRIC, TINY_TRAFFIC[kind], 31)
    sc = harness.program_scenario("tiny", conf, table)
    points = load("portbench/mixes/perm_sweep256.json")["points"][5:7]
    res = api.study(sc, points=points, seeds=traffic.salts(31, 0, 2), device="cpu").run()
    assert len(res) == 4
    for r in res:
        st, row = check.reference_lane((conf, table, "tiny", dict(r.point), r.seed, None))
        assert r.all_done and row["all_done"]
        assert check.leaves_off(r.state, st) == []
        assert r.row() == row
        assert check.lane_gap(r.state, r.row(), st, row) == (0, 0)


def test_lane_gap_sees_one_changed_leaf():
    from portbench.gen import traffic
    from portbench.reference import check

    conf = load("portbench/configs/smartt_1024n_3t.json")
    conf.update(fabric=TINY_FABRIC, max_ticks=4000)
    table = traffic.flows(TINY_FABRIC, TINY_TRAFFIC["incast"], 5)
    st, row = check.reference_lane((conf, table, "tiny", {}, 9, None))
    bent = st._replace(fct=st.fct + np.int32(3) * (np.arange(st.fct.shape[0]) == 1))
    assert check.leaves_off(bent, st) == ["fct"]
    assert check.lane_gap(bent, row, st, row) == (1, 3)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [{r!r}, {s!r}]\n"
            "import portbench.reference.check, portbench.reference.engine\n"
            "print(sorted({{m.split('.', 1)[0] for m in sys.modules}}))")
    out = subprocess.run([sys.executable, "-c", code.format(r=str(ROOT), s=str(ROOT / "src"))],
                         capture_output=True, text=True, check=True).stdout
    top = set(eval(out))
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, top


def _ulp(a, b) -> int:
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max()) if np.size(a) else 0


# XLA:CPU contracts SMaRTT's Wait-to-Decrease EWMA into a fused
# multiply-add, NumPy does not: the JAX package's own bound between its
# runs and an eager implementation's over a whole run
JAX_ULP_BUDGET = 16


@pytest.mark.parametrize("kind,seed", [("permutation", 3), ("incast", 2**33 + 1),
                                       ("alltoall", 8)])
def test_reference_equals_the_jax_package(kind, seed):
    """The reference against the JAX package it was translated from, on
    the tiny tree: every integer and boolean leaf of the final state
    exactly, every float32 leaf within the JAX package's own bound, and
    the result row."""
    pytest.importorskip("jax")
    import jax

    from portbench.gen import traffic
    from portbench.reference import check
    from repro.netsim import api as japi
    from repro.netsim import engine as jengine
    from repro.netsim import state as jstate
    from repro.netsim import units as junits
    from repro.netsim import workloads as jworkloads

    conf = load("portbench/configs/smartt_1024n_3t.json")
    conf.update(fabric=TINY_FABRIC, max_ticks=4000)
    table = traffic.flows(TINY_FABRIC, TINY_TRAFFIC[kind], seed)
    point = load("portbench/mixes/perm_sweep256.json")["points"][seed % 8]
    salt = traffic.salts(seed, 0, 1)[0]
    st, row = check.reference_lane((conf, table, "tiny", point, salt, None))

    cfg = jstate.SimConfig(link=junits.LinkConfig(**conf["link"]),
                           tree=junits.FatTreeConfig(**conf["fabric"]), **conf["transport"])
    wl = jworkloads.Workload(name="tiny", src=table["src"], dst=table["dst"],
                             size=table["size"], t_start=table["t_start"],
                             order=table["order"], window=table["window"])
    jsim = jengine.build(japi.apply_point(cfg, point), wl)
    jst = jax.tree.map(np.asarray, jsim.run(conf["max_ticks"], seed=salt))
    for (n, a), (_, b) in zip(check.leaves(st), check.leaves(jst)):
        assert a.dtype == b.dtype and a.shape == b.shape, n
        if a.dtype == np.float32:
            assert _ulp(a, b) <= JAX_ULP_BUDGET, (n, _ulp(a, b))
        else:
            np.testing.assert_array_equal(a, b, err_msg=n)
    jrow = japi.RunResult.from_state(jsim, jst, scenario="tiny", point=point, seed=salt,
                                     max_ticks=conf["max_ticks"]).row()
    assert check.row_off(jrow, row) == []
    assert row["all_done"]
