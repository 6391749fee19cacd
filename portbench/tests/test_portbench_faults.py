"""A run with the timed path broken underneath comes out not correct:
once for each fault a lane batch on one card can have.  (The exchange
between cards does not exist in a one-card cell.)  And the control: the
reference computed in bfloat16 in the program's place is held not equal
to the float32 reference."""

import pytest

from portbench_tiny import TINY_FABRIC, TINY_TRAFFIC, load

torch = pytest.importorskip("torch")


def test_sound_run_is_correct(run_tiny):
    out = run_tiny("incast")
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["checks"].values())


def test_step_that_returns_its_state_unchanged(run_tiny, monkeypatch):
    from repro_torch.netsim import engine

    monkeypatch.setattr(engine.Sim, "tick", lambda self, c, st, k: st._replace(now=st.now + k.live))
    out = run_tiny("permutation", max_ticks=300)
    assert out["correct"] is False
    assert out["checks"]["unfinished_lanes"]["value"] == out["attempted"] > 0
    assert out["checks"]["lanes_off"]["value"] > 0


def test_half_of_the_batch_left_out(run_tiny, monkeypatch):
    from repro_torch.netsim import shard

    run_lanes = shard.run_lanes

    def half(sim, consts_b, axes, states, max_ticks, mesh=None):
        n = int(states.now.shape[0])
        states.done[n - n // 2:] = True          # the second half never runs
        return run_lanes(sim, consts_b, axes, states, max_ticks, mesh=mesh)

    monkeypatch.setattr(shard, "run_lanes", half)
    out = run_tiny("alltoall")
    assert out["correct"] is False
    assert out["checks"]["unfinished_lanes"]["value"] == out["attempted"] // 2


def test_answer_altered_where_it_is_produced(run_tiny, monkeypatch):
    from repro_torch.netsim import metrics

    account = metrics.account

    def bent(dims, c, st, k):          # one more packet counted delivered a tick
        st = account(dims, c, st, k)
        return st._replace(m=st.m._replace(delivered_pkts=st.m.delivered_pkts + k.live))

    monkeypatch.setattr(metrics, "account", bent)
    out = run_tiny("permutation")
    assert out["correct"] is False
    assert out["checks"]["unfinished_lanes"]["value"] == 0
    assert out["checks"]["lanes_off"]["value"] > 0


@pytest.mark.parametrize("seed", [3, 4, 2**32 + 5])
def test_control_in_bfloat16_is_not_correct(seed):
    from portbench.gen import traffic
    from portbench.reference import check

    conf = load("portbench/configs/smartt_1024n_3t.json")
    conf.update(fabric=TINY_FABRIC, max_ticks=4000)
    table = traffic.flows(TINY_FABRIC, TINY_TRAFFIC["permutation"], seed)
    point = load("portbench/mixes/perm_sweep256.json")["points"][seed % 8]
    salt = traffic.salts(seed, 0, 1)[0]
    ref = check.reference_lane((conf, table, "tiny", point, salt, None))
    ctl = check.reference_lane((conf, table, "tiny", point, salt, "bfloat16"))
    off, _ = check.lane_gap(ctl[0], ctl[1], ref[0], ref[1])
    assert off == 1 > 0          # the limit of lanes_off is 0
    assert any(n.startswith("cc.") for n in check.leaves_off(ctl[0], ref[0]))
