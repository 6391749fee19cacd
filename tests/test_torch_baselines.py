"""PyTorch port, the paper's comparison algorithms (Sec. 4: Swift, MPRDMA,
BBR, EQDS, plus EQDS+SMaRTT and the ECN-only / delay-only strawmen) and
the credit-based (EQDS grants through ``rr_pick``) and paced (BBR) branches
of the sender, against the JAX reference on the CPU:

* seeded state/event batches through every algorithm's update against the
  reference's update, eager and under ``jit``: integer and boolean fields
  exactly, f32 fields within ``ULP_BUDGET`` (the largest difference per
  field is printed);
* one tick from reference states (``test_torch_tick.py``'s harness) for
  eqds and bbr;
* whole runs (``test_torch_engine.py``'s ``assert_run_parity``: integers
  exact, f32 within its run budget): every algorithm on ``tiny_3t``, the
  four baselines on ``perm_128n_3t``, the credit-based and strawman ones on
  ``incast8_16n``;
* a CPU rehearsal of the kernel wrappers' operand checks on EQDS's real
  calls (the grant pick is ``rr_pick``'s second call site).

Every one of these has come out bit-equal to the reference, but for the
SMaRTT half of eqds_smartt under ``jit`` (``avg_wtd`` one ULP apart: the
Wait-to-Decrease EWMA XLA:CPU contracts into a multiply-add, ROADMAP.md
Queue 3): no baseline has a multiply feeding an add that XLA:CPU
contracts differently (``core/baselines.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import registry as jregistry  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro_torch.core import registry as tregistry  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.kernels import cases  # noqa: E402
from test_torch_engine import assert_run_parity  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)
from test_torch_tick import check_one_tick  # noqa: E402

ULP_BUDGET = 2       # one update, as tests/test_torch_kernels.py holds cc_update
BASELINES = ("swift", "mprdma", "bbr", "eqds", "eqds_smartt", "ecn_only", "delay_only")


def _ulp(a, b):
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max()) if np.size(a) else 0


def full_case(F: int, seed: int) -> dict:
    """The SMaRTT case of ``kernels/cases.py`` plus every baseline field of
    the union state (Swift's last decrease, BBR's estimates and window,
    EQDS's credits) and the credit-grant event, with values that take each
    branch: decreases allowed and not, estimation windows that close,
    every pacing-gain phase, credits above and below a packet."""
    c = cases.cc_update_case(F, seed)
    rng = np.random.default_rng(seed + 100)
    now = c["now"]
    f32 = lambda a: np.asarray(a, np.float32)
    c["state"].update(
        last_dec=f32(np.where(rng.random(F) < 0.2, -1e9, now - rng.integers(0, 120, F))),
        bw_est=f32(rng.uniform(0, 2 * cases.CC_MTU, F)),
        rtprop=f32(rng.choice([20.0, 36.0, 42.0, 0.5], F)),
        win_delivered=f32(rng.uniform(0, 4e5, F)),
        win_end=f32(now + rng.integers(-40, 40, F)),
        pacing_rate=f32(rng.uniform(0, cases.CC_MTU, F)),
        credits=f32(rng.choice([0.0, 100.0, cases.CC_MTU, 3 * cases.CC_MTU], F)),
        spec_budget=f32(rng.uniform(0, 2e5, F)),
    )
    c["event"]["credit_grant"] = f32(rng.choice([0.0, cases.CC_MTU], F))
    return c


def _jax_inputs(c):
    pk = c["params"]
    p = jtypes.make_cc_params(mtu=pk["mtu"], bdp=pk["bdp"], brtt=pk["brtt"])
    F = pk["brtt"].shape[0]
    s = jtypes.init_cc_state(F, p)._replace(
        **{k: jnp.asarray(v) for k, v in c["state"].items()})
    ev = jtypes.CCEvent(ack_entropy=jnp.zeros((F,), jnp.int32),
                        **{k: jnp.asarray(v) for k, v in c["event"].items()})
    return p, s, ev


def _torch_inputs(c):
    pk = c["params"]
    p = ttypes.make_cc_params(mtu=pk["mtu"], bdp=pk["bdp"],
                              brtt=torch.from_numpy(pk["brtt"]), device="cpu")
    F = pk["brtt"].shape[0]
    t = lambda a: torch.from_numpy(np.array(a, copy=True))
    s = ttypes.init_cc_state(F, p)._replace(**{k: t(v) for k, v in c["state"].items()})
    ev = ttypes.CCEvent(ack_entropy=torch.zeros((F,), dtype=torch.int32),
                        **{k: t(v) for k, v in c["event"].items()})
    return p, s, ev


@pytest.mark.parametrize("algo", BASELINES)
@pytest.mark.parametrize("F,seed", [(1, 1), (7, 2), (1024, 3)])
def test_update_matches_reference(algo, F, seed):
    c = full_case(F, seed)
    now = c["now"]
    jp, js, jev = _jax_inputs(c)
    fn = jregistry.get(algo)
    refs = {"eager": fn(jp, js, jev, jnp.int32(now)),
            "jit": jax.jit(fn)(jp, js, jev, jnp.int32(now))}
    got = tregistry.get(algo, "kernel")(*_torch_inputs(c), now)
    worst = {}
    for label, ref in refs.items():
        for name in ttypes.CCState._fields:
            want, have = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
            assert want.dtype == have.dtype and want.shape == have.shape, name
            if want.dtype == np.float32:
                worst[f"{label}.{name}"] = u = _ulp(want, have)
                assert u <= ULP_BUDGET, (algo, label, name, u)
            else:
                np.testing.assert_array_equal(want, have, err_msg=f"{label} {name}")
    print(f"{algo} F={F}: largest f32 difference (ULP) "
          f"{({k: v for k, v in worst.items() if v})}")


def test_every_algorithm_resolves():
    assert set(tregistry.ALGORITHMS) == set(jregistry.ALGORITHMS)
    assert tregistry.CREDIT_BASED == jregistry.CREDIT_BASED
    assert tregistry.PACED == jregistry.PACED
    for algo in tregistry.ALGORITHMS:
        for backend in tregistry.BACKENDS:
            assert callable(tregistry.get(algo, backend))


@pytest.mark.parametrize("algo", ["eqds", "bbr"])
def test_one_tick_from_reference_state(algo):
    """EQDS (grants, credit ring, credit admission and spending) and BBR
    (pacing budget, no leaps) one tick at a time on perm_128n_3t."""
    kinds, _, ticks = check_one_tick("perm_128n_3t", algo=algo)
    assert {"trim", "retx", "ack", "deliver"} <= kinds, kinds


@pytest.mark.parametrize("algo", BASELINES)
def test_whole_run_tiny_3t(algo):
    assert_run_parity("tiny_3t", algo=algo)


@pytest.mark.parametrize("algo", ["swift", "mprdma", "eqds", "bbr"])
def test_whole_run_perm_128n_3t(algo):
    ts = assert_run_parity("perm_128n_3t", algo=algo)
    assert ts["trims"] > 0


@pytest.mark.parametrize("algo", ["eqds", "eqds_smartt", "ecn_only", "delay_only"])
def test_whole_run_incast8_16n(algo):
    assert_run_parity("incast8_16n", algo=algo)


def test_eqds_operands_pass_every_wrapper_check(monkeypatch):
    """EQDS's real calls on incast8_16n routed through the CUDA wrappers on
    the CPU: every operand check passes (the grant pick hands ``rr_pick`` a
    [N, FRMAX] plane and the receivers' cursors), so the only refusal left
    is the one that says the tensors are not on a card; the departures
    phase is the fused kernel, the control phase
    the fused kernel with the CC update off, the arrivals phase the
    fused kernel on the credit path, the sends phase the fused kernel
    with credits (its pick inside it), and the split designs' cc_update,
    ring_drain and enqueue_rank are never called."""
    from repro_torch.kernels import build
    from repro_torch.kernels.arrivals import kernel as AK
    from repro_torch.kernels.arrivals import ref as AR
    from repro_torch.kernels.cc_update import kernel as CK
    from repro_torch.kernels.control import kernel as XK
    from repro_torch.kernels.control import ref as XR
    from repro_torch.kernels.departures import kernel as PK
    from repro_torch.kernels.departures import ref as PR
    from repro_torch.kernels.enqueue_arb import kernel as EK
    from repro_torch.kernels.enqueue_arb import ref as ER
    from repro_torch.kernels.ring_drain import kernel as DK
    from repro_torch.kernels.ring_drain import ref as DR
    from repro_torch.kernels.sends import kernel as SK
    from repro_torch.kernels.sends import ref as SR
    from repro_torch.netsim import scenarios

    calls = {}

    def rehearse(mod, fn_name, plain):
        orig = getattr(mod, fn_name)

        def wrapper(*args, **kw):
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                orig(*args, **kw)
            calls[fn_name] = calls.get(fn_name, 0) + 1
            return plain(*args, **kw)
        monkeypatch.setattr(mod, fn_name, wrapper)

    rehearse(CK, "cc_update", lambda *a: pytest.fail("cc_update called for eqds"))
    rehearse(EK, "enqueue_rank", ER.enqueue_rank_ref)
    rehearse(EK, "rr_pick", ER.rr_pick_ref)
    rehearse(DK, "ring_drain", lambda t, *a: DR.ring_drain_ref(
        t, *a, w=a[-1].shape[1], ww=a[4].shape[1], maxw=a[5].shape[1]))
    rehearse(XK, "control", XR.control_lanes_ref)
    rehearse(AK, "arrivals", AR.arrivals_lanes_ref)
    rehearse(SK, "sends", SR.sends_lanes_ref)
    rehearse(PK, "departures", PR.departures_lanes_ref)
    monkeypatch.setattr(build, "use_kernel", lambda backend, x: backend == "kernel")
    sim = scenarios.scenario("incast8_16n", algo="eqds").build(device="cpu")
    assert sim.dims.FMAX == 1 and sim.dims.FRMAX == 8    # rr_pick: grants only
    sim.run(60)
    assert calls == {"arrivals": 60, "control": 60, "departures": 60, "rr_pick": 60,
                     "sends": 60}, calls
