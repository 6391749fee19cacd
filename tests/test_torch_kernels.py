"""PyTorch port, kernels: each kernel's plain version against the JAX
reference's plain version on the same seeded numpy inputs, at the main
path's shapes (perm_1024n_3t, alltoall_3t) and ragged small ones.

``enqueue_rank``, ``rr_pick`` and ``ring_drain`` must be exact.  For
``cc_update`` the integer and boolean outputs must be exact and every f32
output within ``ULP_BUDGET`` units in the last place: XLA:CPU contracts
``a*b + c`` into one fused multiply-add under ``jit`` and eager PyTorch
does not, so the two may round a multiply-add differently (one ULP of
that operation; DESIGN.md Sec. 6.1).

The CUDA kernels themselves run only on a card: ``test_torch_gpu.py``
holds each against its plain version there (without JAX, which the
card's machine need not have).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import types as jtypes  # noqa: E402
from repro.kernels.cc_update import ref as jcc  # noqa: E402
from repro.kernels.cc_update.ops import smartt_update_pallas  # noqa: E402
from repro.kernels.enqueue_arb import ref as jarb  # noqa: E402
from repro.kernels.enqueue_arb import kernel as jarb_kernel  # noqa: E402
from repro.kernels.ring_drain import ref as jdrain  # noqa: E402
from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.cc_update import ref as tcc  # noqa: E402
from repro_torch.kernels.enqueue_arb import ops as tarb_ops  # noqa: E402
from repro_torch.kernels.enqueue_arb import ref as tarb  # noqa: E402
from repro_torch.kernels.ring_drain import ref as tdrain  # noqa: E402

ULP_BUDGET = 2

# main-path shapes: perm_1024n_3t (NF, [NSW, DMAX], NQ, CAP, W, MAXW) and
# alltoall_3t (N, FMAX) — asserted against the built scenarios below
NF, NSW, DMAX, NQ, CAP, W, MAXW = 1024, 176, 20, 2304, 40, 64, 2
N_A2A, FMAX_A2A = 512, 31


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def ulp_diff(a, b):
    """Distance in f32 units in the last place (0 for equal bits)."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def test_main_path_shapes():
    from repro_torch.netsim import scenarios
    perm = scenarios.scenario("perm_1024n_3t").build(device="cpu")
    a2a = scenarios.scenario("alltoall_3t").build(device="cpu")
    d = perm.dims
    assert (d.NF, *perm.consts.in_tbl.shape, d.NQ, d.CAP, d.W, d.MAXW) == \
        (NF, NSW, DMAX, NQ, CAP, W, MAXW)
    assert (a2a.dims.N, a2a.dims.FMAX) == (N_A2A, FMAX_A2A)


# ------------------------------------------------------------ cc_update


def _jax_cc(case):
    pk = case["params"]
    p = jtypes.make_cc_params(mtu=pk["mtu"], bdp=pk["bdp"], brtt=pk["brtt"],
                              react_every=pk["react_every"])
    F = pk["brtt"].shape[0]
    s = jtypes.init_cc_state(F, p)._replace(
        **{k: jnp.asarray(v) for k, v in case["state"].items()})
    ev = jtypes.CCEvent(ack_entropy=jnp.zeros((F,), jnp.int32),
                        credit_grant=jnp.zeros((F,), jnp.float32),
                        **{k: jnp.asarray(v) for k, v in case["event"].items()})
    return p, s, ev


CC_FIELDS = tcc.STATE_F32 + tcc.STATE_BOOL + tcc.STATE_I32


@pytest.mark.parametrize("F,seed,react", [(1, 1, 1), (7, 2, 3), (1000, 3, 1),
                                          (NF, 4, 1), (NF, 5, 2)])
def test_cc_update_plain_matches_reference(F, seed, react):
    case = cases.cc_update_case(F, seed, react)
    p, s, ev = _jax_cc(case)
    now = case["now"]
    refs = {
        "eager": jcc.smartt_update(p, s, ev, float(now)),
        "jit": jax.jit(jcc.smartt_update)(p, s, ev, float(now)),
        "pallas": smartt_update_pallas(p, s, ev, float(now)),
    }
    tp, ts, tev, tnow = cases.cc_update_tensors(case, "cpu")
    got = tcc.cc_update_ref(tp, ts, tev, tnow)
    worst = {}
    for label, ref in refs.items():
        for name in CC_FIELDS:
            want, have = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
            assert want.dtype == have.dtype, name
            if name in tcc.STATE_F32:
                u = int(ulp_diff(want, have).max())
                worst[f"{label}.{name}"] = u
                assert u <= ULP_BUDGET, (label, name, u)
            else:
                np.testing.assert_array_equal(want, have, err_msg=f"{label} {name}")
    print(f"F={F} seed={seed}: largest f32 difference per field (ULP) {worst}")


# -------------------------------------------------------- enqueue_rank


@pytest.mark.parametrize("shape,seed", [((1, 1, 4, 3), 1), ((3, 5, 7, 4), 2),
                                        ((NSW, DMAX, NQ, CAP), 3),
                                        ((NSW, DMAX, 5, CAP), 4)])
def test_enqueue_rank_plain_matches_reference(shape, seed):
    S, D, nq, cap = shape
    c = cases.enqueue_rank_case(S, D, nq, cap, seed)
    args = [c[n] for n in ("gdst", "ghead", "gsize")]
    want = jarb.enqueue_rank_ref(*map(jnp.asarray, args), cap=cap, nq=nq)
    interp = jarb_kernel.enqueue_rank(*map(jnp.asarray, args), cap=cap, nq=nq)
    got = tarb.enqueue_rank_ref(*map(_t, args), cap=cap, nq=nq)
    for w, i, g in zip(want, interp, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        np.testing.assert_array_equal(np.asarray(i), g.numpy())
    if S * D >= 100:   # every branch taken: repeated ranks and refusals
        assert int(got[0].max()) > 0 and not bool(got[1].all())


def test_enqueue_rank_ops_layer_matches_reference():
    """The ops layer (gathers through in_tbl, per-queue counts over
    sw_of_q, gather back through in_pos) at perm_1024n_3t's tables."""
    from repro.kernels.enqueue_arb import ops as jops
    from repro.netsim import scenarios as jscen
    from repro.netsim import state as jstate
    sc = jscen.scenario("perm_1024n_3t")
    topo, _, dims, consts = jstate.derive(sc.cfg, sc.wl)
    rng = np.random.default_rng(0)
    EQ = len(topo.enq_ids)
    edst = np.where(rng.random(EQ) < 0.5, rng.integers(0, dims.NQ, EQ),
                    dims.NQ).astype(np.int32)
    q_head = rng.integers(0, dims.CAP, dims.NQ + 1).astype(np.int32)
    q_size = rng.integers(0, dims.CAP + 1, dims.NQ + 1).astype(np.int32)
    want = jops.enqueue_rank(consts.in_tbl, consts.in_pos, consts.sw_of_q,
                             jnp.asarray(edst), jnp.asarray(q_head),
                             jnp.asarray(q_size), dims.CAP, dims.NQ)
    got = tarb_ops.enqueue_rank(_t(topo.in_tbl), _t(topo.in_pos), _t(topo.sw_of_q),
                                _t(edst), _t(q_head), _t(q_size), dims.CAP, dims.NQ)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


# ------------------------------------------------------------- rr_pick


@pytest.mark.parametrize("shape,seed", [((1, 1), 1), ((5, 33), 2), ((7, 64), 3),
                                        ((N_A2A, FMAX_A2A), 4),
                                        ((N_A2A, FMAX_A2A), 5)])
def test_rr_pick_plain_matches_reference(shape, seed):
    N, K = shape
    c = cases.rr_pick_case(N, K, seed)
    want = jarb.rr_pick_ref(jnp.asarray(c["elig"]), jnp.asarray(c["rr"]), kmax=K)
    interp = jarb_kernel.rr_pick(jnp.asarray(c["elig"]), jnp.asarray(c["rr"]), kmax=K)
    got = tarb.rr_pick_ref(_t(c["elig"]), _t(c["rr"]), kmax=K)
    for w, i, g in zip(want, interp, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        np.testing.assert_array_equal(np.asarray(i), g.numpy())


# ---------------------------------------------------------- ring_drain

_DRAIN_IN = ("rto", "started", "has_ack", "ack_seq", "lbits", "bitmap",
             "sent0", "sent1", "sent2")


@pytest.mark.parametrize("shape,seed", [((3, 32, 1), 1), ((2, 1024, 40), 2),
                                        ((NF, W, MAXW), 3), ((NF, W, MAXW), 4)])
def test_ring_drain_plain_matches_reference(shape, seed):
    F, w, maxw = shape
    c = cases.ring_drain_case(F, w, maxw, seed)
    want = jdrain.ring_drain_ref(
        jnp.int32(c["t"]), *[jnp.asarray(c[n]) for n in _DRAIN_IN],
        w=w, ww=w // 32, maxw=maxw)
    got = tdrain.ring_drain_ref(c["t"], *[_t(c[n]) for n in _DRAIN_IN],
                                w=w, ww=w // 32, maxw=maxw)
    for w_, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w_), g.numpy())
    state, n_to, spur, un = (g.numpy() for g in got)
    if F >= 100:   # every path taken: frees, losses, timeouts, spurious
        assert n_to.sum() > 0 and spur.sum() > 0 and un.sum() > 0
        assert (state == 3).any() and ((c["sent0"] != 0) & (state == 0)).any()


# ------------------------------------- the main path's operands (CPU rehearsal)


@pytest.mark.parametrize("name,ticks", [("perm_128n_3t", 80), ("alltoall_3t", 40)])
def test_main_path_operands_pass_every_wrapper_check(monkeypatch, name, ticks):
    """Each CUDA wrapper checks device, dtype, shape and contiguity of every
    operand before it asks for the card.  Route the main path's real calls
    through the wrappers on the CPU: every check must pass, so the only
    refusal left is the one that says the tensors are not on a card."""
    from repro_torch.kernels import build
    from repro_torch.kernels.cc_update import kernel as CK
    from repro_torch.kernels.enqueue_arb import kernel as EK
    from repro_torch.kernels.ring_drain import kernel as DK
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

    def drain_plain(t, *a):
        return tdrain.ring_drain_ref(t, *a, w=a[-1].shape[1], ww=a[4].shape[1],
                                     maxw=a[5].shape[1])

    rehearse(CK, "cc_update", tcc.cc_update_ref)
    rehearse(EK, "enqueue_rank", tarb.enqueue_rank_ref)
    rehearse(EK, "rr_pick", tarb.rr_pick_ref)
    rehearse(DK, "ring_drain", drain_plain)
    monkeypatch.setattr(build, "use_kernel", lambda backend, x: backend == "kernel")
    sim = scenarios.scenario(name).build(device="cpu")
    sim.run(ticks)
    want = {"cc_update", "enqueue_rank", "ring_drain"} | \
        ({"rr_pick"} if sim.dims.FMAX > 1 else set())
    assert set(calls) == want and all(v == ticks for k, v in calls.items()
                                      if k != "rr_pick"), calls
