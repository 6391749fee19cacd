"""PyTorch port, the ``red_mark`` kernel's plain version against the JAX
reference's Pallas kernel (interpret mode) and its ``red_mark_ref``, on
the same seeded numpy inputs: the mark, the admitted count and the
trimmed count exactly, at ragged and main-path queue counts, ticks at the
edges of the hash lane, the simulator's thresholds and a zero span.

The reference's Pallas kernel packs ``tick`` and ``salt`` into an f32 row
(``repro/kernels/red_mark/kernel.py:54-55``), which rounds them from
``2**24`` on; there the port follows the reference's ``red_mark_ref``,
which takes them as i32, and every other case is held to both.

The last test holds ``fabric.red_marks`` — the coin flip the simulator's
``departures`` applies — to the kernel's function on states the reference
produced.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.red_mark.kernel import red_mark as jred_mark  # noqa: E402
from repro.kernels.red_mark.ref import red_mark_ref as jred_mark_ref  # noqa: E402
from repro.netsim import engine as jengine  # noqa: E402
from repro.netsim import scenarios as jscen  # noqa: E402
from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.red_mark import ops as tops  # noqa: E402
from repro_torch.kernels.red_mark import ref as tref  # noqa: E402
from repro_torch.netsim import fabric as tfabric  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

CAP, KMIN, KMAX = cases.RED_CAP, cases.RED_KMIN, cases.RED_KMAX
SALT = 0xECD


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_both(c, kmin, kmax, tick, salt, pallas=True):
    """The reference's Pallas kernel (interpret) and its ref, with the
    thresholds as f32 values as the kernel packs them."""
    qs, ar = jnp.asarray(c["q_size"]), jnp.asarray(c["arrivals"])
    want = jred_mark_ref(qs, ar, jnp.int32(c["cap"]), jnp.float32(kmin),
                         jnp.float32(kmax), jnp.int32(tick), jnp.int32(salt))
    out = [("ref", want)]
    if pallas:
        out.append(("pallas", jred_mark(qs, ar, c["cap"], np.float32(kmin),
                                        np.float32(kmax), tick, salt)))
    return out


def _assert_equal(refs, got, what):
    for label, want in refs:
        for name, w, g in zip(("mark", "admit", "trim"), want, got):
            w = np.asarray(w)
            assert w.dtype == g.numpy().dtype, (what, label, name)
            np.testing.assert_array_equal(w, g.numpy(), err_msg=f"{what} {label} {name}")


@pytest.mark.parametrize("Q", [1, 5, 127, 128, 130, 1024, 2304])
@pytest.mark.parametrize("tick", [0, 17, 65535, 120000])
def test_red_mark_plain_matches_reference(Q, tick):
    c = cases.red_mark_case(Q, seed=Q + tick)
    got = tops.red_mark_op(_t(c["q_size"]), _t(c["arrivals"]), cap=c["cap"],
                           kmin=KMIN, kmax=KMAX, tick=tick, salt=SALT)
    _assert_equal(_jax_both(c, KMIN, KMAX, tick, SALT), got, f"Q={Q} tick={tick}")
    if Q >= 1024:       # every branch taken: marks, trims, full queues
        mark, admit, trim = (g.numpy() for g in got)
        assert mark.any() and not mark.all() and trim.any() and (admit == 0).any()


@pytest.mark.parametrize("kmin,kmax,salt", [
    (KMIN, KMAX, SALT),
    (20.0, 20.0, SALT),             # kmin == kmax: the 1e-6 floor of the span
    (5.2, 20.8, 0x123457),          # thresholds that are not whole numbers
    (0.0, 1.0, -7),                 # a negative salt wraps to uint32
])
def test_red_mark_thresholds_match_reference(kmin, kmax, salt):
    c = cases.red_mark_case(2304, seed=3)
    got = tops.red_mark_op(_t(c["q_size"]), _t(c["arrivals"]), cap=c["cap"],
                           kmin=kmin, kmax=kmax, tick=99, salt=salt)
    _assert_equal(_jax_both(c, kmin, kmax, 99, salt), got, f"{kmin}..{kmax}")


@pytest.mark.parametrize("tick,salt", [(2 ** 24 + 1, SALT), (5, 2 ** 24 + 1)])
def test_red_mark_tick_past_f32_range_matches_ref(tick, salt):
    """A tick or salt of 2**24 + 1: the Pallas kernel's f32 scalar row
    rounds it to 2**24, its ref does not; the port follows the ref."""
    c = cases.red_mark_case(1024, seed=11)
    got = tops.red_mark_op(_t(c["q_size"]), _t(c["arrivals"]), cap=c["cap"],
                           kmin=KMIN, kmax=KMAX, tick=tick, salt=salt)
    _assert_equal(_jax_both(c, KMIN, KMAX, tick, salt, pallas=False), got, "2**24+1")
    pallas = jred_mark(jnp.asarray(c["q_size"]), jnp.asarray(c["arrivals"]),
                       CAP, KMIN, KMAX, tick, salt)
    assert not np.array_equal(np.asarray(pallas[0]), got[0].numpy())


def test_red_mark_leading_dimensions():
    """The plain version takes ``[..., Q]``, as the reference's ref does
    (the queue index is the last axis's)."""
    rng = np.random.default_rng(5)
    qs = rng.integers(0, CAP + 4, (3, 2, 130)).astype(np.int32)
    ar = rng.integers(0, 6, (3, 2, 130)).astype(np.int32)
    want = jred_mark_ref(jnp.asarray(qs), jnp.asarray(ar), jnp.int32(CAP),
                         jnp.float32(KMIN), jnp.float32(KMAX), jnp.int32(77),
                         jnp.int32(SALT))
    got = tref.red_mark_ref(_t(qs), _t(ar), CAP, KMIN, KMAX, 77, SALT)
    _assert_equal([("ref", want)], got, "[3, 2, 130]")


def test_red_mark_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel wrapper, never to the plain
    version (here the wrapper is replaced, since there is no card)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.red_mark import kernel as K
    seen = []
    monkeypatch.setattr(build, "use_kernel", lambda backend, x: backend == "kernel")
    monkeypatch.setattr(K, "red_mark", lambda *a, **k: seen.append(k) or "kernel")
    monkeypatch.setattr(tref, "red_mark_ref", lambda *a: pytest.fail("plain version taken"))
    c = cases.red_mark_case(8, 0)
    assert tops.red_mark_op(_t(c["q_size"]), _t(c["arrivals"]), cap=CAP, kmin=KMIN,
                            kmax=KMAX, tick=3) == "kernel"
    assert seen[0]["salt"] == SALT and seen[0]["tick"] == 3


def test_red_mark_wrapper_checks_operands_before_the_card():
    from repro_torch.kernels.red_mark import kernel as K
    c = cases.red_mark_case(16, 0)
    qs, ar = _t(c["q_size"]), _t(c["arrivals"])
    with pytest.raises(TypeError, match="dtype"):
        K.red_mark(qs.to(torch.int64), ar, cap=CAP, kmin=KMIN, kmax=KMAX, tick=0, salt=0)
    with pytest.raises(ValueError, match="shape"):
        K.red_mark(qs, ar[:8], cap=CAP, kmin=KMIN, kmax=KMAX, tick=0, salt=0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        K.red_mark(qs, ar, cap=CAP, kmin=KMIN, kmax=KMAX, tick=0, salt=0)


@pytest.mark.parametrize("name,seed", [("perm_128n_3t", 0), ("incast_256x1_3t", 3),
                                       ("corefail_128n_3t", 0)])
def test_departures_flip_is_red_mark(name, seed):
    """On states the reference produced (every 10th tick of its first 300,
    queues loaded, trims happening), the simulator's inline flip
    ``fabric.red_marks & active`` equals the kernel function's mark with
    ``kmax = kmin + kspan`` and the salt ``0xECD + salt``: the two are one
    function wherever ``kspan`` equals ``max(kmax - kmin, 1e-6)``, as it
    does for these scenarios (24.0 at CAP = 40)."""
    sc = jscen.scenario(name)
    jsim = jengine.build(sc.cfg, sc.wl)
    step = jax.jit(jsim.step)
    st = jsim.init()._replace(salt=jnp.int32(seed))
    tsim = tscen.scenario(name).build(device="cpu")
    c, d = tsim.consts, tsim.dims
    assert float(c.kspan) == max(float(c.kmin + c.kspan) - float(c.kmin), 1e-6) == 24.0
    marked = 0
    for t in range(300):
        if t % 10 == 0:
            port = tstate.from_numpy(jax.tree.map(np.asarray, st), "cpu")
            q = port.q_size[:d.NQ]
            active = q > 0
            flip = tfabric.red_marks(d, c, port, t) & active
            mark, _, _ = tops.red_mark_op(q, torch.zeros_like(q), cap=d.CAP, kmin=c.kmin,
                                          kmax=c.kmin + c.kspan, tick=t,
                                          salt=0xECD + port.salt)
            assert torch.equal(flip, mark), (name, t)
            marked += int(mark.sum())
        st = step(st)
    assert marked > 0
