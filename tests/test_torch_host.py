"""PyTorch port, host side: every registered scenario's topology and
routing tables, workload arrays, Dims, Consts and initial SimState equal
the JAX reference's byte for byte (the salts by value: uint32 there, int64
here); the splitmix32 hashes hit the golden values; the port imports no
JAX and nothing of the JAX package; and asking for what is not ported
raises instead of running something else."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.netsim import engine as jengine  # noqa: E402
from repro.netsim import faults as jfaults  # noqa: E402
from repro.netsim import scenarios as jscen  # noqa: E402
from repro.netsim import state as jstate  # noqa: E402
from repro_torch.netsim import engine as tengine  # noqa: E402
from repro_torch.netsim import faults as tfaults  # noqa: E402
from repro_torch.netsim import hashing as thash  # noqa: E402
from repro_torch.netsim import scenarios as tscen  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402
from repro_torch.netsim import workloads as twl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SALTS = {"sw_salt", "q_salt", "f_salt"}

# goldens of tests/test_hashing.py (the reference's pinned values)
INPUTS = np.array([0, 1, 2, 0xDEADBEEF, 0x7FFFFFFF], np.uint32)
GOLD_MIX32 = [0x00000000, 0x514E28B7, 0x30F4C306, 0x0DE5C6A9, 0xF9CC0EA8]
GOLD_HASH2 = [0x46D13876, 0x70F7BBF2, 0x8C3E5FDB, 0xBC56A58D, 0xAE93B3F5]
GOLD_HASH3 = [0xCCB1A8F1, 0x8537BDD9, 0x5AE6B032, 0x5BAA5382, 0xD4ABBCFA]


def _leaves(tree, prefix=""):
    if hasattr(tree, "_fields"):
        for name, val in zip(tree._fields, tree):
            yield from _leaves(val, f"{prefix}.{name}" if prefix else name)
    else:
        yield prefix, tree


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_leaf_equal(name, want, got):
    want, got = np.asarray(want), _np(got)
    if name.split(".")[-1] in SALTS:
        assert want.dtype == np.uint32 and got.dtype == np.int64, name
        np.testing.assert_array_equal(want.astype(np.int64), got, err_msg=name)
        return
    assert want.dtype == got.dtype, (name, want.dtype, got.dtype)
    assert want.shape == got.shape, (name, want.shape, got.shape)
    assert want.tobytes() == got.tobytes(), name


def test_port_registers_the_main_path_scenarios():
    need = {"tiny_perm4", "tiny_incast3", "tiny_3t", "tiny_sparse",
            "perm_128n_3t", "perm_512n_3t", "perm_1024n_3t", "alltoall_3t"}
    assert need <= set(tscen.names())
    assert set(tscen.names()) <= set(jscen.names())


@pytest.mark.parametrize("name", tscen.names())
def test_host_tables_and_initial_state_byte_equal(name):
    js, ts = jscen.scenario(name), tscen.scenario(name)
    # workload arrays
    for f in dataclasses.fields(js.wl):
        a, b = getattr(js.wl, f.name), getattr(ts.wl, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name
    jtopo, jtm, jdims, jconsts = jstate.derive(js.cfg, js.wl)
    ttopo, ttm, tdims, tconsts = tstate.derive(ts.cfg, ts.wl, device="cpu")
    # topology and routing tables
    for f in dataclasses.fields(jtopo):
        a, b = getattr(jtopo, f.name), getattr(ttopo, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        elif f.name != "tree":
            assert a == b, f.name
    assert dataclasses.asdict(jtm) == dataclasses.asdict(ttm)
    assert jdims._fields == tdims._fields and tuple(jdims) == tuple(tdims)
    jl, tl = list(_leaves(jconsts)), list(_leaves(tconsts))
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (n, a), (_, b) in zip(jl, tl):
        _assert_leaf_equal(n, a, b)
    jl = list(_leaves(jstate.init_state(jdims, jconsts)))
    tl = list(_leaves(tstate.init_state(tdims, tconsts)))
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (n, a), (_, b) in zip(jl, tl):
        _assert_leaf_equal(n, a, b)


def test_from_numpy_round_trip():
    js = jscen.scenario("tiny_3t")
    jsim = jengine.build(js.cfg, js.wl)
    ref = jax.tree.map(np.asarray, jsim.init())
    st = tstate.from_numpy(ref, "cpu")
    back = tstate.to_numpy(st)
    jl, tl = list(_leaves(ref)), list(_leaves(back))
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (n, a), (_, b) in zip(jl, tl):
        _assert_leaf_equal(n, a, b)


# ------------------------------------------------------------- hashing


def test_mix32_golden():
    out = thash.mix32(torch.from_numpy(INPUTS.astype(np.int64)))
    np.testing.assert_array_equal(out.numpy(), np.array(GOLD_MIX32, np.int64))


def test_hash2_golden():
    out = thash.hash2(torch.from_numpy(INPUTS.astype(np.int64)), 0x1234)
    np.testing.assert_array_equal(out.numpy(), np.array(GOLD_HASH2, np.int64))


def test_hash3_golden():
    x = torch.from_numpy(INPUTS.astype(np.int64))
    out = thash.hash3(x, torch.tensor(7), 9)
    np.testing.assert_array_equal(out.numpy(), np.array(GOLD_HASH3, np.int64))


@pytest.mark.parametrize("salt", [0, 42, -7, 0xECD + 3])
def test_uniform01_matches_reference(salt):
    """uint32 -> f32 rounding, on lanes that wrap i32 the way the RED
    draw's ``t * 131071 + q`` does."""
    from repro.netsim import hashing as jhash
    rng = np.random.default_rng(salt & 0xFFFF)
    lanes = rng.integers(-2**31, 2**31, 20_000, dtype=np.int64).astype(np.int32)
    want = np.asarray(jhash.uniform01(lanes, np.int32(salt)))
    got = thash.uniform01(torch.from_numpy(lanes), torch.tensor(salt, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())


def test_hash2_matches_reference_on_signed_lanes():
    from repro.netsim import hashing as jhash
    rng = np.random.default_rng(3)
    a = rng.integers(-2**31, 2**31, 5000, dtype=np.int64).astype(np.int32)
    b = rng.integers(0, 2**32, 5000, dtype=np.int64).astype(np.uint32)
    want = np.asarray(jhash.hash2(a, b)).astype(np.int64)
    got = thash.hash2(torch.from_numpy(a), torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(want, got.numpy())


# ------------------------------------------------------ import hygiene


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path.name, mod)


# ------------------------------------------------------ no hidden fallback


def test_build_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    sc = tscen.scenario("tiny_perm4")
    with pytest.raises(RuntimeError, match="cuda"):
        tengine.build(sc.cfg, sc.wl)
    with pytest.raises(RuntimeError, match="cuda"):
        sc.build()


@pytest.mark.parametrize("algo", ["swift", "bbr", "eqds", "eqds_smartt"])
def test_unported_algorithm_raises(algo):
    sc = tscen.scenario("tiny_perm4", algo=algo)
    with pytest.raises(KeyError, match="not ported"):
        sc.build(device="cpu")


def test_unknown_backend_raises():
    for field in ("cc_backend", "fabric_backend", "transport_backend"):
        sc = tscen.scenario("tiny_perm4", **{field: "pallas"})
        with pytest.raises(KeyError):
            sc.build(device="cpu")


@pytest.mark.parametrize("faults", [
    (("t1_up", 0, 0, 0),),
    tfaults.FaultSchedule(events=(tfaults.FaultEvent(t=5, kind="t0_up", i=0),)),
])
def test_fault_schedule_raises(faults):
    sc = tscen.scenario("tiny_3t", faults=faults)
    with pytest.raises(NotImplementedError, match="fault"):
        sc.build(device="cpu")


def test_fault_tables_compile_like_the_reference():
    """The host half is ported whole: a schedule compiles to the same
    tables as in the reference (only running it is refused)."""
    sched_t = tfaults.FaultSchedule(
        events=(tfaults.FaultEvent(t=5, kind="t1_up", i=1, j=1, period=0),
                tfaults.FaultEvent(t=9, kind="switch", i=5, period=2)),
        flaps=(tfaults.Flap(kind="t0_up", i=0, j=1, up=3, cycle=7, t=2),))
    sched_j = jfaults.FaultSchedule(
        events=(jfaults.FaultEvent(t=5, kind="t1_up", i=1, j=1, period=0),
                jfaults.FaultEvent(t=9, kind="switch", i=5, period=2)),
        flaps=(jfaults.Flap(kind="t0_up", i=0, j=1, up=3, cycle=7, t=2),))
    tree = tscen.TREE_3T_TINY
    from repro.netsim.topology import build_topology as jbuild
    from repro_torch.netsim.topology import build_topology as tbuild
    cj = jfaults.compile_tables(sched_j, jbuild(tree), 4)
    ct = tfaults.compile_tables(sched_t, tbuild(tree), 4)
    for f in dataclasses.fields(cj):
        a, b = getattr(cj, f.name), getattr(ct, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name
    with pytest.raises(ValueError):
        tfaults.compile_tables(tfaults.lower((("t0_up", 99, 0, 0),)), tbuild(tree))


def test_workload_validate_matches_reference():
    tree = tscen.TREE_TINY
    bad = twl.Workload(name="bad", src=np.array([0, 1], np.int32),
                       dst=np.array([0, 2], np.int32),
                       size=np.array([10, 10], np.int32),
                       t_start=np.zeros(2, np.int32), order=np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="src == dst"):
        bad.validate(n_nodes=tree.n_nodes)
