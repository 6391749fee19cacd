"""PyTorch port, the content-addressed result cache
(``repro_torch.netsim.cache``) on the CPU: the counterparts of
``tests/test_cache.py`` — cache hits bit-equal to fresh lanes (full state
digest), hits and misses counted, every key component keyed, a killed
chunked study resumed bit-equal to an uninterrupted one, wrong-layout and
corrupt entries counted as misses — plus the port's own code digest,
which covers the CUDA sources too, and its own default directory."""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.netsim import cache as jcache  # noqa: E402
from repro_torch.netsim import api, cache, state  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

POINTS = ({}, {"start_cwnd_mult": 0.5})
SEEDS = (0, 1)


def _study():
    return api.study("tiny_incast3", points=POINTS, seeds=SEEDS, device="cpu")


@pytest.fixture(scope="module")
def plain():
    """The uncached, unchunked run every cached path is held to."""
    return _study().run()


def test_cache_hits_are_bit_equal_to_fresh(tmp_path, plain):
    st = _study()
    rc = cache.ResultCache(tmp_path / "c")
    cold = st.run(cache=rc)
    assert (cold.cache_hits, cold.cache_misses) == (0, st.n_lanes)
    assert len(rc) == st.n_lanes
    warm = st.run(cache=rc)
    assert (warm.cache_hits, warm.cache_misses) == (st.n_lanes, 0)
    assert rc.hits == st.n_lanes and rc.puts == st.n_lanes
    assert cache.state_digest(plain.states) == cache.state_digest(cold.states) == \
        cache.state_digest(warm.states)
    assert [r.row() for r in plain.results] == [r.row() for r in warm.results]
    for lane, key in enumerate(st.lane_keys()):
        meta = json.loads((rc.root / f"{key}.json").read_text())
        assert meta["state_digest"] == cache.state_digest(state.lane(plain.states, lane))
        assert meta["row"] == plain.results[lane].row()


def test_new_points_recompute_only_new_lanes(tmp_path):
    rc = cache.ResultCache(tmp_path / "c")
    _study().run(cache=rc)
    grown = api.study("tiny_incast3", points=POINTS + ({"start_cwnd_mult": 0.75},),
                      seeds=SEEDS, device="cpu")
    res = grown.run(cache=rc)
    assert res.cache_hits == len(POINTS) * len(SEEDS)
    assert res.cache_misses == len(SEEDS)
    assert cache.state_digest(res.states) == cache.state_digest(grown.run().states)


def test_seed_point_and_budget_are_all_keyed(tmp_path):
    rc = cache.ResultCache(tmp_path / "c")

    def hits(**kw):
        mt = kw.pop("max_ticks", None)
        return api.study("tiny_incast3", device="cpu", **kw).run(mt, cache=rc).cache_hits
    assert hits(seeds=(0,)) == 0
    assert hits(seeds=(1,)) == 0
    assert hits(points=[{"rto_mult": 5.0}], seeds=(0,)) == 0
    assert hits(seeds=(0,), max_ticks=12_345) == 0
    assert hits(seeds=(0,)) == 1


def test_kill_then_resume_is_bit_equal(tmp_path, monkeypatch, plain):
    """Kill a chunked study after its first chunk flushed; the rerun
    against the same cache resumes from the finished lanes and ends
    bit-equal to the uninterrupted, uncached run."""
    st = _study()
    rc = cache.ResultCache(tmp_path / "c")
    real_put = cache.ResultCache.put
    calls = {"n": 0}

    class Killed(RuntimeError):
        pass

    def dying_put(self, *a, **kw):
        if calls["n"] >= 2:            # let chunk 0 (2 lanes) land
            raise Killed("simulated kill mid-grid")
        calls["n"] += 1
        return real_put(self, *a, **kw)

    monkeypatch.setattr(cache.ResultCache, "put", dying_put)
    with pytest.raises(Killed):
        st.run(cache=rc, chunk_lanes=2)
    monkeypatch.setattr(cache.ResultCache, "put", real_put)
    assert len(rc) == 2
    resumed = st.run(cache=rc, chunk_lanes=2)
    assert (resumed.cache_hits, resumed.cache_misses) == (2, st.n_lanes - 2)
    assert cache.state_digest(resumed.states) == cache.state_digest(plain.states)
    assert [r.row() for r in resumed.results] == [r.row() for r in plain.results]


def test_chunked_uncached_run_matches(plain):
    chunked = _study().run(chunk_lanes=3)
    assert cache.state_digest(chunked.states) == cache.state_digest(plain.states)


def test_wrong_layout_and_corrupt_entries_are_misses(tmp_path, plain):
    """An entry whose leaves do not match the lane's shapes or dtypes, or a
    file that is not an npz, is a miss and that lane recomputes."""
    st = _study()
    rc = cache.ResultCache(tmp_path / "c")
    st.run(cache=rc)
    keys = st.lane_keys()
    (rc.root / f"{keys[0]}.npz").write_bytes(b"not an npz")
    with np.load(rc.root / f"{keys[1]}.npz") as z:
        leaves = dict(z)
    leaves["leaf_0"] = leaves["leaf_0"].astype(np.int64)       # now: i32 -> i64
    np.savez(rc.root / f"{keys[1]}.npz", **leaves)
    with np.load(rc.root / f"{keys[2]}.npz") as z:
        leaves = dict(z)
    leaves["leaf_2"] = leaves["leaf_2"][:1]                     # q_fields cut short
    np.savez(rc.root / f"{keys[2]}.npz", **leaves)
    res = st.run(cache=rc)
    assert (res.cache_hits, res.cache_misses) == (st.n_lanes - 3, 3)
    assert cache.state_digest(res.states) == cache.state_digest(plain.states)


def test_prune_drops_stale_code_entries(tmp_path):
    rc = cache.ResultCache(tmp_path / "c")
    _study().run(cache=rc)
    n = len(rc)
    assert rc.prune() == 0
    (rc.root / "deadbeef.json").write_text('{"code_digest": "old"}')
    (rc.root / "deadbeef.npz").write_bytes(b"")
    assert rc.prune() == 1 and len(rc) == n


# --------------------------------------------------------------------------
# digests
# --------------------------------------------------------------------------


def _tree(root, cu="__global__ void k() {}\n"):
    """A copy of the digest's roots in miniature: a Python package and a
    CUDA source directory."""
    (root / "netsim").mkdir(parents=True)
    (root / "csrc").mkdir()
    (root / "netsim" / "mod.py").write_text("X = 1\n")
    (root / "csrc" / "k.cu").write_text(cu)
    (root / "csrc" / "k.cuh").write_text("#define W 32\n")
    (root / "csrc" / "notes.txt").write_text("not code\n")
    return [root / "netsim", root / "csrc"]


def test_code_digest_covers_python_and_cuda_sources(tmp_path):
    """Editing a .py, a .cu or a .cuh under the roots changes the digest
    (and every lane key); other bytes do not."""
    a, b = _tree(tmp_path / "a"), _tree(tmp_path / "b")
    dig = cache.code_digest(a)
    assert dig == cache.code_digest(b)
    key = cache.lane_key("scen", (), 0, dig)
    (b[1] / "k.cu").write_text("__global__ void k() { }\n")
    assert cache.code_digest(b) != dig
    assert cache.lane_key("scen", (), 0, cache.code_digest(b)) != key
    c = _tree(tmp_path / "c")
    (c[1] / "k.cuh").write_text("#define W 64\n")
    assert cache.code_digest(c) != dig
    d = _tree(tmp_path / "d")
    (d[0] / "mod.py").write_text("X = 2\n")
    assert cache.code_digest(d) != dig
    (a[1] / "notes.txt").write_text("still not code\n")
    assert cache.code_digest(a) == dig


def test_default_code_digest_covers_the_ports_sources():
    """The default digest is stable within a process, hashes the port's
    own tree (the CUDA sources included) and differs from the reference
    package's."""
    d1, d2 = cache.code_digest(), cache.code_digest()
    assert d1 == d2 and len(d1) == 64
    assert d1 == cache.code_digest(cache._CODE_ROOTS)
    assert any(r.name == "csrc" and any(r.glob("*.cu")) for r in cache._CODE_ROOTS)
    assert d1 != jcache.code_digest()


def test_default_directory_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(cache.DEFAULT_DIR_ENV, raising=False)
    monkeypatch.delenv(jcache.DEFAULT_DIR_ENV, raising=False)
    assert cache.default_root() != jcache.default_root()


def test_scenario_digest_sensitivity():
    sc = api._resolve("tiny_incast3")
    d0 = cache.scenario_digest(sc, 1000)
    assert d0 == cache.scenario_digest(sc, 1000)
    assert d0 != cache.scenario_digest(sc, 2000)
    assert d0 != cache.scenario_digest(sc.with_(algo="swift"), 1000)
    wl2 = dataclasses.replace(sc.wl, size=sc.wl.size + 1)
    assert d0 != cache.scenario_digest(sc.with_(wl=wl2), 1000)
