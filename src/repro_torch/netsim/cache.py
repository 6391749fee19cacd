"""Content-addressed result cache for Study lanes (DESIGN.md Sec. 7).

Re-running a sweep should only pay for what changed.  Each lane of a
Study — one ``(scenario, point, seed)`` cell — is keyed by

    lane_key = sha256(scenario_digest · normalized point · seed ·
                      code_digest)

where ``scenario_digest`` fingerprints everything the lane's trajectory
depends on (config repr, the full flow table bytes, the tick budget) and
``code_digest`` fingerprints the port's simulator sources: every ``.py``
under ``repro_torch/{netsim,kernels,core}`` and every ``.cu``/``.cuh``
under ``repro_torch/csrc``, whose kernels compute the tick on the card.
Editing any of them invalidates every cached lane; editing tests,
benchmarks or docs does not.  The engine is deterministic (fixed seeds),
which is what makes final states cacheable by input identity at all.

A hit returns the lane's **full final SimState** (host numpy, bit-exact)
plus the precomputed ``RunResult.row()``; the Study stitches hits and
fresh lanes into one ``StudyResult`` indistinguishable from an uncached
run.  Entries are written atomically (tmp + rename), one ``.npz`` (state
leaves) + ``.json`` (row, state digest, key fields) pair per lane, so a
killed grid resumes from every lane already finished
(``Study.run(chunk_lanes=...)`` flushes per completed chunk).

Stale entries are never wrong, only unused.  ``ResultCache.prune()``
drops entries whose recorded code digest is not the current one, so the
port keeps its own default directory: sharing the reference package's
would let either package's ``prune`` wipe the other's entries.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.netsim import state
from repro_torch.netsim.scenarios import Scenario

# cache format version — bump to orphan every existing entry
_VERSION = 1

# the port's simulator sources: the phases and run loop, the kernels'
# wrappers and plain versions, the CC algorithms, and the CUDA sources
_PACKAGE = Path(__file__).resolve().parents[1]
_CODE_ROOTS = tuple(_PACKAGE / d for d in ("netsim", "kernels", "core", "csrc"))
_CODE_SUFFIXES = (".py", ".cu", ".cuh")


# --------------------------------------------------------------------------
# digests
# --------------------------------------------------------------------------


def _hash_tree_files(roots) -> str:
    h = hashlib.sha256()
    for root in roots:
        root = Path(root)
        for p in sorted(q for q in root.rglob("*") if q.suffix in _CODE_SUFFIXES):
            h.update(str(p.relative_to(root)).encode())
            h.update(b"\0")
            h.update(p.read_bytes())
            h.update(b"\0")
    return h.hexdigest()


@functools.lru_cache(maxsize=1)
def _default_code_digest() -> str:
    return _hash_tree_files(_CODE_ROOTS)


def code_digest(roots=None) -> str:
    """sha256 over the simulator's sources (sorted relpath + bytes of every
    ``.py``, ``.cu`` and ``.cuh`` under ``repro_torch/{netsim,kernels,core,
    csrc}``, or under the explicit ``roots``).  Any source edit — an
    algorithm tweak, a kernel fix — changes the digest and orphans every
    cached lane; the default digest is computed once per process."""
    if roots is None:
        return _default_code_digest()
    return _hash_tree_files(tuple(roots))


def _update_value(h, v):
    """Feed one digest component: arrays by dtype/shape/bytes, everything
    else by repr."""
    if isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    else:
        h.update(repr(v).encode())
    h.update(b"\0")


def scenario_digest(sc: Scenario, max_ticks: int) -> str:
    """Fingerprint of everything a lane's trajectory depends on besides
    (point, seed, code): the scenario name, the full ``SimConfig`` repr
    (frozen dataclass of primitives/tuples — stable), the workload's flow
    table bytes, and the effective tick budget."""
    h = hashlib.sha256()
    _update_value(h, ("netsim-scenario", _VERSION))
    _update_value(h, sc.name)
    _update_value(h, sc.cfg)
    wl = sc.wl
    _update_value(h, (wl.name, int(wl.window)))
    for arr in (wl.src, wl.dst, wl.size, wl.t_start, wl.order):
        _update_value(h, np.asarray(arr))
    # dependency table + collective grouping; the "none" marker keeps an
    # absent column distinguishable from any real array
    for arr in (wl.dep_par, wl.dep_thr, wl.coll_id):
        _update_value(h, "none" if arr is None else np.asarray(arr))
    _update_value(h, int(max_ticks))
    return h.hexdigest()


def lane_key(scenario_dig: str, point, seed: int,
             code_dig: str | None = None) -> str:
    """Content address of one Study lane.  ``point`` is the normalized
    ``((key, value), ...)`` tuple (``api._norm_point``)."""
    if code_dig is None:
        code_dig = code_digest()
    h = hashlib.sha256()
    _update_value(h, ("netsim-lane", _VERSION))
    _update_value(h, scenario_dig)
    _update_value(h, tuple(point))
    _update_value(h, int(seed))
    _update_value(h, code_dig)
    return h.hexdigest()


def state_digest(tree) -> str:
    """sha256 over a state's leaves (dtype/shape/bytes of every leaf, on
    the host or the device) — the bit-for-bit equality currency of the
    parity tests and the cache-integrity check."""
    h = hashlib.sha256()
    for leaf in state.tree_leaves(state.to_numpy(tree)):
        _update_value(h, np.asarray(leaf))
    return h.hexdigest()


# --------------------------------------------------------------------------
# the cache
# --------------------------------------------------------------------------


DEFAULT_DIR_ENV = "NETSIM_TORCH_CACHE_DIR"


def default_root() -> Path:
    """``$NETSIM_TORCH_CACHE_DIR`` or ``.netsim_torch_cache`` under the CWD."""
    return Path(os.environ.get(DEFAULT_DIR_ENV, ".netsim_torch_cache"))


@dataclasses.dataclass(eq=False, repr=False)
class ResultCache:
    """Directory-backed lane cache: ``<key>.npz`` (final-state leaves, in
    field order) + ``<key>.json`` (row, state digest, key fields).

    Counters ``hits``/``misses``/``puts`` count lookups and writes."""

    root: Path
    hits: int = 0
    misses: int = 0
    puts: int = 0

    def __post_init__(self):
        self.root = Path(self.root)
        self.root.mkdir(parents=True, exist_ok=True)

    def reset_counters(self):
        self.hits = self.misses = self.puts = 0

    def _paths(self, key: str) -> tuple[Path, Path]:
        return self.root / f"{key}.npz", self.root / f"{key}.json"

    def get(self, key: str, struct):
        """Look up one lane.  ``struct`` is a lane's ``SimState`` with host
        leaves (the init state's): entries whose leaves do not match its
        shapes and dtypes exactly (layout drift the code digest did not
        catch, partially written files) are misses.  Returns ``(state,
        row)`` host-side, or ``None``."""
        npz_p, json_p = self._paths(key)
        if not (npz_p.exists() and json_p.exists()):
            self.misses += 1
            return None
        want = state.tree_leaves(struct)
        try:
            meta = json.loads(json_p.read_text())
            with np.load(npz_p) as z:
                leaves = [z[f"leaf_{i}"] for i in range(len(want))]
        except Exception:
            self.misses += 1
            return None
        for got, w in zip(leaves, want):
            if got.shape != np.shape(w) or got.dtype != np.asarray(w).dtype:
                self.misses += 1
                return None
        self.hits += 1
        return state.tree_unflatten(struct, leaves), meta["row"]

    def put(self, key: str, lane_state, row: dict, extra: dict | None = None):
        """Write one finished lane atomically (tmp + rename — a killed
        writer leaves no partial entry, so resume is always safe)."""
        npz_p, json_p = self._paths(key)
        leaves = [np.asarray(x) for x in
                  state.tree_leaves(state.to_numpy(lane_state))]
        meta = dict(version=_VERSION, row=row,
                    state_digest=state_digest(lane_state),
                    **(extra or {}))
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
            os.replace(tmp, npz_p)
        except BaseException:
            os.unlink(tmp)
            raise
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".json.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, json_p)
        except BaseException:
            os.unlink(tmp)
            raise
        self.puts += 1

    def prune(self, keep_code_dig: str | None = None) -> int:
        """Drop entries not written under ``keep_code_dig`` (default: the
        current code digest).  Returns the number of entries removed."""
        if keep_code_dig is None:
            keep_code_dig = code_digest()
        n = 0
        for json_p in self.root.glob("*.json"):
            try:
                meta = json.loads(json_p.read_text())
            except Exception:
                meta = {}
            if meta.get("code_digest") != keep_code_dig:
                json_p.unlink(missing_ok=True)
                json_p.with_suffix(".npz").unlink(missing_ok=True)
                n += 1
        return n

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("*.json"))

    def __repr__(self) -> str:
        return (f"ResultCache({self.root}: {len(self)} entries, "
                f"hits={self.hits} misses={self.misses} puts={self.puts})")


def resolve(cache) -> ResultCache | None:
    """Normalize ``Study.run``'s ``cache=`` argument: ``None`` -> no
    caching, ``True`` -> the default directory, a path -> that directory,
    a :class:`ResultCache` -> itself."""
    if cache is None or isinstance(cache, ResultCache):
        return cache
    if cache is True:
        return ResultCache(default_root())
    return ResultCache(Path(cache))
