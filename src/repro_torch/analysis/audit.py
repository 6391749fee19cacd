"""Op auditor: record the engine's tick programs and machine-check their
invariants (DESIGN.md Sec. 10), the counterpart of ``repro.analysis.audit``.

The reference traces jaxprs; the port is eager, so the auditor *runs* each
program once under a recorder (:class:`Recorder`: a ``TorchDispatchMode``
for the aten ops, a ``TorchFunctionMode`` for the host reads that dispatch
nothing on the CPU) and keeps, for every op, its name, the dtypes of its
inputs and outputs, and its use-def edges.  For every registered scenario,
on each backend (``"plain"``: every phase's plain version; ``"kernel"``:
the fused launches on the card), on a batch of one lane advanced a few
ticks so work is in flight, it records

  * ``init``    — ``Sim.init()`` (the tick-0 build),
  * each of the six ``Sim.lane_phases`` as ``Sim.tick`` runs them, with
    the host's tick passed in (nothing reads ``st.now``),
  * ``step``    — ``Sim.step(st, t)``,
  * ``horizon`` — ``Sim.horizon(st, t)``,

each twice, at consecutive ticks, and applies the ``JX00x`` rules of
``analysis/rules.py``: wide-dtype leaks, convert churn, host syncs,
per-phase scatter/gather budgets.  Beside the op counts a row holds the
custom kernel launches of the program (read from the kernels' own
counters: a ctypes launch is invisible to the recorder), its host syncs,
and whether its op sequence is the same at both ticks (the counterpart of
a jaxpr being one static program; a CUDA graph over the tick needs it).
Aliased state leaves (JX004) are checked on real states — storage
overlap, not recording.  JX006 perturbs every scalar ``SimConfig`` field
through ``state.derive`` and cross-checks the Dims/Consts impact against
``api.apply_point``'s accept/reject sets.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
import os
import pkgutil
import sys
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.rules import (GATHER_OPS, HOST_READS, PHASE_BUDGETS,
                                        SCATTER_OPS, SYNC_OPS, WIDE_DTYPES,
                                        Finding, finding)

_PKG = os.path.realpath(Path(__file__).parents[1]) + "/"    # src/repro_torch/
_SELF = os.path.realpath(Path(__file__).parent) + "/"       # .../analysis/

PROGRAMS = ("init", "departures", "arrivals", "control", "grants", "sends",
            "metrics", "step", "horizon")


# --------------------------------------------------------------------------
# recording
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Op:
    """One recorded op: an aten op, or a host read at the Python level."""

    name: str              # "aten.add.Tensor", or "Tensor.tolist"
    family: str            # the overload packet ("add"), or the read's name
    ins: tuple             # recorder ids of the input tensors
    outs: tuple            # recorder ids of the output tensors
    in_dtypes: tuple
    out_dtypes: tuple
    sync: str | None = None    # the host sync it is, if it is one
    where: str | None = None   # the port's function that ran it (syncs and
                               # wide sources only: "netsim/hashing.py:u32")
    nested: bool = False       # dispatched inside a host read already counted
    nbytes: int = 0            # bytes of its outputs
    moves: bool = False        # a copy to another device (no conversion)


_REL: dict = {}


def _rel(filename: str) -> str | None:
    """A code file's path under src/repro_torch (None outside the port or
    inside this package), resolved once per file."""
    rel = _REL.get(filename, 0)
    if rel == 0:
        fn = os.path.realpath(filename)
        rel = _REL[filename] = (fn[len(_PKG):] if fn.startswith(_PKG)
                                and not fn.startswith(_SELF) else None)
    return rel


def _where() -> str:
    """``path:function`` of the innermost frame in the port outside this
    package (the code under audit that ran the op)."""
    f = sys._getframe(2)
    while f is not None:
        rel = _rel(f.f_code.co_filename)
        if rel is not None:
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


def _arg_names(func, n: int, kwargs) -> list:
    """The schema names of ``n`` positional arguments, then the keywords."""
    names = [a.name for a in func._schema.arguments[:n]]
    return names + [""] * (n - len(names)) + list(kwargs)


class Recorder:
    """Record what one call runs: ``with Recorder() as r: out = fn()``."""

    def __init__(self):
        self.ops: list[Op] = []
        self._ids = WeakIdKeyDictionary()
        self._next = 0
        self._reading = 0          # depth of Python-level host reads
        self.launch_operands: set = set()   # ids whose data_ptr was taken
        rec = self

        class _Dispatch(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                with torch._C.DisableTorchFunction():
                    rec._on_op(func, args, kwargs, out)
                return out

        class _Function(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = getattr(func, "__name__", "")
                if name == "data_ptr" and args and isinstance(args[0], torch.Tensor):
                    rec.launch_operands.add(rec._id(args[0]))
                if name == "to" and args and isinstance(args[0], torch.Tensor):
                    name = "cpu" if _to_host(args, kwargs) else ""
                if name not in HOST_READS or not (args and isinstance(args[0], torch.Tensor)):
                    return func(*args, **kwargs)
                rec._on_read(name, args[0])
                rec._reading += 1
                try:
                    return func(*args, **kwargs)
                finally:
                    rec._reading -= 1

        self._modes = (_Function(), _Dispatch())

    def __enter__(self) -> "Recorder":
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False

    def _id(self, t: torch.Tensor) -> int:
        i = self._ids.get(t)
        if i is None:
            i = self._ids[t] = self._next
            self._next += 1
        return i

    def ids(self, tree) -> set:
        """Recorder ids of the tensors of ``tree`` (those seen or new)."""
        return {self._id(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}

    def _on_read(self, name: str, t: torch.Tensor) -> None:
        if self._reading:
            return
        self.ops.append(Op(name=f"Tensor.{name}", family=name, ins=(self._id(t),), outs=(),
                           in_dtypes=(str(t.dtype),), out_dtypes=(), sync=f"Tensor.{name}",
                           where=_where()))

    def _on_op(self, func, args, kwargs, out) -> None:
        ins, in_dt, bool_index = [], [], False
        values = list(args) + list(kwargs.values())
        for arg, a in zip(_arg_names(func, len(args), kwargs), values):
            for t in tree_leaves(a):
                if isinstance(t, torch.Tensor):
                    ins.append(self._id(t))
                    in_dt.append(str(t.dtype))
                    bool_index |= arg in ("index", "indices") and t.dtype in (
                        torch.bool, torch.uint8)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        family = func.overloadpacket.__name__
        name = str(func)
        sync = None
        if family in SYNC_OPS:
            sync = name
        elif family in ("index", "index_put", "index_put_") and bool_index:
            sync = f"{name}[bool]"
        elif family == "repeat_interleave" and name.endswith(".Tensor") \
                and kwargs.get("output_size") is None:
            sync = name
        elif family in ("_to_copy", "copy_") and _device_to_host(family, args, kwargs):
            sync = f"{name}[to host]"
        out_dt = tuple(str(t.dtype) for t in outs)
        wide_src = any(d in WIDE_DTYPES for d in out_dt) and not any(
            d in WIDE_DTYPES for d in in_dt)
        self.ops.append(Op(
            name=name, family=family, ins=tuple(ins), outs=tuple(self._id(t) for t in outs),
            in_dtypes=tuple(in_dt), out_dtypes=out_dt, sync=sync,
            where=_where() if (sync or wide_src) else None, nested=self._reading > 0,
            nbytes=sum(t.numel() * t.element_size() for t in outs),
            moves=family == "_to_copy" and kwargs.get("device") is not None
            and torch.device(kwargs["device"]).type != args[0].device.type))


def _to_host(args, kwargs) -> bool:
    """Is ``Tensor.to(...)`` a copy of a device tensor to the CPU?"""
    if args[0].device.type == "cpu":
        return False
    for a in list(args[1:]) + list(kwargs.values()):
        if isinstance(a, (str, torch.device)) and torch.device(a).type == "cpu":
            return True
    return False


def _device_to_host(family, args, kwargs) -> bool:
    """Is a ``_to_copy`` / ``copy_`` a copy of a device tensor to the CPU?"""
    if family == "_to_copy":
        dev = kwargs.get("device")
        return dev is not None and torch.device(dev).type == "cpu" \
            and args[0].device.type != "cpu"
    dst, src = args[0], args[1]
    return dst.device.type == "cpu" and src.device.type != "cpu"


@dataclasses.dataclass
class Program:
    """One recorded call: its ops, its output, and what it launched."""

    ops: list
    out: object
    out_ids: set            # the output's tensors (they escape the program)
    launch_operands: set    # tensors handed to a ctypes launch
    launches: dict          # kernel name -> launches during the call
    wide_inputs: list       # (dtype, label) of wide tensors read but not made here

    @property
    def sequence(self) -> tuple:
        return tuple(op.name for op in self.ops)


def record(fn, consts_labels: dict | None = None) -> Program:
    """Run ``fn()`` once under a :class:`Recorder`.  ``consts_labels`` maps
    a storage's data pointer to a constant's name, so a wide constant read
    is named (``consts.q_salt``)."""
    before = launch_counts()
    with Recorder() as r:
        out = fn()
    after = launch_counts()
    out_ids = r.ids(out)
    made = {i for op in r.ops for i in op.outs}
    wide_inputs, seen = [], set()
    labels = consts_labels or {}
    for op in r.ops:
        for i, d in zip(op.ins, op.in_dtypes):
            if d in WIDE_DTYPES and i not in made and (i, d) not in seen:
                seen.add((i, d))
                wide_inputs.append((d, i))
    # name the wide inputs through the tensors still alive
    by_id = {i: t for t, i in r._ids.items()}
    named = []
    for d, i in wide_inputs:
        t = by_id.get(i)
        label = "input"
        if t is not None and t.numel():
            label = labels.get(t.untyped_storage().data_ptr(), "input")
        named.append((d, label))
    return Program(ops=r.ops, out=out, out_ids=out_ids, launch_operands=r.launch_operands,
                   launches={k: after[k] - before[k] for k in after if after[k] != before[k]},
                   wide_inputs=sorted(set(named)))


@functools.cache
def launch_wrappers() -> tuple:
    """Every kernel wrapper that counts its launches: each callable of a
    ``repro_torch/kernels/<name>/kernel.py`` with an int ``launches``."""
    import repro_torch.kernels as kernels
    found = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        if not info.ispkg:
            continue
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}.kernel")
        for fn in vars(mod).values():
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                found[fn.__name__] = fn
    return tuple(found[k] for k in sorted(found))


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter (``<wrapper>.launches``)."""
    return {f.__name__: f.launches for f in launch_wrappers()}


# --------------------------------------------------------------------------
# op statistics (the rows)
# --------------------------------------------------------------------------


def _converts(op: Op) -> bool:
    return op.family == "_to_copy" and op.in_dtypes[:1] != op.out_dtypes[:1]


@dataclasses.dataclass
class OpStats:
    """Aggregate facts of one recorded program."""

    ops: int = 0
    scatter: int = 0
    gather: int = 0
    convert: int = 0
    syncs: int = 0
    est_bytes: int = 0            # bytes of every op's outputs: an upper
                                  # bound on un-fused intermediate traffic

    def row(self) -> dict:
        return dict(aten_ops=self.ops, scatter_ops=self.scatter,
                    gather_ops=self.gather, convert_ops=self.convert,
                    host_syncs=self.syncs, est_mb=round(self.est_bytes / 1e6, 3))


def op_stats(prog: Program) -> OpStats:
    """Count the op families the budgets and the rows track."""
    st = OpStats()
    for op in prog.ops:
        if op.sync and not op.nested:
            st.syncs += 1
        if op.name.startswith("Tensor."):
            continue
        st.ops += 1
        st.est_bytes += op.nbytes
        if op.family in SCATTER_OPS:
            st.scatter += 1
        elif op.family in GATHER_OPS:
            st.gather += 1
        elif _converts(op):
            st.convert += 1
    return st


# --------------------------------------------------------------------------
# JX001 / JX002 / JX003 / JX005 — per-program rules
# --------------------------------------------------------------------------


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name.split(".", 1)[1])


def _wide_dtype_findings(prog: Program, site: str) -> list:
    """JX001: every op that introduces a 64-bit value and every wide input
    read, deduped per token."""
    seen, out = set(), []
    for op in prog.ops:
        if op.nested or not op.out_dtypes:
            continue
        if any(d in WIDE_DTYPES for d in op.in_dtypes):
            continue                       # derived: reported at its source
        for d in op.out_dtypes:
            if d in WIDE_DTYPES:
                token = f"{d[6:]}@{op.name}@{op.where}"
                if token not in seen:
                    seen.add(token)
                    out.append(finding(
                        "JX001", site, token,
                        f"{d[6:]} value made by {op.name} in {op.where} "
                        "(x32 contract: DESIGN.md Sec. 6)"))
    for d, label in prog.wide_inputs:
        token = f"{d[6:]}@{'consts.' + label if label != 'input' else label}"
        if token not in seen:
            seen.add(token)
            out.append(finding("JX001", site, token,
                               f"the program reads a {d[6:]} {token.split('@')[1]}"))
    return out


def _kind(d: torch.dtype) -> str:
    if d == torch.bool:
        return "b"
    if d.is_complex:
        return "c"
    if d.is_floating_point:
        return "f"
    return "i" if d.is_signed else "u"


def _chain_redundant(a: torch.dtype, b: torch.dtype, c: torch.dtype) -> bool:
    """Is convert a->b->c (middle used once) collapsible to a->c?

    Conservative, as the reference's: b == c (the second hop is a no-op),
    a bool source (any middle is lossless), or a same-kind widening."""
    if b == c:
        return True
    if a == torch.bool:
        return True
    return _kind(a) == _kind(b) and b.itemsize >= a.itemsize


def _convert_findings(prog: Program, site: str) -> list:
    """JX002: self-converts and collapsible convert chains."""
    consumers: dict = {}
    for op in prog.ops:
        for i in set(op.ins):
            consumers.setdefault(i, []).append(op)
    used = prog.out_ids | prog.launch_operands
    out = []
    for op in prog.ops:
        if op.family != "_to_copy" or op.moves or op.sync or not op.outs or not op.ins:
            continue
        src, dst = _dt(op.in_dtypes[0]), _dt(op.out_dtypes[0])
        if src == dst:
            out.append(finding(
                "JX002", site, f"{src}->{dst}".replace("torch.", ""),
                f"self-convert {src}->{dst} (a no-op cast materialized)"))
            continue
        (o,) = op.outs
        uses = consumers.get(o, [])
        if o not in used and len(uses) == 1 and uses[0].family == "_to_copy" \
                and not uses[0].moves and not uses[0].sync:
            final = _dt(uses[0].out_dtypes[0])
            if _chain_redundant(src, dst, final):
                token = f"{src}->{dst}->{final}".replace("torch.", "")
                out.append(finding(
                    "JX002", site, token,
                    f"convert chain {token} collapses to {src}->{final}"))
    return out


def _sync_findings(prog: Program, site: str) -> list:
    """JX003: host syncs anywhere in the program, deduped per token."""
    out, seen = [], set()
    for op in prog.ops:
        if op.sync and not op.nested:
            token = f"{op.sync}@{op.where}"
            if token not in seen:
                seen.add(token)
                out.append(finding(
                    "JX003", site, token,
                    f"host sync {op.sync} in {op.where} inside a tick program "
                    "(serializes the tick on a host round-trip; no CUDA graph "
                    "can capture it)"))
    return out


def check_program(prog: Program, site: str, budgets: dict | None = None) -> list:
    """All per-program rules (JX001/JX002/JX003, and JX005 when a
    ``{"scatter": n, "gather": n}`` budget is supplied)."""
    out = (_wide_dtype_findings(prog, site) + _convert_findings(prog, site)
           + _sync_findings(prog, site))
    if budgets:
        st = op_stats(prog)
        for fam, have in (("scatter", st.scatter), ("gather", st.gather)):
            cap = budgets.get(fam)
            if cap is not None and have > cap:
                out.append(finding(
                    "JX005", site, f"{fam}={have}",
                    f"{fam} op count {have} exceeds budget {cap} "
                    "(rules.PHASE_BUDGETS)"))
    return out


# --------------------------------------------------------------------------
# JX004 — aliased state leaves (storage overlap, not recording)
# --------------------------------------------------------------------------


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _leaves_with_paths(v, f"{prefix}.{f}" if prefix else f)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{prefix}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _extent(t: torch.Tensor) -> tuple:
    """The byte range ``[lo, hi)`` of a tensor's storage that it covers."""
    lo = t.storage_offset()
    hi = lo + 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride()) if s > 0)
    base = t.untyped_storage().data_ptr()
    return base + lo * t.element_size(), base + hi * t.element_size()


def check_aliasing(tree, site: str) -> list:
    """JX004: two tensor leaves of ``tree`` whose storages overlap."""
    spans = []
    for label, t in _leaves_with_paths(tree):
        if t.numel():
            spans.append((t.device, *_extent(t), label))
    spans.sort(key=lambda s: (str(s[0]), s[1]))
    out = []
    for (d0, lo0, hi0, a), (d1, lo1, hi1, b) in zip(spans, spans[1:]):
        if d0 == d1 and lo1 < hi0:
            out.append(finding(
                "JX004", site, b,
                f"state leaf {b} overlaps {a} (one storage, two leaves — an "
                "in-place update of one writes the other)"))
    return out


# --------------------------------------------------------------------------
# JX006 — SimConfig sweepability classification
# --------------------------------------------------------------------------


def _perturb(value):
    """A nearby-but-different value of the same scalar type."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 1
    if isinstance(value, float):
        return value * 1.5 + 0.25
    return None


def _leaf_sig(consts):
    from repro_torch.netsim import state
    return [(tuple(x.shape), x.dtype) for x in state.tree_leaves(consts)]


def config_table() -> dict:
    """Every ``SimConfig`` field's empirical impact, perturbed alone through
    ``state.derive`` on the CPU: ``{field: {"dims": bool, "consts": bool}}``
    (Dims changed; Consts leaves' shapes or dtypes changed), ``None`` for a
    structural field (no scalar perturbation), or the exception's text for
    a perturbation that ``derive`` refused."""
    from repro_torch.netsim import state
    from repro_torch.netsim.scenarios import scenario

    sc = scenario("tiny_3t")
    base = sc.cfg
    _, _, dims0, consts0 = state.derive(base, sc.wl, "cpu")
    sig0 = _leaf_sig(consts0)
    out = {}
    for field in dataclasses.fields(state.SimConfig):
        new = _perturb(getattr(base, field.name))
        if new is None:
            out[field.name] = None
            continue
        try:
            _, _, dims2, consts2 = state.derive(
                dataclasses.replace(base, **{field.name: new}), sc.wl, "cpu")
        except Exception as e:          # perturbation hit a validation wall
            out[field.name] = f"{type(e).__name__}: {e}"
            continue
        out[field.name] = dict(dims=dims2 != dims0, consts=_leaf_sig(consts2) != sig0)
    return out


def classify_config(site: str = "simconfig") -> list:
    """JX006: cross-check the empirical Dims/Consts impact of every scalar
    SimConfig field against ``api.apply_point``'s sets."""
    from repro_torch.core.types import make_cc_params
    from repro_torch.netsim import api
    from repro_torch.netsim.scenarios import scenario

    out = []
    base_cfg = scenario("tiny_3t").cfg
    for name, impact in config_table().items():
        if impact is None:
            # structural field (configs, strings, tuples): must be
            # rejected by apply_point -> STATIC_KEYS
            if name not in api.STATIC_KEYS:
                out.append(finding(
                    "JX006", site, name,
                    f"structural field {name!r} is not in api.STATIC_KEYS "
                    f"— apply_point rejects it only via the generic "
                    f"unknown-key branch, with a misleading message"))
            continue
        if isinstance(impact, str):
            out.append(finding(
                "JX006", site, name,
                f"cannot classify {name!r}: derive raised {impact}"))
            continue
        rebuilds = impact["dims"] or impact["consts"]
        if rebuilds and name in api.CFG_KEYS:
            out.append(finding(
                "JX006", site, name,
                f"field {name!r} is listed sweepable (CFG_KEYS) but changing "
                f"it changes the Dims or the Consts leaves' shapes/dtypes"))
        if rebuilds and name not in api.STATIC_KEYS:
            out.append(finding(
                "JX006", site, name,
                f"field {name!r} changes Dims/leaf shapes but is not in "
                f"api.STATIC_KEYS — apply_point would not name it as "
                f"Dims-changing"))
        if not rebuilds and name not in (api.CFG_KEYS | api.STATIC_KEYS):
            out.append(finding(
                "JX006", site, name,
                f"field {name!r} is unclassified: neither sweepable "
                f"(CFG_KEYS) nor static (STATIC_KEYS)"))

    # apply_point must actually reject every static key...
    for key in sorted(api.STATIC_KEYS):
        try:
            api.apply_point(base_cfg, {key: getattr(base_cfg, key, 0)})
        except KeyError:
            pass
        else:
            out.append(finding(
                "JX006", site, key,
                f"api.apply_point accepted static key {key!r}"))
    # ...and every CC tuning key must exist on make_cc_params
    params = set(inspect.signature(make_cc_params).parameters)
    for key in sorted(api.CC_PARAM_KEYS - params):
        out.append(finding(
            "JX006", site, key,
            f"CC_PARAM_KEYS entry {key!r} is not a make_cc_params kwarg"))
    return out


# --------------------------------------------------------------------------
# scenario audits
# --------------------------------------------------------------------------

BACKENDS = ("kernel", "plain")
_BACKEND_FIELDS = ("cc_backend", "departures_backend", "fabric_backend",
                   "sender_backend", "transport_backend")


def backend_cfg(cfg, backend: str):
    """The scenario's config with every hot-loop backend set to
    ``backend`` (``"kernel"``: the fused launches on the card; ``"plain"``:
    the plain versions everywhere)."""
    return dataclasses.replace(cfg, **{f: backend for f in _BACKEND_FIELDS})


def _consts_labels(consts) -> dict:
    """A storage's data pointer -> the name of the constant that owns it."""
    return {t.untyped_storage().data_ptr(): label
            for label, t in _leaves_with_paths(consts) if t.numel()}


# spin kernels launched around a profiled call, left out of its count: a
# short torch.profiler window was seen to lose device records at its ends
# (in a process that had run a long profiler session before)
_PAD = 64


def _profiled(fn, prof: bool):
    """``fn()`` and the device kernels ``torch.profiler`` saw it launch in
    a session of its own (``None`` unless ``prof``)."""
    if not prof:
        return fn(), None
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        pad()
        out = fn()
        torch.cuda.synchronize()
        pad()
    return out, sum(e.count for e in p.key_averages()
                    if e.device_type.name == "CUDA" and "spin_kernel" not in e.key)


def profiler_kernels(counts, launches: int) -> int | None:
    """A program's device kernels a call from the counts of its two
    profiled calls (one session each, consecutive ticks of a program that
    runs one op sequence): ``None`` (not measured) unless the two agree
    and cover the program's own launches, since a session that loses
    records is not told apart otherwise."""
    a, b = counts
    return a if a == b and a >= launches else None


def _advance(sim, ticks: int):
    """A batch of one lane of ``sim`` run ``ticks`` ticks from tick 0 as
    ``Sim.run`` runs it (leaps included), and its host tick."""
    from repro_torch.netsim import shard, state
    st = state.init_lanes(sim.dims, sim.consts, None, [0])
    st = shard._run_lanes(sim, sim.consts, None, st, int(ticks))
    return st, int(st.now[0])


def record_programs(sim, ticks: int | None = None, profile: bool = False) -> dict:
    """Record the nine programs of ``sim`` twice each, at consecutive
    ticks, on a batch of one lane advanced ``ticks`` ticks (default: one
    base RTT and two, so ACKs are returning).  Returns ``{program: (first,
    second, profiler kernels of both or None, tick of the first)}``
    (``init``'s tick None; ``init`` is not profiled)."""
    from repro_torch.kernels.lanes import Tick
    from repro_torch.netsim import state

    ticks = sim.dims.brtt_inter + 2 if ticks is None else int(ticks)
    labels = _consts_labels(sim.consts)

    def rec(fn):
        return _profiled(lambda: record(fn, labels), profile)

    out = {"init": (record(sim.init, labels), record(sim.init, labels), None, None)}
    st, t = _advance(sim, ticks)
    c = sim.lanes_of(None, 1)
    live = torch.ones((1,), dtype=torch.bool, device=sim.device)
    recs = {name: [] for name, _ in sim.lane_phases}
    for rep in range(2):
        k = Tick(st.now, live, (t + rep,), (True,))
        for name, fn in sim.lane_phases:
            recs[name].append(rec(lambda: fn(c, st, k)))
            st = recs[name][-1][0].out
        st = st._replace(now=st.now + live)
    t0 = t
    t += 2
    one = sim.step(state.lane(st, 0), t)     # unrecorded: fills the step's caches
    t += 1
    recs["horizon"], recs["step"] = [], []
    for rep in range(2):
        recs["horizon"].append(rec(lambda: sim.horizon(one, t + rep)))
        recs["step"].append(rec(lambda: sim.step(one, t + rep)))
        one = recs["step"][-1][0].out
    for name, ((p1, k1), (p2, k2)) in recs.items():
        out[name] = (p1, p2, None if k1 is None else (k1, k2),
                     t if name in ("horizon", "step") else t0)
    return out


def audit_scenario(sc, backends=BACKENDS, per_phase: bool = True, device="cuda",
                   ticks: int | None = None, profile: bool = False):
    """Record and rule-check one scenario on each backend, on ``device``
    (the card unless the caller asks for the CPU).

    Returns ``(findings, rows)``: findings from JX001/002/003/005 over
    init, the six phases, the step, and the horizon, plus JX004 on a real
    single-lane state and a lane batch.  ``rows`` hold op counts, custom
    launches, host syncs and the two ticks' sameness per program
    (``profile``: also the device kernels ``torch.profiler`` saw in each
    call, on the card, and :func:`profiler_kernels` of the two)."""
    from repro_torch.netsim import engine, state

    findings: list[Finding] = []
    rows: list[dict] = []
    for backend in backends:
        sim = engine.build(backend_cfg(sc.cfg, backend), sc.wl, device=device)
        site_base = f"{sc.name}/{backend}"
        progs = record_programs(sim, ticks, profile=profile and sim.device.type == "cuda")
        for pname in PROGRAMS:
            first, second, kern, tick = progs[pname]
            site = f"{site_base}/{pname}"
            budgets = PHASE_BUDGETS.get(pname) if backend == "plain" else None
            findings.extend(check_program(first, site, budgets=budgets))
            findings.extend(f for f in check_program(second, site, budgets=budgets)
                            if f not in findings)
            if per_phase or pname == "step":
                stats = op_stats(first)
                rows.append(dict(
                    name=site, scenario=sc.name, backend=backend, program=pname,
                    device=str(sim.device.type), tick=tick,
                    **stats.row(), launches=sum(first.launches.values()),
                    launches_by_kernel=dict(first.launches),
                    static=first.sequence == second.sequence
                    and first.launches == second.launches,
                    **({"profiler_kernels_raw": list(kern),
                        "profiler_kernels": profiler_kernels(kern, sum(first.launches.values()))}
                       if kern is not None else {})))
    base = engine.build(sc.cfg, sc.wl, device=device)
    findings.extend(check_aliasing(base.init(), f"{sc.name}/init"))
    findings.extend(check_aliasing(
        state.init_lanes(base.dims, base.consts, None, [0, 1]), f"{sc.name}/init_lanes"))
    return findings, rows


# per-phase rows are recorded for these scenarios (the tiered paper-scale
# set); everything else contributes step-level rows only
PER_PHASE_SCENARIOS = ("tiny_3t", "perm_512n_3t", "perm_1024n_3t")


def audit_catalogue(names=None, backends=BACKENDS, progress=None, device="cuda"):
    """Audit every registered scenario (aliases deduped) + JX006.

    Returns ``(findings, rows)`` over the whole catalogue."""
    from repro_torch.netsim import scenarios

    if names is None:
        names = scenarios.names()
    seen, resolved = set(), []
    for name in names:
        sc = scenarios.scenario(name)
        if sc.name not in seen:      # aliases resolve to one canonical name
            seen.add(sc.name)
            resolved.append(sc)

    findings, rows = [], []
    for sc in resolved:
        if progress:
            progress(sc.name)
        f, r = audit_scenario(sc, backends=backends, device=device,
                              per_phase=sc.name in PER_PHASE_SCENARIOS)
        findings.extend(f)
        rows.extend(r)
    findings.extend(classify_config())
    return findings, rows
