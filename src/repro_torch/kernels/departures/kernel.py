"""ctypes wrapper of the fused departures-phase kernel (``csrc/departures.cu``).

One launch runs the whole departures phase (``ref.departures_ref``'s
contract) for every lane of a batch (``kernels/lanes``): one grid row a
lane, one thread a port evaluates its service period, takes its
head-of-line packet with the RED mark, routes it, writes its wire row
(zeros where it does not emit), advances its head and size, and the
blackholed packets are added to its lane's ``n_black`` once a block.
Each lane reads its tick and gate from the device (``Tick.now``,
``Tick.live``) and derives its wire slots from the tick; a lane that is
not live is left as it was.

The argument block holds every operand, ``[L, ...]`` each (a constant
shared by all lanes as an ``expand``-ed view, passed once with lane
stride 0), and is built once per run and thread (``lanes.thread_cache``:
each shard of a batch keeps its own), when the wrapper first sees a
run's buffers, after checking every operand; on later ticks the wrapper
checks that the operands are the same tensors (the block holds them, so
their storage cannot be reused).  No phase replaces any of them within a
run: this phase updates ``q_head``, ``q_size``, the wire and ``n_black``
in place, as the arrivals phase does the queues and the wire, and
``metrics.account`` and the leap replace other counters only; so, unlike
the sends phase's wrapper, this one passes no operand per launch
(``PER_TICK`` is empty).  A new run's buffers, or a state cloned for a
check, build a new block.  The device scalars (``kmin``, ``kspan``,
``salt``, ``fault_start``) go as pointers: reading them on the host would
wait on the card every tick.  ``departures_at`` runs one single-lane
state at a host tick through the same launch (``L = 1``).  The wrapper
counts its launches in ``departures.launches``; for a CUDA tensor it
launches or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, lanes
from repro_torch.kernels.departures import ref as R

_P = ctypes.c_void_p
_I = ctypes.c_int

_PTRS = ("q_fields", "q_head", "q_size", "infl", "n_black", "kmin", "kspan", "salt",
         "fault_start", "dst", "q_lo", "q_hi", "q_dn_base", "q_dn_stride", "q_up_base",
         "q_up_cnt", "q_salt", "edge_q", "ft_time", "ft_period", "fl_start", "fl_end",
         "fl_cycle", "fl_up", "fl_period")
_STATE = ("q_fields", "q_head", "q_size", "infl", "n_black", "salt")
_INTS = ("nq", "cap", "ne", "nf", "qe", "fkc", "fk", "flapped", "l", "lat_core",
         "lat_edge")
# the operands other phases replace within a run, which a wrapper must
# take every launch (the sends wrapper's PER_TICK): none for this phase
PER_TICK = ()


class _Args(ctypes.Structure):
    """Mirror of ``struct DeparturesArgs`` (field order is the C order)."""
    _fields_ = ([(n, _P) for n in _PTRS] + [("ls", ctypes.c_longlong * len(_PTRS))]
                + [(n, _I) for n in _INTS])


@functools.cache
def _fn():
    fn = build.library().repro_departures
    fn.argtypes = [ctypes.POINTER(_Args), _P, _P, _I, _P]
    fn.restype = ctypes.c_int
    return fn


class _Block:
    """The argument block of one run's buffers."""

    def __init__(self, n: int, lat: R.Lat, fl: R.Flags, o: R.Operands):
        dev = o.infl.device
        i32, f32 = torch.int32, torch.float32
        nq, nf = o.qidx.shape[-1], o.dst.shape[-1]
        cap, (l, ne), fkc = o.q_fields.shape[-2], o.infl.shape[-3:-1], o.ft_time.shape[-1]
        if nq < 1 or cap < 1 or nf < 1 or not nq <= ne or not 0 <= fl.qe <= nq:
            raise ValueError(f"{nq} ports of {cap} packets, {nf} flows, {ne} wire rows, "
                             f"edge base {fl.qe}: the kernel needs a port, a flow, a row "
                             "a port and the edge base among the ports")
        if not 0 <= fl.fk <= fkc:
            raise ValueError(f"{fl.fk} fault columns in use of the tables' {fkc}")
        if lat.core < 0 or lat.edge < 0:
            raise ValueError(f"wire latencies {tuple(lat)} negative")
        vec = dict(q_lo=i32, q_hi=i32, q_dn_base=i32, q_dn_stride=i32, q_up_base=i32,
                   q_up_cnt=i32, q_salt=torch.int64, edge_q=torch.bool, fl_start=i32,
                   fl_end=i32, fl_cycle=i32, fl_up=i32, fl_period=i32)
        shapes = dict(q_fields=(i32, (nq + 1, cap, 5)), q_head=(i32, (nq + 1,)),
                      q_size=(i32, (nq + 1,)), infl=(i32, (l, ne, 7)), n_black=(i32, ()),
                      kmin=(f32, ()), kspan=(f32, ()), salt=(i32, ()),
                      fault_start=(i32, ()), dst=(i32, (nf,)),
                      ft_time=(i32, (nq, fkc)), ft_period=(i32, (nq, fkc)),
                      **{k: (dt, (nq,)) for k, dt in vec.items()})
        p = {k: lanes.operand(getattr(o, k), k, dt, shp, dev, n, state=k in _STATE)
             for k, (dt, shp) in shapes.items()}
        lanes.operand(o.qidx, "qidx", i32, (nq,), dev, n)   # the plain version's iota
        build.on_card(dev, "departures")
        self.args = _Args(**{k: p[k][0].value for k in _PTRS},
                          ls=lanes.strides([p[k][1] for k in _PTRS]), nq=nq, cap=cap,
                          ne=ne, nf=nf, qe=fl.qe, fkc=fkc, fk=fl.fk,
                          flapped=int(fl.flapped), l=l, lat_core=lat.core, lat_edge=lat.edge)
        self.n, self.lat, self.fl, self.dev = n, lat, fl, dev
        self.operands = tuple(o)           # held: their storage stays theirs

    def serves(self, n: int, lat: R.Lat, fl: R.Flags, o: R.Operands) -> bool:
        return (n == self.n and lat == self.lat and fl == self.fl
                and all(a is b for a, b in zip(self.operands, o)))


def departures(k: lanes.Tick, lat: R.Lat, fl: R.Flags, o: R.Operands) -> None:
    """Launch the fused kernel on a lane batch of CUDA tensors; same
    contract as ``ref.departures_lanes_ref`` (``o`` updated in place)."""
    n = k.n
    slot = lanes.thread_cache(__name__)
    blk = slot.get("block")
    if blk is None or not blk.serves(n, lat, fl, o):
        slot["block"] = None             # let the last run's buffers go first
        blk = slot["block"] = _Block(n, lat, fl, o)
    now = build.require(k.now, "now", torch.int32, (n,), blk.dev)
    live = build.require(k.live, "live", torch.bool, (n,), blk.dev)
    build.check(_fn()(ctypes.byref(blk.args), now, live, n, build.stream(blk.dev)),
                "departures")
    build.count(departures, launches=1)


departures.launches = 0
_ONE: dict = {}


def departures_at(t: int, lat: R.Lat, fl: R.Flags, o: R.Operands) -> None:
    """One single-lane state at host tick ``t`` through the same launch
    (``L = 1``); same contract as ``ref.departures_ref``."""
    if t < 0:
        raise ValueError(f"tick {t} negative")
    departures(lanes.tick_at(t, o.infl.device), lat, fl, lanes.one_lane(_ONE, o))
