"""ctypes wrapper of the fused departures-phase kernel (``csrc/departures.cu``).

One launch runs the whole departures phase (``ref.departures_ref``'s
contract): one thread a port evaluates its service period, takes its
head-of-line packet with the RED mark, routes it, writes its wire row
(zeros where it does not emit), advances its head and size, and the
blackholed packets are added to ``n_black`` once a block.

The argument block holds every operand and is built once per run, when
the wrapper first sees a run's buffers, after checking every operand; on
later ticks the wrapper checks that the operands are the same tensors (the
block holds them, so their storage cannot be reused).  No phase replaces
any of them within a run: this phase updates ``q_head``, ``q_size``, the
wire and ``n_black`` in place, as the arrivals phase does the queues and
the wire, and ``metrics.account`` and the leap replace other counters
only; so, unlike the sends phase's wrapper, this one passes no operand
per launch (``PER_TICK`` is empty).  A new run's buffers, or a state
cloned for a check, build a new block.  The device scalars (``kmin``, ``kspan``, ``salt``,
``fault_start``) go as pointers: reading them on the host would wait on
the card every tick.  The wrapper counts its launches in
``departures.launches``; for a CUDA tensor it launches or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.departures import ref as R

_P = ctypes.c_void_p
_I = ctypes.c_int

_PTRS = ("q_fields", "q_head", "q_size", "infl", "n_black", "kmin", "kspan", "salt",
         "fault_start", "dst", "q_lo", "q_hi", "q_dn_base", "q_dn_stride", "q_up_base",
         "q_up_cnt", "q_salt", "edge_q", "ft_time", "ft_period", "fl_start", "fl_end",
         "fl_cycle", "fl_up", "fl_period")
_INTS = ("nq", "cap", "ne", "nf", "qe", "fkc", "fk", "flapped")
# the operands other phases replace within a run, which a wrapper must
# take every launch (the sends wrapper's PER_TICK): none for this phase
PER_TICK = ()


class _Args(ctypes.Structure):
    """Mirror of ``struct DeparturesArgs`` (field order is the C order)."""
    _fields_ = [(n, _P) for n in _PTRS] + [(n, _I) for n in _INTS]


@functools.cache
def _fn():
    fn = build.library().repro_departures
    fn.argtypes = [ctypes.POINTER(_Args), _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


class _Block:
    """The argument block of one run's buffers."""

    def __init__(self, fl: R.Flags, o: R.Operands):
        dev = o.infl.device
        i32, f32 = torch.int32, torch.float32
        nq, nf = o.qidx.shape[0], o.dst.shape[0]
        cap, (l, ne), fkc = o.q_fields.shape[1], o.infl.shape[:2], o.ft_time.shape[1]
        if nq < 1 or cap < 1 or nf < 1 or not nq <= ne or not 0 <= fl.qe <= nq:
            raise ValueError(f"{nq} ports of {cap} packets, {nf} flows, {ne} wire rows, "
                             f"edge base {fl.qe}: the kernel needs a port, a flow, a row "
                             "a port and the edge base among the ports")
        if not 0 <= fl.fk <= fkc:
            raise ValueError(f"{fl.fk} fault columns in use of the tables' {fkc}")
        req = build.require
        vec = dict(q_lo=i32, q_hi=i32, q_dn_base=i32, q_dn_stride=i32, q_up_base=i32,
                   q_up_cnt=i32, q_salt=torch.int64, edge_q=torch.bool, fl_start=i32,
                   fl_end=i32, fl_cycle=i32, fl_up=i32, fl_period=i32)
        p = dict(
            q_fields=req(o.q_fields, "q_fields", i32, (nq + 1, cap, 5), dev),
            q_head=req(o.q_head, "q_head", i32, (nq + 1,), dev),
            q_size=req(o.q_size, "q_size", i32, (nq + 1,), dev),
            infl=req(o.infl, "infl", i32, (l, ne, 7), dev),
            n_black=req(o.n_black, "n_black", i32, (), dev),
            kmin=req(o.kmin, "kmin", f32, (), dev),
            kspan=req(o.kspan, "kspan", f32, (), dev),
            salt=req(o.salt, "salt", i32, (), dev),
            fault_start=req(o.fault_start, "fault_start", i32, (), dev),
            dst=req(o.dst, "dst", i32, (nf,), dev),
            ft_time=req(o.ft_time, "ft_time", i32, (nq, fkc), dev),
            ft_period=req(o.ft_period, "ft_period", i32, (nq, fkc), dev),
            **{n: req(getattr(o, n), n, dt, (nq,), dev) for n, dt in vec.items()},
        )
        req(o.qidx, "qidx", i32, (nq,), dev)             # the plain version's iota
        build.on_card(dev, "departures")
        self.args = _Args(**{k: v.value for k, v in p.items()}, nq=nq, cap=cap, ne=ne,
                          nf=nf, qe=fl.qe, fkc=fkc, fk=fl.fk, flapped=int(fl.flapped))
        self.fl, self.l, self.dev = fl, l, dev
        self.operands = tuple(o)           # held: their storage stays theirs

    def serves(self, fl: R.Flags, o: R.Operands) -> bool:
        return fl == self.fl and all(a is b for a, b in zip(self.operands, o))


_block: list = [None]


def departures(t: int, lat: R.Lat, fl: R.Flags, o: R.Operands) -> None:
    """Launch the fused kernel on CUDA tensors; same contract as
    ``ref.departures_ref`` (``o`` updated in place)."""
    blk = _block[0]
    if blk is None or not blk.serves(fl, o):
        _block[0] = None                 # let the last run's buffers go first
        blk = _block[0] = _Block(fl, o)
    if t < 0 or lat.core < 0 or lat.edge < 0:
        raise ValueError(f"tick {t} or wire latencies {tuple(lat)} negative")
    build.check(_fn()(ctypes.byref(blk.args), int(t), (t + lat.core) % blk.l,
                      (t + lat.edge) % blk.l, build.stream(blk.dev)), "departures")
    departures.launches += 1


departures.launches = 0
