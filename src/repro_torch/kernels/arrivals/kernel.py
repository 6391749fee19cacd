"""ctypes wrapper of the fused arrivals-phase kernel (``csrc/arrivals.cu``).

One launch runs the whole arrivals phase (``ref.arrivals_ref``'s
contract): one block a switch fan-in row reads, zeroes and ranks its
emitters' wire rows, enqueues the accepted packets and writes its queues'
sizes, and adds the rejects to the trim ledger; one thread a node reads
its delivery row, writes its ACK row and updates the ledgers of the flow
it delivers; integer counters are added with atomics, and the last block
to finish adds each f32 metric's integer total once.

The argument block (every pointer but ``fault_active``, made each tick,
plus a scratch row for the tick's totals) is built once per run:
when the wrapper first sees a run's buffers, after checking every
operand.  On later ticks it checks that the operands are the same tensors
(the block holds them, so their storage cannot be reused) and allocates
nothing.  It counts its launches in ``arrivals.launches``; for a CUDA
tensor it launches or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.arrivals import ref as R

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_ROW = 1024                  # fan-in slots a block (one thread each)

_PTRS = ("enq_ids", "in_tbl", "dst", "size", "t_start", "infl", "q_fields", "q_head",
         "q_size", "ack_ring", "trim_ring", "trim_seen", "bitmap", "goodput", "done", "fct",
         "delivered_pkts", "n_rej", "delivered_bytes", "goodput_hist",
         "delivered_bytes_fault", "scratch")
_INTS = ("nsw", "d", "eq", "ne", "nq", "qe", "n", "nf", "cap", "ww", "maxw", "mtu",
         "trimming", "credit", "faulty")


class _Args(ctypes.Structure):
    """Mirror of ``struct ArrivalsArgs`` (field order is the C order)."""
    _fields_ = [(n, _P) for n in _PTRS] + [(n, _I) for n in _INTS]


@functools.cache
def _fn():
    fn = build.library().repro_arrivals
    fn.argtypes = [ctypes.POINTER(_Args)] + [_I] * 5 + [_P] * 2
    fn.restype = ctypes.c_int
    return fn


def _stable(o: R.Operands) -> tuple:
    """The operands the argument block holds: every tensor but
    ``fault_active``."""
    return tuple(x for n, x in zip(o._fields, o) if n != "fault_active")


class _Block:
    """The argument block of one run's buffers."""

    def __init__(self, fl: R.Flags, o: R.Operands):
        dev = o.infl.device
        i32, f32 = torch.int32, torch.float32
        eq, (nsw, d) = o.enq_ids.shape[0], o.in_tbl.shape
        nq, nf, n = o.sw_of_q.shape[0], o.dst.shape[0], o.ack_ring.shape[1]
        cap, maxw, ww = o.q_fields.shape[1], o.bitmap.shape[1], o.trim_ring.shape[2] - 2
        l, ne, r = o.infl.shape[0], o.infl.shape[1], o.ack_ring.shape[0]
        if not 0 < d <= MAX_ROW:
            raise ValueError(f"in_tbl rows have {d} slots; the kernel takes 1..{MAX_ROW}")
        if ww < 1:
            raise ValueError(f"trim_ring rows hold {ww} loss words; the kernel needs >= 1")
        if not 0 <= fl.qe <= fl.qe + n <= ne or fl.goodput_bin < 1:
            raise ValueError(f"delivery rows [{fl.qe}, {fl.qe + n}) outside the wire's "
                             f"{ne} rows, or goodput bin {fl.goodput_bin} ticks")
        req = build.require
        p = dict(
            enq_ids=req(o.enq_ids, "enq_ids", i32, (eq,), dev),
            in_tbl=req(o.in_tbl, "in_tbl", i32, (nsw, d), dev),
            dst=req(o.dst, "dst", i32, (nf,), dev),
            size=req(o.size, "size", i32, (nf,), dev),
            t_start=req(o.t_start, "t_start", i32, (nf,), dev),
            infl=req(o.infl, "infl", i32, (l, ne, 7), dev),
            q_fields=req(o.q_fields, "q_fields", i32, (nq + 1, cap, 5), dev),
            q_head=req(o.q_head, "q_head", i32, (nq + 1,), dev),
            q_size=req(o.q_size, "q_size", i32, (nq + 1,), dev),
            ack_ring=req(o.ack_ring, "ack_ring", i32, (r, n, 6), dev),
            trim_ring=req(o.trim_ring, "trim_ring", i32, (r, nf + 1, 2 + ww), dev),
            trim_seen=req(o.trim_seen, "trim_seen", f32, (nf + 1,), dev),
            bitmap=req(o.bitmap, "bitmap", i32, (nf + 1, maxw), dev),
            goodput=req(o.goodput, "goodput", i32, (nf,), dev),
            done=req(o.done, "done", torch.bool, (nf,), dev),
            fct=req(o.fct, "fct", i32, (nf,), dev),
            delivered_pkts=req(o.delivered_pkts, "delivered_pkts", i32, (), dev),
            n_rej=(req(o.n_trim, "n_trim", i32, (), dev) if fl.trimming
                   else req(o.n_drop, "n_drop", i32, (), dev)),
            delivered_bytes=req(o.delivered_bytes, "delivered_bytes", f32, (), dev),
            goodput_hist=req(o.goodput_hist, "goodput_hist", f32, (R.GOODPUT_BINS,), dev),
            delivered_bytes_fault=req(o.delivered_bytes_fault, "delivered_bytes_fault",
                                      f32, (), dev),
        )
        req(o.in_pos, "in_pos", i32, (eq,), dev)       # the plain version's tables
        req(o.sw_of_q, "sw_of_q", i32, (nq,), dev)
        build.on_card(dev, "arrivals")
        # finished blocks, the tick's delivered bytes, trim_seen staging:
        # zero between launches (the last block resets them)
        self.scratch = torch.zeros((2 + nf + 1,), dtype=i32, device=dev)
        p["scratch"] = _P(self.scratch.data_ptr())
        self.args = _Args(
            **{k: v.value for k, v in p.items()},
            nsw=nsw, d=d, eq=eq, ne=ne, nq=nq, qe=fl.qe, n=n, nf=nf, cap=cap, ww=ww,
            maxw=maxw, mtu=fl.mtu, trimming=int(fl.trimming),
            credit=int(fl.credit_based), faulty=int(fl.faulty))
        self.fl, self.l, self.r, self.dev = fl, l, r, dev
        self.operands = _stable(o)         # held: their storage stays theirs

    def serves(self, fl: R.Flags, o: R.Operands) -> bool:
        return fl == self.fl and all(a is b for a, b in zip(self.operands, _stable(o)))


_block: list = [None]


def arrivals(t: int, s: R.Slots, fl: R.Flags, o: R.Operands) -> None:
    """Launch the fused kernel on CUDA tensors; same contract as
    ``ref.arrivals_ref`` (``o`` updated in place)."""
    blk = _block[0]
    if blk is None or not blk.serves(fl, o):
        _block[0] = None                 # let the last run's buffers go first
        blk = _block[0] = _Block(fl, o)
    active = (build.require(o.fault_active, "fault_active", torch.bool, (), blk.dev)
              if fl.faulty else None)
    gbin = R.goodput_bin(t, fl)
    if not (0 <= s.wire < blk.l and 0 <= s.ack < blk.r and 0 <= s.trim < blk.r
            and 0 <= gbin):
        raise ValueError(f"slots {tuple(s)} (goodput bin {gbin}) outside the rings "
                         f"(wire {blk.l}, control {blk.r})")
    build.check(_fn()(ctypes.byref(blk.args), int(s.wire), int(s.ack), int(s.trim), gbin,
                      int(t) + fl.ret, active, build.stream(blk.dev)),
                "arrivals")
    arrivals.launches += 1


arrivals.launches = 0
