"""ctypes wrapper of the fused arrivals-phase kernel (``csrc/arrivals.cu``).

One launch runs the whole arrivals phase (``ref.arrivals_ref``'s
contract) for every lane of a batch (``kernels/lanes``), one grid row a
lane: one block a switch fan-in row reads, zeroes and ranks its
emitters' wire rows, enqueues the accepted packets and writes its queues'
sizes, and adds the rejects to the trim ledger; one thread a node reads
its delivery row, writes its ACK row and updates the ledgers of the flow
it delivers; integer counters are added with atomics, and the last block
of a lane to finish adds each f32 metric's integer total once.  Each lane
reads its tick and gate from the device and derives its ring slots,
goodput bin and fct base from the tick; a lane that is not live is left
as it was.

The argument block (every pointer but ``fault_active``, made each tick,
plus a scratch row a lane for the tick's totals; ``[L, ...]`` operands,
a constant shared by all lanes passed once with lane stride 0) is built
once per run and thread (``lanes.thread_cache``: each shard of a
batch keeps its own): when the wrapper first sees a run's buffers, after
checking every operand.  On later ticks it checks that the operands are
the same tensors (the block holds them, so their storage cannot be
reused) and allocates nothing.  ``arrivals_at`` runs one single-lane
state at a host tick through the same launch.  It counts its launches in
``arrivals.launches``; for a CUDA tensor it launches or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, lanes
from repro_torch.kernels.arrivals import ref as R

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_ROW = 1024                  # fan-in slots a block (one thread each)

_PTRS = ("enq_ids", "in_tbl", "dst", "size", "t_start", "infl", "q_fields", "q_head",
         "q_size", "ack_ring", "trim_ring", "trim_seen", "bitmap", "goodput", "done", "fct",
         "delivered_pkts", "n_rej", "delivered_bytes", "goodput_hist",
         "delivered_bytes_fault", "scratch", "goodput_bin")
_STATE = ("infl", "q_fields", "q_head", "q_size", "ack_ring", "trim_ring", "trim_seen",
          "bitmap", "goodput", "done", "fct", "delivered_pkts", "n_rej", "delivered_bytes",
          "goodput_hist", "delivered_bytes_fault", "scratch")
_INTS = ("nsw", "d", "eq", "ne", "nq", "qe", "n", "nf", "cap", "ww", "maxw", "mtu",
         "trimming", "credit", "faulty", "l", "r", "ret", "trim_delay")


class _Args(ctypes.Structure):
    """Mirror of ``struct ArrivalsArgs`` (field order is the C order)."""
    _fields_ = ([(n, _P) for n in _PTRS] + [("ls", ctypes.c_longlong * len(_PTRS))]
                + [(n, _I) for n in _INTS])


@functools.cache
def _fn():
    fn = build.library().repro_arrivals
    fn.argtypes = [ctypes.POINTER(_Args), _P, _P, _P, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _stable(o: R.Operands) -> tuple:
    """The operands the argument block holds: every tensor but
    ``fault_active``."""
    return tuple(x for n, x in zip(o._fields, o) if n != "fault_active")


class _Block:
    """The argument block of one run's buffers."""

    def __init__(self, n: int, trim_delay: int, fl: R.Flags, o: R.Operands, gbin):
        dev = o.infl.device
        i32, f32 = torch.int32, torch.float32
        eq, (nsw, d) = o.enq_ids.shape[-1], o.in_tbl.shape[-2:]
        nq, nf, n_nodes = o.sw_of_q.shape[-1], o.dst.shape[-1], o.ack_ring.shape[-2]
        cap, maxw, ww = o.q_fields.shape[-2], o.bitmap.shape[-1], o.trim_ring.shape[-1] - 2
        l, ne, r = o.infl.shape[-3], o.infl.shape[-2], o.ack_ring.shape[-3]
        if not 0 < d <= MAX_ROW:
            raise ValueError(f"in_tbl rows have {d} slots; the kernel takes 1..{MAX_ROW}")
        if ww < 1:
            raise ValueError(f"trim_ring rows hold {ww} loss words; the kernel needs >= 1")
        if not 0 <= fl.qe <= fl.qe + n_nodes <= ne or fl.ret < 0 or trim_delay < 0:
            raise ValueError(f"delivery rows [{fl.qe}, {fl.qe + n_nodes}) outside the wire's "
                             f"{ne} rows, or delays {fl.ret}, {trim_delay} negative")
        shapes = dict(
            enq_ids=(i32, (eq,)), in_tbl=(i32, (nsw, d)), dst=(i32, (nf,)),
            size=(i32, (nf,)), t_start=(i32, (nf,)), infl=(i32, (l, ne, 7)),
            q_fields=(i32, (nq + 1, cap, 5)), q_head=(i32, (nq + 1,)),
            q_size=(i32, (nq + 1,)), ack_ring=(i32, (r, n_nodes, 6)),
            trim_ring=(i32, (r, nf + 1, 2 + ww)), trim_seen=(f32, (nf + 1,)),
            bitmap=(i32, (nf + 1, maxw)), goodput=(i32, (nf,)), done=(torch.bool, (nf,)),
            fct=(i32, (nf,)), delivered_pkts=(i32, ()), delivered_bytes=(f32, ()),
            goodput_hist=(f32, (R.GOODPUT_BINS,)), delivered_bytes_fault=(f32, ()))
        p = {k: lanes.operand(getattr(o, k), k, dt, shp, dev, n, state=k in _STATE)
             for k, (dt, shp) in shapes.items()}
        rej = "n_trim" if fl.trimming else "n_drop"
        p["n_rej"] = lanes.operand(getattr(o, rej), rej, i32, (), dev, n, state=True)
        p["goodput_bin"] = lanes.operand(gbin, "goodput_bin", i32, (), dev, n)
        lanes.operand(o.in_pos, "in_pos", i32, (eq,), dev, n)   # the plain version's tables
        lanes.operand(o.sw_of_q, "sw_of_q", i32, (nq,), dev, n)
        build.on_card(dev, "arrivals")
        # finished blocks, the tick's delivered bytes, trim_seen staging, a
        # row a lane: zero between launches (the lane's last block resets it)
        self.scratch = torch.zeros((n, 2 + nf + 1), dtype=i32, device=dev)
        p["scratch"] = lanes.operand(self.scratch, "scratch", i32, (2 + nf + 1,), dev, n,
                                     state=True)
        self.args = _Args(
            **{k: p[k][0].value for k in _PTRS}, ls=lanes.strides([p[k][1] for k in _PTRS]),
            nsw=nsw, d=d, eq=eq, ne=ne, nq=nq, qe=fl.qe, n=n_nodes, nf=nf, cap=cap, ww=ww,
            maxw=maxw, mtu=fl.mtu, trimming=int(fl.trimming),
            credit=int(fl.credit_based), faulty=int(fl.faulty), l=l, r=r, ret=fl.ret,
            trim_delay=trim_delay)
        self.n, self.trim_delay, self.fl, self.dev = n, trim_delay, fl, dev
        self.operands = _stable(o) + (gbin,)   # held: their storage stays theirs

    def serves(self, n: int, trim_delay: int, fl: R.Flags, o: R.Operands, gbin) -> bool:
        return (n == self.n and trim_delay == self.trim_delay and fl == self.fl
                and all(a is b for a, b in zip(self.operands, _stable(o) + (gbin,))))


def arrivals(k: lanes.Tick, trim_delay: int, fl: R.Flags, o: R.Operands, gbin) -> None:
    """Launch the fused kernel on a lane batch of CUDA tensors; same
    contract as ``ref.arrivals_lanes_ref`` (``o`` updated in place).
    ``gbin`` is each lane's goodput bin width, i32 ``[L]`` (``fl.goodput_bin``
    is not read); ``o.fault_active`` is bool ``[L]`` with ``fl.faulty``."""
    n = k.n
    slot = lanes.thread_cache(__name__)
    blk = slot.get("block")
    if blk is None or not blk.serves(n, trim_delay, fl, o, gbin):
        slot["block"] = None             # let the last run's buffers go first
        blk = slot["block"] = _Block(n, trim_delay, fl, o, gbin)
    active = (build.require(o.fault_active, "fault_active", torch.bool, (n,), blk.dev)
              if fl.faulty else None)
    now = build.require(k.now, "now", torch.int32, (n,), blk.dev)
    live = build.require(k.live, "live", torch.bool, (n,), blk.dev)
    build.check(_fn()(ctypes.byref(blk.args), now, live, active, n, build.stream(blk.dev)),
                "arrivals")
    build.count(arrivals, launches=1)


arrivals.launches = 0
_ONE: dict = {}
_GBIN: dict = {}


def arrivals_at(t: int, s: R.Slots, fl: R.Flags, o: R.Operands) -> None:
    """One single-lane state at host tick ``t`` through the same launch
    (``L = 1``); same contract as ``ref.arrivals_ref``.  The kernel
    derives the slots from ``t``: ``s`` must be the ones it derives."""
    l, r = o.infl.shape[0], o.ack_ring.shape[0]
    if not (0 <= s.wire < l and 0 <= s.ack < r and 0 <= s.trim < r):
        raise ValueError(f"slots {tuple(s)} outside the rings (wire {l}, control {r})")
    trim_delay = (s.trim - t) % r
    if t < 0 or s.wire != t % l or s.ack != (t + fl.ret) % r:
        raise ValueError(f"slots {tuple(s)} are not tick {t}'s (wire {l}, control {r})")
    dev = o.infl.device
    key = (dev, fl.goodput_bin)
    if key not in _GBIN:
        _GBIN[key] = torch.full((1,), fl.goodput_bin, dtype=torch.int32, device=dev)
    arrivals(lanes.tick_at(t, dev), trim_delay, fl, lanes.one_lane(_ONE, o), _GBIN[key])
