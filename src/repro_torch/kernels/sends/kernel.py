"""ctypes wrapper of the fused sends-phase kernel (``csrc/sends.cu``).

One launch runs the whole sends phase (``ref.sends_ref``'s contract): one
warp a sender row of ``flows_of`` admits its flows 32 slots at a time,
picks one round-robin, and its winning lane emits the packet, writes the
sender's NIC row of the wire slot (zeros for an idle NIC), the flow's
sent-ring slot, sequence, LB counters, credits and pacing budget.

Two argument blocks.  The run's block holds the constants and the
buffers the phase owns or only reads, which no other phase replaces
(``PER_TICK`` names the rest): it is built once per run, when the wrapper
first sees a run's buffers, after checking every operand.  On later ticks
the wrapper checks that those operands are the same tensors (the block
holds them, so their storage cannot be reused).  The tick's block holds
the operands that earlier phases replace each tick: the load balancer's
entropies after its ACK update, and the CC fields and ``unacked`` that a
baseline's update or the split control phase make anew.  Those are
checked and passed every launch.  The LB parameters stay on the device
(pointers to the scalars: reading them on the host would wait on the
card every tick).  The wrapper counts its launches in ``sends.launches``;
for a CUDA tensor it launches or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import reps
from repro_torch.kernels import build
from repro_torch.kernels.sends import ref as R

_P = ctypes.c_void_p
_I = ctypes.c_int

_PTRS = ("src", "t_start", "size", "dep_par", "dep_thr", "flows_of", "f_down", "f_dn_q",
         "f_up_base", "f_up_cnt", "f_salt", "num_entropies", "bdp_pkts", "done", "goodput",
         "sent", "infl", "next_seq", "rr_send", "pace_accum", "explore_sent", "spray_ctr",
         "n_retx")
_INTS = ("nf", "n", "fmax", "d", "w", "ne", "nq", "window", "credit", "paced", "lb_mode",
         "mtu")
# the operands earlier phases replace each tick: (name, dtype), each [NF]
PER_TICK = (("unacked", torch.float32), ("cwnd", torch.float32),
            ("pacing_rate", torch.float32), ("credits", torch.float32),
            ("spec_budget", torch.float32), ("next_entropy", torch.int32),
            ("cached_entropy", torch.int32), ("plb_entropy", torch.int32))
_PER_TICK = frozenset(n for n, _ in PER_TICK)


class _Args(ctypes.Structure):
    """Mirror of ``struct SendsArgs`` (field order is the C order)."""
    _fields_ = [(n, _P) for n in _PTRS] + [(n, _I) for n in _INTS]


class _Tick(ctypes.Structure):
    """Mirror of ``struct SendsTick``."""
    _fields_ = [(n, _P) for n, _ in PER_TICK]


@functools.cache
def _fn():
    fn = build.library().repro_sends
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.POINTER(_Tick), _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _stable(o: R.Operands) -> tuple:
    """The operands the run's block holds: every tensor but ``PER_TICK``'s."""
    return tuple(x for n, x in zip(o._fields, o) if n not in _PER_TICK)


class _Block:
    """The argument block of one run's buffers."""

    def __init__(self, fl: R.Flags, o: R.Operands):
        dev = o.infl.device
        i32, f32, b8 = torch.int32, torch.float32, torch.bool
        nf, (n, fmax), d = o.src.shape[0], o.flows_of.shape, o.dep_par.shape[1]
        w, (l, ne) = o.sent.shape[2], o.infl.shape[:2]
        if n < 1 or fmax < 1 or w < 1 or ne < n:
            raise ValueError(f"{n} senders of {fmax} flows, a {w}-slot ring and {ne} wire "
                             "rows: the kernel needs at least one of each and a NIC row "
                             "a sender")
        if fl.lb_mode not in (reps.LB_REPS, reps.LB_SPRAY, reps.LB_ECMP, reps.LB_PLB):
            raise ValueError(f"unknown lb mode {fl.lb_mode}")
        req = build.require
        p = dict(
            src=req(o.src, "src", i32, (nf,), dev),
            t_start=req(o.t_start, "t_start", i32, (nf,), dev),
            size=req(o.size, "size", i32, (nf,), dev),
            dep_par=req(o.dep_par, "dep_par", i32, (nf, d), dev),
            dep_thr=req(o.dep_thr, "dep_thr", i32, (nf, d), dev),
            flows_of=req(o.flows_of, "flows_of", i32, (n, fmax), dev),
            f_down=req(o.f_down, "f_down", b8, (nf,), dev),
            f_dn_q=req(o.f_dn_q, "f_dn_q", i32, (nf,), dev),
            f_up_base=req(o.f_up_base, "f_up_base", i32, (nf,), dev),
            f_up_cnt=req(o.f_up_cnt, "f_up_cnt", i32, (nf,), dev),
            f_salt=req(o.f_salt, "f_salt", torch.int64, (nf,), dev),
            num_entropies=req(o.num_entropies, "num_entropies", i32, (), dev),
            bdp_pkts=req(o.bdp_pkts, "bdp_pkts", i32, (), dev),
            done=req(o.done, "done", b8, (nf,), dev),
            goodput=req(o.goodput, "goodput", i32, (nf,), dev),
            sent=req(o.sent, "sent", i32, (3, nf + 1, w), dev),
            infl=req(o.infl, "infl", i32, (l, ne, 7), dev),
            next_seq=req(o.next_seq, "next_seq", i32, (nf,), dev),
            rr_send=req(o.rr_send, "rr_send", i32, (n,), dev),
            pace_accum=req(o.pace_accum, "pace_accum", f32, (nf,), dev),
            explore_sent=req(o.explore_sent, "explore_sent", i32, (nf,), dev),
            spray_ctr=req(o.spray_ctr, "spray_ctr", i32, (nf,), dev),
            n_retx=req(o.n_retx, "n_retx", i32, (), dev),
        )
        req(o.slot_of, "slot_of", i32, (nf,), dev)     # the plain version's tables
        req(o.flow_ids, "flow_ids", i32, (nf,), dev)
        req(o.node_ids, "node_ids", i32, (n,), dev)
        self.nf, self.l, self.dev = nf, l, dev
        self.tick = _Tick()
        self.check_tick(o)
        build.on_card(dev, "sends")
        self.args = _Args(
            **{k: v.value for k, v in p.items()},
            nf=nf, n=n, fmax=fmax, d=d, w=w, ne=ne, nq=ne - n,
            window=fl.window, credit=int(fl.credit_based),
            paced=int(fl.paced), lb_mode=fl.lb_mode, mtu=fl.mtu)
        self.fl = fl
        self.operands = _stable(o)         # held: their storage stays theirs

    def serves(self, fl: R.Flags, o: R.Operands) -> bool:
        return fl == self.fl and all(a is b for a, b in zip(self.operands, _stable(o)))

    def check_tick(self, o: R.Operands) -> None:
        """Check the tick's operands and point the tick's block at them."""
        shape = (self.nf,)
        for name, dtype in PER_TICK:
            x = getattr(o, name)
            if not (isinstance(x, torch.Tensor) and x.dtype == dtype
                    and x.device == self.dev and x.shape == shape and x.is_contiguous()):
                build.require(x, name, dtype, shape, self.dev)
            setattr(self.tick, name, x.data_ptr())


_block: list = [None]


def sends(t: int, wire: int, fl: R.Flags, o: R.Operands) -> None:
    """Launch the fused kernel on CUDA tensors; same contract as
    ``ref.sends_ref`` (``o`` updated in place)."""
    blk = _block[0]
    if blk is None or not blk.serves(fl, o):
        _block[0] = None                 # let the last run's buffers go first
        blk = _block[0] = _Block(fl, o)
    else:
        blk.check_tick(o)
    if not 0 <= wire < blk.l:
        raise ValueError(f"wire slot {wire} outside the wire ring's {blk.l} slots")
    build.check(_fn()(ctypes.byref(blk.args), ctypes.byref(blk.tick), int(t), int(wire),
                      build.stream(blk.dev)), "sends")
    sends.launches += 1


sends.launches = 0
