"""ctypes wrapper of the fused sends-phase kernel (``csrc/sends.cu``).

One launch runs the whole sends phase (``ref.sends_ref``'s contract) for
every lane of a batch (``kernels/lanes``), one grid row a lane: one warp
a sender row of ``flows_of`` admits its flows 32 slots at a time, picks
one round-robin, and its winning lane emits the packet, writes the
sender's NIC row of the wire slot (zeros for an idle NIC), the flow's
sent-ring slot, sequence, LB counters, credits and pacing budget.  Each
lane reads its tick and gate from the device and derives its wire slot
from the tick; a lane that is not live is left as it was.

Two argument blocks.  The run's block holds the constants and the
buffers the phase owns or only reads, which no other phase replaces
(``PER_TICK`` names the rest): it is built once per run and thread
(``lanes.thread_cache``: each shard of a batch keeps its own), when the
wrapper first sees a run's buffers, after checking every operand.  On later ticks
the wrapper checks that those operands are the same tensors (the block
holds them, so their storage cannot be reused).  The tick's block holds
the operands that earlier phases replace each tick: the load balancer's
entropies after its ACK update, and the CC fields and ``unacked`` that a
baseline's update or the split control phase make anew.  Those are
checked and passed every launch.  The LB parameters stay on the device
(pointers to the scalars: reading them on the host would wait on the
card every tick).  The wrapper counts its launches in ``sends.launches``;
for a CUDA tensor it launches or raises.  Every operand is ``[L, ...]``;
a constant shared by all lanes is passed once, with lane stride 0.
``sends_at`` runs one single-lane state at a host tick through the same
launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import reps
from repro_torch.kernels import build, lanes
from repro_torch.kernels.sends import ref as R

_P = ctypes.c_void_p
_I = ctypes.c_int

_PTRS = ("src", "t_start", "size", "dep_par", "dep_thr", "flows_of", "f_down", "f_dn_q",
         "f_up_base", "f_up_cnt", "f_salt", "num_entropies", "bdp_pkts", "done", "goodput",
         "sent", "infl", "next_seq", "rr_send", "pace_accum", "explore_sent", "spray_ctr",
         "n_retx")
_STATE = ("done", "goodput", "sent", "infl", "next_seq", "rr_send", "pace_accum",
          "explore_sent", "spray_ctr", "n_retx")
_INTS = ("nf", "n", "fmax", "d", "w", "ne", "nq", "window", "credit", "paced", "lb_mode",
         "mtu", "l", "lat_send")
# the operands earlier phases replace each tick: (name, dtype), each [NF]
PER_TICK = (("unacked", torch.float32), ("cwnd", torch.float32),
            ("pacing_rate", torch.float32), ("credits", torch.float32),
            ("spec_budget", torch.float32), ("next_entropy", torch.int32),
            ("cached_entropy", torch.int32), ("plb_entropy", torch.int32))
_PER_TICK = frozenset(n for n, _ in PER_TICK)


class _Args(ctypes.Structure):
    """Mirror of ``struct SendsArgs`` (field order is the C order)."""
    _fields_ = ([(n, _P) for n in _PTRS] + [("ls", ctypes.c_longlong * len(_PTRS))]
                + [(n, _I) for n in _INTS])


class _Tick(ctypes.Structure):
    """Mirror of ``struct SendsTick``."""
    _fields_ = [(n, _P) for n, _ in PER_TICK] + [("ls", ctypes.c_longlong * len(PER_TICK))]


@functools.cache
def _fn():
    fn = build.library().repro_sends
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.POINTER(_Tick), _P, _P, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _stable(o: R.Operands) -> tuple:
    """The operands the run's block holds: every tensor but ``PER_TICK``'s."""
    return tuple(x for n, x in zip(o._fields, o) if n not in _PER_TICK)


class _Block:
    """The argument block of one run's buffers."""

    def __init__(self, n: int, lat_send: int, fl: R.Flags, o: R.Operands):
        dev = o.infl.device
        i32, f32, b8 = torch.int32, torch.float32, torch.bool
        nf, (n_nodes, fmax), d = o.src.shape[-1], o.flows_of.shape[-2:], o.dep_par.shape[-1]
        w, (l, ne) = o.sent.shape[-1], o.infl.shape[-3:-1]
        if n_nodes < 1 or fmax < 1 or w < 1 or ne < n_nodes or lat_send < 0:
            raise ValueError(f"{n_nodes} senders of {fmax} flows, a {w}-slot ring, {ne} wire "
                             f"rows and latency {lat_send}: the kernel needs at least one of "
                             "each, a NIC row a sender and a latency >= 0")
        if fl.lb_mode not in (reps.LB_REPS, reps.LB_SPRAY, reps.LB_ECMP, reps.LB_PLB):
            raise ValueError(f"unknown lb mode {fl.lb_mode}")
        shapes = dict(
            src=(i32, (nf,)), t_start=(i32, (nf,)), size=(i32, (nf,)),
            dep_par=(i32, (nf, d)), dep_thr=(i32, (nf, d)), flows_of=(i32, (n_nodes, fmax)),
            f_down=(b8, (nf,)), f_dn_q=(i32, (nf,)), f_up_base=(i32, (nf,)),
            f_up_cnt=(i32, (nf,)), f_salt=(torch.int64, (nf,)), num_entropies=(i32, ()),
            bdp_pkts=(i32, ()), done=(b8, (nf,)), goodput=(i32, (nf,)),
            sent=(i32, (3, nf + 1, w)), infl=(i32, (l, ne, 7)), next_seq=(i32, (nf,)),
            rr_send=(i32, (n_nodes,)), pace_accum=(f32, (nf,)), explore_sent=(i32, (nf,)),
            spray_ctr=(i32, (nf,)), n_retx=(i32, ()))
        p = {k: lanes.operand(getattr(o, k), k, dt, shp, dev, n, state=k in _STATE)
             for k, (dt, shp) in shapes.items()}
        lanes.operand(o.slot_of, "slot_of", i32, (nf,), dev, n)   # the plain version's
        lanes.operand(o.flow_ids, "flow_ids", i32, (nf,), dev, n)
        lanes.operand(o.node_ids, "node_ids", i32, (n_nodes,), dev, n)
        self.n, self.nf, self.dev = n, nf, dev
        self.tick = _Tick()
        self.check_tick(o)
        build.on_card(dev, "sends")
        self.args = _Args(
            **{k: p[k][0].value for k in _PTRS}, ls=lanes.strides([p[k][1] for k in _PTRS]),
            nf=nf, n=n_nodes, fmax=fmax, d=d, w=w, ne=ne, nq=ne - n_nodes,
            window=fl.window, credit=int(fl.credit_based),
            paced=int(fl.paced), lb_mode=fl.lb_mode, mtu=fl.mtu, l=l, lat_send=lat_send)
        self.lat_send, self.fl = lat_send, fl
        self.operands = _stable(o)         # held: their storage stays theirs

    def serves(self, n: int, lat_send: int, fl: R.Flags, o: R.Operands) -> bool:
        return (n == self.n and lat_send == self.lat_send and fl == self.fl
                and all(a is b for a, b in zip(self.operands, _stable(o))))

    def check_tick(self, o: R.Operands) -> None:
        """Check the tick's operands and point the tick's block at them."""
        n, shape = self.n, (self.nf,)
        for i, (name, dtype) in enumerate(PER_TICK):
            x = getattr(o, name)
            if not (isinstance(x, torch.Tensor) and x.dtype == dtype and x.device == self.dev
                    and x.shape == (n, *shape) and x[0].is_contiguous()
                    and (n == 1 or x.stride(0) == shape[0])):
                lanes.operand(x, name, dtype, shape, self.dev, n, state=True)
            setattr(self.tick, name, x.data_ptr())
            self.tick.ls[i] = 0 if n == 1 else shape[0] * x.element_size()


def sends(k: lanes.Tick, lat_send: int, fl: R.Flags, o: R.Operands) -> None:
    """Launch the fused kernel on a lane batch of CUDA tensors; same
    contract as ``ref.sends_lanes_ref`` (``o`` updated in place)."""
    n = k.n
    slot = lanes.thread_cache(__name__)
    blk = slot.get("block")
    if blk is None or not blk.serves(n, lat_send, fl, o):
        slot["block"] = None             # let the last run's buffers go first
        blk = slot["block"] = _Block(n, lat_send, fl, o)
    else:
        blk.check_tick(o)
    now = build.require(k.now, "now", torch.int32, (n,), blk.dev)
    live = build.require(k.live, "live", torch.bool, (n,), blk.dev)
    build.check(_fn()(ctypes.byref(blk.args), ctypes.byref(blk.tick), now, live, n,
                      build.stream(blk.dev)), "sends")
    build.count(sends, launches=1)


sends.launches = 0
_ONE: dict = {}


def sends_at(t: int, wire: int, fl: R.Flags, o: R.Operands) -> None:
    """One single-lane state at host tick ``t`` through the same launch
    (``L = 1``); same contract as ``ref.sends_ref``.  The kernel derives
    the wire slot from ``t``: ``wire`` fixes the sender latency."""
    l = o.infl.shape[0]
    if t < 0 or not 0 <= wire < l:
        raise ValueError(f"tick {t} negative or wire slot {wire} outside the wire "
                         f"ring's {l} slots")
    sends(lanes.tick_at(t, o.infl.device), (wire - t) % l, fl, lanes.one_lane(_ONE, o))
