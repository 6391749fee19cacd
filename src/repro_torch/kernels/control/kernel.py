"""ctypes wrapper of the fused control-phase kernel (``csrc/control.cu``).

One launch runs the control phase's per-flow work (``ref.control_ref``'s
contract) for every lane of a batch (``kernels/lanes``), one grid row a
lane: one warp a flow gathers its ACK, trim and credit rows, drains its
sent-ring row, updates the RTO backoff, forms the event and, for SMaRTT,
runs the window update; the metric sums and the RTT histogram are reduced
per block and added with integer atomics; the last block of a lane to
finish zeroes that lane's ACK slot, which all of a receiver's flows read.
Each lane reads its tick and gate from the device; a lane that is not
live is left as it was (its event rows are not written).

The argument block (every pointer, ``done`` and ``bitmap`` among them,
which the arrivals phase updates in place; SMaRTT's 13 scalar parameters
as one ``[13]`` row and the per-flow ones as one ``[3, NF]`` plane, each
passed once with lane stride 0 unless a study sweeps them, then one a
lane; the event buffer, ``[L, 11, NF]``) is built once per run and thread
(``lanes.thread_cache``: each shard of a batch keeps its own): when the
wrapper first sees a run's buffers, after checking every operand.  On
later ticks it checks that the operands are the same tensors (the block
holds them, so their storage cannot be reused) and allocates nothing.
``control_at`` runs one single-lane state at a host tick through the same
launch.  It counts its launches in ``control.launches``
(``control.launches_smartt``: those with SMaRTT's update inside); for a
CUDA tensor it launches or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, lanes
from repro_torch.kernels.cc_update import ref as cc_ref
from repro_torch.kernels.control import ref as R

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
MAX_BINS = 64                   # the kernel's shared RTT histogram

_PTRS = ("dst", "size", "t_start", "rto", "pf", "params", "ack_ring", "trim_ring",
         "credit_ring", "sent", "rto_backoff", "unacked", *R.CC_PLANES,
         "n_to", "spurious_retx", "n_ack", "rtt_hist", "ev", "blocks_done", "done", "bitmap")
_STATE = ("ack_ring", "trim_ring", "credit_ring", "sent", "rto_backoff", "unacked",
          *R.CC_PLANES, "n_to", "spurious_retx", "n_ack", "rtt_hist", "done", "bitmap")
_INTS = ("nf", "n", "r", "w", "ww", "maxw", "mtu", "backoff_max", "bins",
         "trimming", "credit")


class _Args(ctypes.Structure):
    """Mirror of ``struct ControlArgs`` (field order is the C order)."""
    _fields_ = ([(n, _P) for n in _PTRS] + [("ls", ctypes.c_longlong * len(_PTRS))]
                + [(n, _I) for n in _INTS] + [("mtu_f", _F), ("hist_scale", _F)])


@functools.cache
def _fn():
    fn = build.library().repro_control
    fn.argtypes = [ctypes.POINTER(_Args), _P, _P, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _stable(fl: R.Flags, o: R.Operands) -> tuple:
    """The operands the argument block holds: every tensor (the CC state
    and parameters only for SMaRTT)."""
    cc = ((*(getattr(o.cc, n) for n in R.CC_PLANES), *o.params)
          if fl.smartt else ())
    return (o.dst, o.size, o.t_start, o.rto, o.ack_ring, o.trim_ring,
            o.credit_ring, o.sent, o.bitmap, o.done, o.rto_backoff, o.unacked,
            o.n_to, o.spurious_retx, o.n_ack, o.rtt_hist, *cc)


def _plane(xs, n: int, shape) -> torch.Tensor:
    """Lane-batched parameters ``xs`` (each ``[n, *shape]``) as one f32
    ``[k, *shape]`` block, passed once (lane stride 0) where every one is
    shared by the lanes, else one block a lane, ``[n, k, *shape]``."""
    if all(x.stride(0) == 0 for x in xs) or n == 1:
        return torch.stack([x[0].to(torch.float32) for x in xs]).contiguous()
    return torch.stack([x.to(torch.float32) for x in xs], dim=1).contiguous()


class _Block:
    """The argument block of one run's buffers."""

    def __init__(self, n: int, fl: R.Flags, o: R.Operands):
        dev = o.sent.device
        i32, f32 = torch.int32, torch.float32
        nf = o.done.shape[-1]
        r, n_nodes = o.ack_ring.shape[-3], o.ack_ring.shape[-2]
        w = o.sent.shape[-1]
        ww, maxw = w // 32, o.bitmap.shape[-1]
        bins = o.rtt_hist.shape[-1]
        if ww * 32 != w or w == 0:
            raise ValueError(f"sent ring width {w} is not a positive multiple of 32")
        if not 0 < bins <= MAX_BINS:
            raise ValueError(f"rtt_hist has {bins} bins; the kernel takes 1..{MAX_BINS}")
        shapes = dict(
            dst=(i32, (nf,)), size=(i32, (nf,)), t_start=(i32, (nf,)), rto=(f32, (nf,)),
            ack_ring=(i32, (r, n_nodes, 6)), trim_ring=(i32, (r, nf + 1, 2 + ww)),
            credit_ring=(f32, (r, nf + 1)), sent=(i32, (3, nf + 1, w)),
            rto_backoff=(i32, (nf,)), unacked=(f32, (nf,)), n_to=(i32, ()),
            spurious_retx=(i32, ()), n_ack=(i32, ()), rtt_hist=(i32, (bins,)),
            done=(torch.bool, (nf,)), bitmap=(i32, (nf + 1, maxw)))
        p = {k: lanes.operand(getattr(o, k), k, dt, shp, dev, n, state=k in _STATE)
             for k, (dt, shp) in shapes.items()}
        none = (_P(None), 0)
        p.update(pf=none, params=none, **{name: none for name in R.CC_PLANES})
        self.pf = self.params = None
        if fl.smartt:
            kinds = dict([(n_, f32) for n_ in cc_ref.STATE_F32]
                         + [(n_, torch.bool) for n_ in cc_ref.STATE_BOOL]
                         + [(n_, i32) for n_ in cc_ref.STATE_I32])
            for name in R.CC_PLANES:
                p[name] = lanes.operand(getattr(o.cc, name), f"cc.{name}", kinds[name], (nf,),
                                        dev, n, state=True)
            per_flow = []
            for name in cc_ref.PER_FLOW_PARAMS:
                x = getattr(o.params, name)
                if x.device != dev or x.shape[0] != n or x[0].numel() not in (1, nf):
                    raise ValueError(f"params.{name}: {tuple(x.shape)} on {x.device}, "
                                     f"expected {n} lanes of a scalar or [{nf}] on {dev}")
                per_flow.append(x.reshape(n, -1).expand(n, nf))
            scalars = []
            for name in cc_ref.PARAM_FIELDS:
                x = getattr(o.params, name)
                if x.device != dev or tuple(x.shape) != (n,):
                    raise ValueError(f"params.{name}: {tuple(x.shape)} on {x.device}, "
                                     f"expected {n} lanes of a scalar on {dev}")
                scalars.append(x)
            self.pf = _plane(per_flow, n, (nf,))               # once a run
            self.params = _plane(scalars, n, ())
            p["pf"] = (_P(self.pf.data_ptr()), 0 if self.pf.dim() == 2 else 3 * nf * 4)
            p["params"] = (_P(self.params.data_ptr()),
                           0 if self.params.dim() == 1 else len(scalars) * 4)
        build.on_card(dev, "control")
        buf = R.new_events(nf, dev, n)
        self.ev = R.events(buf)                # the views, made once a run
        p["ev"] = (_P(buf.data_ptr()), 0 if n == 1 else buf[0].numel() * 4)
        self.blocks_done = torch.zeros((n,), dtype=i32, device=dev)
        p["blocks_done"] = (_P(self.blocks_done.data_ptr()), 0 if n == 1 else 4)
        self.args = _Args(
            **{k: p[k][0].value for k in _PTRS}, ls=lanes.strides([p[k][1] for k in _PTRS]),
            nf=nf, n=n_nodes, r=r, w=w, ww=ww, maxw=maxw, mtu=fl.mtu,
            backoff_max=fl.rto_backoff_max, bins=bins, trimming=int(fl.trimming),
            credit=int(fl.credit_based), mtu_f=float(fl.mtu),
            hist_scale=8.0 / fl.brtt_inter)
        self.n, self.fl, self.dev = n, fl, dev
        self.operands = _stable(fl, o)     # held: their storage stays theirs

    def serves(self, n: int, fl: R.Flags, o: R.Operands) -> bool:
        return n == self.n and fl == self.fl and all(
            a is b for a, b in zip(self.operands, _stable(fl, o)))


def control(k: lanes.Tick, fl: R.Flags, o: R.Operands):
    """Launch the fused kernel on a lane batch of CUDA tensors; same
    contract as ``ref.control_lanes_ref`` (``o`` updated in place, the
    event returned: ``[L, NF]`` views of the run's one buffer, overwritten
    by the next tick; a lane that is not live keeps its last rows)."""
    n = k.n
    slot = lanes.thread_cache(__name__)
    blk = slot.get("block")
    if blk is None or not blk.serves(n, fl, o):
        slot["block"] = None             # let the last run's buffers go first
        blk = slot["block"] = _Block(n, fl, o)
    now = build.require(k.now, "now", torch.int32, (n,), blk.dev)
    live = build.require(k.live, "live", torch.bool, (n,), blk.dev)
    build.check(_fn()(ctypes.byref(blk.args), now, live, int(fl.smartt), n,
                      build.stream(blk.dev)), "control")
    build.count(control, launches=1, launches_smartt=int(fl.smartt))
    return blk.ev


control.launches = 0
control.launches_smartt = 0     # those that ran SMaRTT's update inside
_ONE: dict = {}


def control_at(t: int, fl: R.Flags, o: R.Operands):
    """One single-lane state at host tick ``t`` through the same launch
    (``L = 1``); same contract as ``ref.control_ref`` (the event's fields
    ``[NF]`` views)."""
    if t < 0:
        raise ValueError(f"tick {t} negative")
    ev = control(lanes.tick_at(t, o.sent.device), fl, lanes.one_lane(_ONE, o))
    return type(ev)(*(x[0] for x in ev))
