"""ctypes wrapper of the fused control-phase kernel (``csrc/control.cu``).

One launch runs the control phase's per-flow work (``ref.control_ref``'s
contract): one warp a flow gathers its ACK, trim and credit rows, drains
its sent-ring row, updates the RTO backoff, forms the event and, for
SMaRTT, runs the window update; the metric sums and the RTT histogram are
reduced per block and added with integer atomics; the last block to
finish zeroes the ACK slot, which all of a receiver's flows read.

The argument block (every pointer, ``done`` and ``bitmap`` among them,
which the arrivals phase updates in place, the scalar CC parameters by
value and the per-flow ones packed into one ``[3, NF]`` plane, and the
event buffer) is built once per run: when the wrapper first sees a run's
buffers, after checking every operand.  On later ticks it checks that the
operands are the same tensors (the block holds them, so their storage
cannot be reused) and allocates nothing.  It counts its launches in
``control.launches`` (``control.launches_smartt``: those with SMaRTT's
update inside); for a CUDA tensor it launches or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cc_update import kernel as cc_kernel
from repro_torch.kernels.cc_update import ref as cc_ref
from repro_torch.kernels.control import ref as R

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
MAX_BINS = 64                   # the kernel's shared RTT histogram

_PTRS = ("dst", "size", "t_start", "rto", "pf", "ack_ring", "trim_ring",
         "credit_ring", "sent", "rto_backoff", "unacked", *R.CC_PLANES,
         "n_to", "spurious_retx", "n_ack", "rtt_hist", "ev", "blocks_done")
_INTS = ("nf", "n", "r", "w", "ww", "maxw", "mtu", "backoff_max", "bins",
         "trimming", "credit")


class _Args(ctypes.Structure):
    """Mirror of ``struct ControlArgs`` (field order is the C order)."""
    _fields_ = ([(n, _P) for n in _PTRS] + [(n, _I) for n in _INTS]
                + [("mtu_f", _F), ("hist_scale", _F)])


@functools.cache
def _fn():
    fn = build.library().repro_control
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.POINTER(cc_kernel.Params),
                   _I, _P, _P, _I, _P]
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


class _Block:
    """The argument block of one run's buffers."""

    def __init__(self, fl: R.Flags, o: R.Operands):
        dev = o.sent.device
        i32, f32 = torch.int32, torch.float32
        nf = o.done.shape[0]
        r, n = o.ack_ring.shape[0], o.ack_ring.shape[1]
        w = o.sent.shape[2]
        ww, maxw = w // 32, o.bitmap.shape[1]
        bins = o.rtt_hist.shape[0]
        if ww * 32 != w or w == 0:
            raise ValueError(f"sent ring width {w} is not a positive multiple of 32")
        if not 0 < bins <= MAX_BINS:
            raise ValueError(f"rtt_hist has {bins} bins; the kernel takes 1..{MAX_BINS}")
        req = build.require
        p = dict(
            dst=req(o.dst, "dst", i32, (nf,), dev),
            size=req(o.size, "size", i32, (nf,), dev),
            t_start=req(o.t_start, "t_start", i32, (nf,), dev),
            rto=req(o.rto, "rto", f32, (nf,), dev),
            ack_ring=req(o.ack_ring, "ack_ring", i32, (r, n, 6), dev),
            trim_ring=req(o.trim_ring, "trim_ring", i32, (r, nf + 1, 2 + ww), dev),
            credit_ring=req(o.credit_ring, "credit_ring", f32, (r, nf + 1), dev),
            sent=req(o.sent, "sent", i32, (3, nf + 1, w), dev),
            rto_backoff=req(o.rto_backoff, "rto_backoff", i32, (nf,), dev),
            unacked=req(o.unacked, "unacked", f32, (nf,), dev),
            n_to=req(o.n_to, "n_to", i32, (), dev),
            spurious_retx=req(o.spurious_retx, "spurious_retx", i32, (), dev),
            n_ack=req(o.n_ack, "n_ack", i32, (), dev),
            rtt_hist=req(o.rtt_hist, "rtt_hist", i32, (bins,), dev),
        )
        self.done = req(o.done, "done", torch.bool, (nf,), dev)
        self.bitmap = req(o.bitmap, "bitmap", i32, (nf + 1, maxw), dev)
        self.params = cc_kernel.Params()
        self.pf = None
        if fl.smartt:
            kinds = dict([(n_, f32) for n_ in cc_ref.STATE_F32]
                         + [(n_, torch.bool) for n_ in cc_ref.STATE_BOOL]
                         + [(n_, i32) for n_ in cc_ref.STATE_I32])
            for name in R.CC_PLANES:
                p[name] = req(getattr(o.cc, name), f"cc.{name}", kinds[name], (nf,), dev)
            per_flow = []
            for name in cc_ref.PER_FLOW_PARAMS:
                x = getattr(o.params, name)
                if x.device != dev or x.numel() not in (1, nf):
                    raise ValueError(f"params.{name}: {tuple(x.shape)} on {x.device}, "
                                     f"expected a scalar or [{nf}] on {dev}")
                per_flow.append(x.to(f32).expand(nf))
            self.pf = torch.stack(per_flow).contiguous()       # [3, NF], once a run
            p["pf"] = _P(self.pf.data_ptr())
            self.params = cc_kernel.host_params(o.params)
        build.on_card(dev, "control")
        buf = R.new_events(nf, dev)
        self.ev = R.events(buf)                # the views, made once a run
        p["ev"] = _P(buf.data_ptr())
        self.blocks_done = torch.zeros((1,), dtype=i32, device=dev)
        p["blocks_done"] = _P(self.blocks_done.data_ptr())
        self.args = _Args(
            **{k: v.value for k, v in p.items()},
            nf=nf, n=n, r=r, w=w, ww=ww, maxw=maxw, mtu=fl.mtu,
            backoff_max=fl.rto_backoff_max, bins=bins, trimming=int(fl.trimming),
            credit=int(fl.credit_based), mtu_f=float(fl.mtu),
            hist_scale=8.0 / fl.brtt_inter)
        self.fl, self.dev = fl, dev
        self.operands = _stable(fl, o)     # held: their storage stays theirs

    def serves(self, fl: R.Flags, o: R.Operands) -> bool:
        return fl == self.fl and all(
            a is b for a, b in zip(self.operands, _stable(fl, o)))


_block: list = [None]


def control(t: int, fl: R.Flags, o: R.Operands):
    """Launch the fused kernel on CUDA tensors; same contract as
    ``ref.control_ref`` (``o`` updated in place, the event returned: views
    of the run's one buffer, overwritten by the next tick)."""
    blk = _block[0]
    if blk is None or not blk.serves(fl, o):
        _block[0] = None                 # let the last run's buffers go first
        blk = _block[0] = _Block(fl, o)
    build.check(_fn()(ctypes.byref(blk.args), ctypes.byref(blk.params), int(t),
                      blk.done, blk.bitmap, int(fl.smartt), build.stream(blk.dev)),
                "control")
    control.launches += 1
    control.launches_smartt += int(fl.smartt)
    return blk.ev


control.launches = 0
control.launches_smartt = 0     # those that ran SMaRTT's update inside
