"""ctypes wrapper of the CUDA ``cc_update`` kernel (``csrc/cc_update.cu``).

One thread per flow applies the whole SMaRTT update (Alg. 1-3) to the
structure-of-arrays state planes; the outputs are fresh tensors.  The
wrapper checks every operand (device, dtype, shape [F], contiguity),
launches on PyTorch's current stream, raises if the launch failed, and
counts its launches in ``cc_update.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.types import CCEvent, CCParams, CCState
from repro_torch.kernels import build
from repro_torch.kernels.cc_update import ref as R

_PTR_FIELDS = (
    [f"s_{n}" for n in R.STATE_F32 + R.STATE_BOOL + R.STATE_I32]
    + [f"e_{n}" for n in R.EVENT_F32 + R.EVENT_BOOL + R.EVENT_I32]
    + [f"p_{n}" for n in R.PER_FLOW_PARAMS]
    + [f"o_{n}" for n in R.STATE_F32 + R.STATE_BOOL + R.STATE_I32]
)


class _Args(ctypes.Structure):
    """Mirror of ``struct CCArgs`` (field order is the C order)."""
    _fields_ = [(n, ctypes.c_void_p) for n in _PTR_FIELDS] + [
        ("n", ctypes.c_int), ("now", ctypes.c_int)]


class _Params(ctypes.Structure):
    """Mirror of ``struct CCParamsC``."""
    _fields_ = [(n, ctypes.c_float) for n in R.PARAM_FIELDS]


# The scalar parameters are constant for a run, so their host copy is
# made once per set of parameter tensors (one device read), not every tick.
_host_params: list = [(), None]


def _params_by_value(p: CCParams) -> _Params:
    scalars = tuple(getattr(p, n) for n in R.PARAM_FIELDS)
    cached = _host_params[0]
    if len(cached) != len(scalars) or any(a is not b for a, b in zip(cached, scalars)):
        vals = torch.stack([x.to(torch.float32).reshape(()) for x in scalars]).tolist()
        _host_params[:] = [scalars, _Params(*vals)]
    return _host_params[1]


def _fn():
    fn = build.library().repro_cc_update
    fn.argtypes = [_Args, _Params, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cc_update(p: CCParams, s: CCState, ev: CCEvent, now: int) -> CCState:
    """Launch the kernel on CUDA tensors; returns the updated state (the
    non-SMaRTT fields pass through)."""
    dev = s.cwnd.device
    n = s.cwnd.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    kinds = ([(n_, f32) for n_ in R.STATE_F32] + [(n_, b8) for n_ in R.STATE_BOOL]
             + [(n_, i32) for n_ in R.STATE_I32])
    ekinds = ([(n_, f32) for n_ in R.EVENT_F32] + [(n_, b8) for n_ in R.EVENT_BOOL]
              + [(n_, i32) for n_ in R.EVENT_I32])
    ptrs = {}
    for name, dt in kinds:
        ptrs[f"s_{name}"] = build.require(getattr(s, name), f"state.{name}", dt, (n,), dev)
    for name, dt in ekinds:
        ptrs[f"e_{name}"] = build.require(getattr(ev, name), f"event.{name}", dt, (n,), dev)
    for name in R.PER_FLOW_PARAMS:
        ptrs[f"p_{name}"] = build.require(getattr(p, name), f"params.{name}", f32, (n,), dev)
    build.on_card(dev, "cc_update")
    outs = {name: torch.empty((n,), dtype=dt, device=dev) for name, dt in kinds}
    for name, t in outs.items():
        ptrs[f"o_{name}"] = ctypes.c_void_p(t.data_ptr())
    args = _Args(**{k: v.value for k, v in ptrs.items()}, n=n, now=int(now))
    build.check(_fn()(args, _params_by_value(p), build.stream(dev)), "cc_update")
    cc_update.launches += 1
    return s._replace(**outs)


cc_update.launches = 0
