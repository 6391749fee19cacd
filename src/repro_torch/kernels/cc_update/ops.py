"""Backend dispatch for the cc_update kernel: a drop-in replacement for
``repro_torch.core.smartt.smartt_update`` (SMaRTT fields only).

A CUDA state launches the hand-written kernel (or raises); a CPU state
takes the plain version — the only reason the plain version is taken is
that the tensors lie on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core.types import CCEvent, CCParams, CCState
from repro_torch.kernels import build
from repro_torch.kernels.cc_update import kernel as K
from repro_torch.kernels.cc_update import ref as R


def smartt_update_kernel(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    if not build.use_kernel("kernel", s.cwnd):
        return R.cc_update_ref(p, s, ev, now)
    F = s.cwnd.shape[0]
    # per-flow parameters as [F] planes (a scalar brtt broadcasts, as in
    # the reference's ops layer); already-[F] tensors pass through as is
    per_flow = {n: getattr(p, n).to(torch.float32).expand(F).contiguous()
                for n in R.PER_FLOW_PARAMS}
    return K.cc_update(p._replace(**per_flow), s, ev, int(now))
