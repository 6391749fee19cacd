"""Plain PyTorch version of the cc_update kernel.

The plain version *is* the paper-faithful update in
``repro_torch.core.smartt``: the CUDA kernel must produce bit-identical
window updates.  The field tables below name the planes the kernel reads
and writes, in the reference's order (``repro/kernels/cc_update/ref.py``);
the two boolean state planes and the two boolean event planes stay bool
(one byte) instead of the reference's packed i32.
"""

from __future__ import annotations

from repro_torch.core.smartt import smartt_update
from repro_torch.core.types import CCEvent, CCParams, CCState

# scalar parameters, passed to the kernel by value (reference layout)
PARAM_FIELDS = (
    "mtu", "bdp", "maxcwnd", "mincwnd", "fd", "md", "fi", "k_fast",
    "qa_scaling", "wtd_alpha", "wtd_thresh", "fi_rtt_tol", "react_every",
)
PER_FLOW_PARAMS = ("brtt", "trtt", "mi")

STATE_F32 = ("cwnd", "acked", "qa_end", "bytes_to_ignore", "bytes_ignored",
             "fi_count", "avg_wtd")
STATE_BOOL = ("trigger_qa", "fi_active")
STATE_I32 = ("ack_count",)
EVENT_F32 = ("ack_bytes", "rtt", "trim_bytes", "to_bytes", "unacked")
EVENT_BOOL = ("has_ack", "ecn")
EVENT_I32 = ("n_trims", "n_timeouts")


def cc_update_ref(p: CCParams, s: CCState, ev: CCEvent, now) -> CCState:
    """One SMaRTT tick for every flow; ``now`` is the integer tick."""
    return smartt_update(p, s, ev, now)
