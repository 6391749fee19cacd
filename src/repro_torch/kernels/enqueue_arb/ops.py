"""Backend dispatch for the enqueue-rank + arbitration kernels.

Two phase-facing callables: ``arrivals_ref``, the fused arrivals phase's
plain version, calls ``enqueue_rank`` (with the ``"plain"`` backend, or
with ``"kernel"`` under the split design); ``sends_ref``, the fused sends
phase's plain version, and the EQDS grants call ``rr_pick``
(``kernels/sends/ops``: the kernel under the split design and for the
grants):

  ``enqueue(in_tbl, in_pos, sw_of_q, edst, q_head, q_size, cap, nq)
      -> (acc, pos, q_counts)``
      Same-destination enqueue acceptance + ring position per
      enqueue-capable emitter (the compact [EQ] axis — see
      ``topology.build_topology``), plus the per-queue accepted count.
      The structure is the reference's (``enqueue_arb/ops.py``): the
      gathers through ``in_tbl`` stay out here in PyTorch, the kernel runs
      on the ``[NSW, DMAX]`` group rows, the per-queue counts come from a
      scatter-free compare+reduce over ``sw_of_q`` (every writer into
      queue q sits in the fan-in group of q's owning switch), and the
      results are gathered back through ``in_pos``.

  ``arb(elig, rr, kmax) -> (has, sel)``
      Per-row round-robin argmin (see ``ref.rr_pick_ref``).

``"kernel"`` launches the CUDA kernel for CUDA tensors and takes the
plain version for CPU tensors; ``"plain"`` always takes the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.enqueue_arb import kernel as K
from repro_torch.kernels.enqueue_arb import ref as R

I32 = torch.int32

def enqueue_rank(in_tbl, in_pos, sw_of_q, edst, q_head, q_size, cap: int,
                 nq: int, *, backend: str = "kernel"):
    """Acceptance + queue position for every emitter's enqueue attempt.

    ``edst`` is i32 [EQ] over the compact enqueue-capable emitters
    (sentinel ``nq`` = no enqueue this tick); ``q_head``/``q_size`` are
    the [NQ+1] queue rings.  Returns ``(acc, pos, q_counts)``
    ([EQ] bool / [EQ] i32 / [NQ] i32)."""
    gdst = torch.cat([edst, edst.new_full((1,), nq)])[in_tbl]
    ghead = q_head[gdst]
    gsize = q_size[gdst]
    if build.use_kernel(backend, gdst):
        _, acc_g, pos = K.enqueue_rank(gdst, ghead, gsize, cap=cap, nq=nq)
    else:
        _, acc_g, pos = R.enqueue_rank_ref(gdst, ghead, gsize, cap=cap, nq=nq)
    qsel = gdst[sw_of_q] == torch.arange(nq, dtype=I32, device=gdst.device)[:, None]
    q_counts = torch.sum(qsel & acc_g[sw_of_q], dim=1, dtype=I32)
    # in_pos is each compact emitter's flat slot in the group tables
    return acc_g.reshape(-1)[in_pos], pos.reshape(-1)[in_pos], q_counts


def rr_pick(elig, rr, kmax: int, *, backend: str = "kernel"):
    """Round-robin argmin per row — see ``ref.rr_pick_ref``."""
    if build.use_kernel(backend, elig):
        return K.rr_pick(elig, rr, kmax=kmax)
    return R.rr_pick_ref(elig, rr, kmax=kmax)

