"""Plain PyTorch version of the RED dequeue-mark + trim-admission kernel.

The switch datapath of the paper (Sec. 2.1: RED with dequeue marking,
Sec. 3.3: trim-on-full) over every port queue: a coin flip from the
splitmix32 counter hash on ``(tick * 131071 + queue index, salt)``,
marking with probability linear in occupancy between ``kmin`` and
``kmax``, plus how many of this tick's arrivals fit (the rest are
trimmed).

Line for line the reference's ``repro/kernels/red_mark/ref.py``, with the
arithmetic of its Pallas kernel (``kernel.py:22-37``) where the two could
part:
- ``kmin`` and ``kmax`` are f32 values and ``kmax - kmin`` is an f32
  difference, floored at ``1e-6``;
- ``tick`` and ``salt`` are i32 values (the reference's ref takes them as
  i32; its Pallas kernel packs them into an f32 row, which rounds them
  from ``2**24`` on — a quirk of the reference that this port does not
  copy);
- the first hash lane ``tick * 131071 + q`` wraps modulo ``2**32``, as the
  i32 product does in the reference.

``kmin`` and the span stay 0-d tensors on the data's device: on CUDA,
PyTorch divides by a Python scalar as a multiply by its reciprocal, which
is not the IEEE quotient the kernel computes.
"""

from __future__ import annotations

import torch

from repro_torch.netsim import hashing

I32 = torch.int32
F32 = torch.float32


def red_mark_ref(q_size, arrivals, cap, kmin, kmax, tick, salt):
    """RED dequeue-marking + trim admission for every port.

    Args:
      q_size: i32 [..., Q] occupancy of each port queue.
      arrivals: i32 [..., Q] packets trying to enqueue this tick.
      cap: queue capacity; kmin / kmax: RED thresholds (packets).
      tick, salt: the coin flip's hash lanes (i32 values).

    Returns ``(mark, admit, trim)``: bool / i32 / i32 [..., Q].
    """
    dev = q_size.device
    kmin_t = torch.as_tensor(kmin, dtype=F32, device=dev)
    kmax_t = torch.as_tensor(kmax, dtype=F32, device=dev)
    span = (kmax_t - kmin_t).clamp_min(1e-6)          # the floor as an f32
    p = torch.clamp((q_size.to(F32) - kmin_t) / span, 0.0, 1.0)
    qidx = torch.arange(q_size.shape[-1], dtype=torch.int64, device=dev)
    u = hashing.uniform01(qidx + int(tick) * 131071, int(salt))
    mark = (u < p) & (q_size > 0)
    space = (int(cap) - q_size).clamp_min(0)
    admit = torch.minimum(arrivals, space)
    return mark, admit, arrivals - admit
