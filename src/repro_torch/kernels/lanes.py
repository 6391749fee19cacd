"""The lane axis of the fused tick kernels: a study's lanes as one batch.

A lane batch holds ``L`` runs of one simulator (a study's ``P x S`` grid,
or one run as ``L = 1``).  Every operand of a fused phase carries a
leading lane axis ``[L, ...]``: the state's buffers one row a lane, a run
constant either shared by all lanes (an ``expand``-ed view, lane stride 0)
or swept (one row a lane).  A kernel launches once for all lanes, one
grid row (``blockIdx.y``) a lane, and moves each pointer by its lane
stride (``csrc/lanes.cuh``).

``Tick`` is the batch's clock: each lane's tick ``now`` and its gate
``live`` on the device, where the kernels read them, and the host's
copies, which the run loop keeps in step (it reads the gate once a tick
and the leap once a superstep) and which the plain versions read.  A lane
that is not live is a bitwise no-op: its kernels return at once and its
plain versions skip it.

A batch may also be split into shards, each run by a thread of its own
(``netsim/shard.py``).  What a wrapper keeps from one launch to the next
(its argument block, a plain version's lane views) is kept per thread
(:func:`thread_cache`), so that each shard keeps its own and two shards
never swap it under each other.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

I32 = torch.int32


class Tick(NamedTuple):
    """One batched tick's clock."""

    now: torch.Tensor     # i32 [L] each lane's tick, on the device
    live: torch.Tensor    # bool [L] the lane gate, on the device
    now_h: tuple          # the host's copies of both
    live_h: tuple

    @property
    def n(self) -> int:
        return len(self.now_h)

    @property
    def all_live(self) -> bool:
        """Every lane live: the tick's masks are the identity, and skipped."""
        return all(self.live_h)


class _PerThread(threading.local):
    def __init__(self):
        self.caches = {}


_PER_THREAD = _PerThread()


def thread_cache(name: str) -> dict:
    """The calling thread's cache ``name`` (a dict, made empty on first
    use).  A thread's caches go with it."""
    return _PER_THREAD.caches.setdefault(name, {})


_AT: dict = {}


def tick_at(t: int, device) -> Tick:
    """A one-lane, live ``Tick`` at host tick ``t`` (the single-lane
    wrappers' clock; the device tensors are made once per tick value)."""
    key = (torch.device(device), int(t))
    hit = _AT.get(key)
    if hit is None:
        if len(_AT) > 4096:
            _AT.clear()
        hit = _AT[key] = Tick(torch.tensor([int(t)], dtype=I32, device=device),
                              torch.ones((1,), dtype=torch.bool, device=device),
                              (int(t),), (True,))
    return hit


def _walk(cache: dict, x, path: tuple, make):
    if x is None:
        return None
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_walk(cache, v, path + (f,), make) for f, v in zip(x._fields, x)))
    hit = cache.get(path)
    if hit is None or hit[0] is not x:
        hit = cache[path] = (x, make(x))
    return hit[1]


def one_lane(cache: dict, o):
    """``o`` (a NamedTuple tree of single-lane tensors) as a one-lane batch
    of views.  The view of a tensor is made once and kept in ``cache`` (one
    entry a field), so a kernel's block sees the same operands each call."""
    return _walk(cache, o, (), lambda x: x.unsqueeze(0))


def lane_views(cache: dict, o, n: int) -> list:
    """The ``n`` per-lane views of a batch ``o`` (every tensor ``[n, ...]``),
    as a list of trees like ``o``.  Each tensor's views are made once and
    kept in ``cache`` (one entry a field), so a plain version called lane
    by lane gets the same tensors each tick, as a kernel's block holds the
    same operands."""
    per = _walk(cache, o, (), lambda x: tuple(x[i] for i in range(n)))

    def pick(tree, i):
        if tree is None:
            return None
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(pick(v, i) for v in tree))
        return tree[i]
    return [pick(per, i) for i in range(n)]


def operand(x, name: str, dtype, shape, device, n: int, *, state: bool = False):
    """Validate one lane-batched operand and return ``(pointer, lane stride
    in bytes)``.  ``x`` must be ``[n, *shape]`` on ``device`` with each
    lane's block contiguous.  A ``state`` operand (one the kernel writes)
    needs a row of its own a lane; a constant may be shared (lane stride
    0, an ``expand``-ed view).  An empty block (a zero in ``shape``: a
    case with no dependencies, say) is never read; its lane stride is
    passed as 0, whatever PyTorch's strides for a zero-size tensor are."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    want = (n, *shape)
    if tuple(x.shape) != want:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {want} "
                         f"({n} lanes of {tuple(shape)})")
    per = 1
    for s in shape:
        per *= s
    if not x[0].is_contiguous():
        raise ValueError(f"{name}: a lane's block is not contiguous (strides {x.stride()})")
    stride = x.stride(0) if n > 1 and per else 0
    if n > 1 and per and not (stride == per or (stride == 0 and not state)):
        raise ValueError(f"{name}: lane stride {stride} elements; expected {per}"
                         + ("" if state else " or 0 (shared)"))
    return ctypes.c_void_p(x.data_ptr()), stride * x.element_size()


def strides(values) -> ctypes.Array:
    """A ctypes ``long long[]`` of lane strides for a kernel's block."""
    return (ctypes.c_longlong * len(values))(*values)
