"""Named build counters + the ``trace_guard`` context manager.

The engine's one-build contracts ("a study's lane batch comes from one
``init_state`` call", "a whole grid runs as one lane loop") are counted
through one mechanism, the reference's (``repro/analysis/trace_guard.py``):

* :func:`counter` returns a process-global named :class:`TraceCounter`;
  the counted code path calls ``.hit()`` once per entry.  In the eager
  port there is no trace: ``"state.init"`` counts calls of
  ``state.init_state`` and ``"shard.lane_loop"`` calls of
  ``shard.lane_loop`` (the reference's ``"state.init"`` and
  ``"engine.step"`` traces).
* :class:`trace_guard` is a context manager that snapshots a counter on
  entry and exposes the delta as ``.count``; with ``expect=`` it raises
  ``AssertionError`` on exit when the block counted a different number of
  hits::

      with trace_guard("shard.lane_loop", expect=1):
          study.run()            # the whole grid is ONE lane loop

The same module holds the port's spans, the host's time at each layer
boundary of the simulator's path (``study.*``, ``lanes.*``, ``tick.*``):

* :func:`span` opens a named span; off (the default) it returns one shared
  no-op context, so the path pays one flag test a span and allocates
  nothing::

      with span("lanes.gate_read"):
          live_h = live.tolist()

* :func:`recording` turns spans on for a block and yields the
  :class:`Recording`: each span's name, start and end
  (``time.perf_counter_ns``), its parent (a stack a thread), its thread
  and its counts, in memory, plus one anchor pair taken at entry that
  puts the spans on the clock of torch.profiler's kineto events
  (:meth:`Recording.rows`).  No span synchronizes the device.
* :func:`profiled` is what a study's entry points wrap themselves in: while
  a torch.profiler session is on and no recording is open, they record,
  and :func:`last_profiled` returns the last such recording, so a profiled
  study's trace comes with the host's spans over it.

This module is dependency-free (no torch, no netsim imports) so the engine
can import it without cycles.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time


class TraceCounter:
    """A process-global named counter; ``hit()`` from inside the counted
    function body counts its entries."""

    __slots__ = ("name", "count")

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def hit(self) -> None:
        self.count += 1

    def __repr__(self) -> str:
        return f"TraceCounter({self.name!r}, count={self.count})"


_COUNTERS: dict[str, TraceCounter] = {}


def counter(name: str) -> TraceCounter:
    """Get-or-create the global counter ``name`` (e.g. ``"state.init"``)."""
    c = _COUNTERS.get(name)
    if c is None:
        c = _COUNTERS[name] = TraceCounter(name)
    return c


class trace_guard:
    """Snapshot counter ``name`` for a ``with`` block.

    ``.count`` is the number of hits since entry; ``expect=`` turns the
    guard into an assertion (checked on clean exit only — an exception
    inside the block propagates untouched)::

        with trace_guard("state.init") as g:
            study.init()
        assert g.count == 1           # or: trace_guard(..., expect=1)
    """

    def __init__(self, name: str, expect: int | None = None):
        self._counter = counter(name)
        self._start = self._counter.count
        self.expect = expect

    def __enter__(self) -> "trace_guard":
        self._start = self._counter.count
        return self

    @property
    def count(self) -> int:
        return self._counter.count - self._start

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None and self.expect is not None \
                and self.count != self.expect:
            raise AssertionError(
                f"trace_guard({self._counter.name!r}): expected "
                f"{self.expect} trace(s) inside the block, saw {self.count}")
        return False


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------


class Recording:
    """The spans of one recording, in the order they opened, and the anchor
    ``(time.time_ns(), time.perf_counter_ns())`` taken as it began."""

    __slots__ = ("spans", "anchor")

    def __init__(self):
        self.spans: list[Span] = []
        self.anchor = (time.time_ns(), time.perf_counter_ns())

    def rows(self) -> list:
        """Each span as ``(name, start_ns, end_ns, parent, thread, counts)``,
        in the order they opened: times on the unix-epoch clock of
        torch.profiler's kineto events (the anchor's offset added; ``end_ns``
        None while a span is open), ``parent`` the index of the span that
        enclosed it on its thread (-1: none)."""
        at = {id(s): i for i, s in enumerate(self.spans)}
        off = self.anchor[0] - self.anchor[1]
        return [(s.name, s.start + off, None if s.end is None else s.end + off,
                 -1 if s.parent is None else at[id(s.parent)], s.thread, dict(s.counts))
                for s in self.spans]


class _Stacks(threading.local):
    def __init__(self):
        self.open: list[Span] = []


_STACKS = _Stacks()


class Span:
    """One open or closed span of a :class:`Recording` (a context manager);
    :meth:`count` adds counts known only at its end."""

    __slots__ = ("name", "counts", "start", "end", "parent", "thread", "_spans")

    def __init__(self, spans: list, name: str, counts: dict):
        self.name, self.counts, self._spans = name, counts, spans
        self.start = self.end = self.parent = self.thread = None

    def __enter__(self) -> "Span":
        stack = _STACKS.open
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        self._spans.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end = time.perf_counter_ns()
        _STACKS.open.pop()
        return False

    def count(self, **counts) -> None:
        self.counts.update(counts)


class _NoSpan:
    """What :func:`span` returns while no recording is open."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


NO_SPAN = _NoSpan()
_OPEN: Recording | None = None      # the recording spans go to; None: off
_LAST: Recording | None = None      # the last recording :func:`profiled` closed


def span(name: str, **counts):
    """A span named ``name`` (a fixed string) carrying ``counts``: recorded
    while a recording is open, else the shared no-op :data:`NO_SPAN`."""
    rec = _OPEN
    if rec is None:
        return NO_SPAN
    return Span(rec.spans, name, counts)


def recording_open() -> bool:
    """A recording is open: spans are being recorded."""
    return _OPEN is not None


@contextlib.contextmanager
def recording(rec: Recording | None = None):
    """Record every thread's spans inside the block into ``rec`` (or a new
    :class:`Recording`) and yield it; inside an open recording, the block
    records into that one."""
    global _OPEN
    if _OPEN is not None:
        yield _OPEN
        return
    _OPEN = Recording() if rec is None else rec
    try:
        yield _OPEN
    finally:
        _OPEN = None


def _profiling() -> bool:
    """A torch.profiler session is on (torch's own process-wide flag, set
    whatever the session's activities)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(getattr(prof, "_is_profiler_enabled", False))


@contextlib.contextmanager
def profiled(rec: Recording | None = None):
    """Record the block into ``rec`` (or a new recording) while a
    torch.profiler session is on and no recording is open, and keep it as
    :func:`last_profiled`; yields the recording it opened, else None."""
    global _LAST
    if _OPEN is not None or not _profiling():
        yield None
        return
    with recording(rec) as r:
        try:
            yield r
        finally:
            _LAST = r


def last_profiled() -> Recording | None:
    """The recording a study's entry points last made under torch.profiler."""
    return _LAST
