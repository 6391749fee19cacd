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

This module is dependency-free (no torch, no netsim imports) so the engine
can import it without cycles.
"""

from __future__ import annotations


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
