"""The program's spans over the traced study, for the span readers
(``metrics/api.host_copy_ms.py``, ``tick.host_us.py``, ``lanes.*_us.py``).

While a torch.profiler session is on, the program's study entry points
record their spans (``repro_torch.analysis.trace_guard.profiled``), so the
traced study comes with the host's spans over it: the program's
``last_profiled()`` recording, each span put on the clock of the
profiler's device events by the recording's anchor.  A program without the
recorder gives None here, and every span reader None with it.

The first reader to ask also adds two keys to the traced study's
``breakdown`` (``device_ops`` and ``idle_gaps`` are left as they are):

* ``host_spans``: each span name's self time (its spans less the spans
  they enclose on their thread), the ten largest, seconds;
* ``idle_by_span``: the card's idle time over the traced window, each idle
  interval charged to the innermost span open over it, summed by name:
  the ten largest, then the rest of the spans as one row and the idle
  time outside every span as another, seconds.  The rows sum to the
  window's idle time.

The anchor puts the spans on the profiler's host clock (each CUDA launch
record lies inside the span that issued it), but the profiler's device
timestamps move against that clock within one session, by up to ~3 ms
over a study on the H100.  So ``idle_by_span`` first puts the spans on the
device's clock through the lane loop's sync points (:func:`device_clock`).
"""

from __future__ import annotations

import bisect
import importlib
import sys

import numpy as np

TICK = ("tick.departures", "tick.arrivals", "tick.control", "tick.grants", "tick.sends",
        "tick.metrics")
OTHERS = "(other spans)"
OUTSIDE = "(outside spans)"
TOP = 10
READS = ("lanes.gate_read", "lanes.leap_read")


def of(run):
    """The traced study's closed spans as ``(name, start_ns, end_ns, parent,
    thread, counts)`` on the profiler's host clock (``parent``: an index
    into the list, -1 for none); ``[]`` where the program recorded no span
    of it; None without a trace or where the program has no recorder."""
    if run.trace is None:
        return None
    if "spans" not in run.trace:
        rows = _program_spans(run)
        run.trace["spans"] = rows
        if rows is not None:
            run.trace["breakdown"]["host_spans"] = host_spans(rows)
            run.trace["breakdown"]["idle_by_span"] = idle_by_span(
                run.trace["ops"], rows, run.trace["window_s"])
    return run.trace["spans"]


def _program_spans(run):
    try:
        guard = importlib.import_module("repro_torch.analysis.trace_guard")
    except ImportError:
        return None
    last = getattr(guard, "last_profiled", None)
    if last is None:
        return None
    rec = last()
    if rec is None:
        return []
    rows = rec.rows()
    ticks = sum(c.get("batch_ticks", 0) for n, _, _, _, _, c in rows if n == "lanes.loop")
    if ticks != run.trace["study"]["batch_ticks"] or any(r[2] is None for r in rows):
        print(f"portbench: the program's last profiled spans ({ticks} batched ticks) are not "
              f"the traced study's ({run.trace['study']['batch_ticks']})", file=sys.stderr)
        return []
    return rows


def total_ns(rows, names) -> int:
    return sum(e - s for n, s, e, _, _, _ in rows if n in names)


def self_ns(rows) -> list:
    """Each span's time less that of the spans it encloses."""
    out = [e - s for _, s, e, _, _, _ in rows]
    for _, s, e, p, _, _ in rows:
        if p >= 0:
            out[p] -= e - s
    return out


def per_tick_us(run, ns_of):
    """``ns_of(spans)`` over the traced study's batched ticks, µs (None
    without spans)."""
    rows = of(run)
    ticks = run.trace["study"]["batch_ticks"] if rows is not None else 0
    if not ticks:
        return None
    return ns_of(rows) / ticks / 1e3


def host_spans(rows) -> list:
    by = {}
    for (n, *_), t in zip(rows, self_ns(rows)):
        by[n] = by.get(n, 0) + t
    top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k, v / 1e9] for k, v in top]


def _busy(ops, w0: int, w1: int) -> list:
    """The union of the device operations' intervals within ``[w0, w1]``."""
    out = []
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        s, e = max(s, w0), min(s + d, w1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_clock(rows, ops) -> list:
    """The spans on the device operations' clock.  A host read of the lane
    loop (``lanes.gate_read``, ``lanes.leap_read``) returns just after its
    device-to-host copy ends, and a tick's first fused launch
    (``departures_kernel``, from its ``tick.departures`` span) comes after
    the read before it on both clocks.  So each batched tick gives one pair:
    the end of the last read before its departures span, on the host, and
    the end of the last DtoH copy before its departures kernel, on the
    device.  The offset between the clocks is interpolated between the
    pairs (held beyond the first and the last).  Without such pairs the
    spans are returned as they are."""
    dep_h = sorted(s for n, s, *_ in rows if n == "tick.departures")
    dep_d = sorted(s for n, s, _ in ops if "departures_kernel" in n.split("(", 1)[0])
    if not dep_h or len(dep_h) != len(dep_d):
        return rows
    reads = sorted(e for n, _, e, *_ in rows if n in READS)
    copies = sorted(s + d for n, s, d in ops if "Memcpy DtoH" in n)
    at, off = [], []
    for h, d in zip(dep_h, dep_d):
        i, j = bisect.bisect_left(reads, h) - 1, bisect.bisect_left(copies, d) - 1
        if i >= 0 and j >= 0:
            at.append(reads[i])
            off.append(reads[i] - copies[j])
    if not at:
        return rows
    x = np.subtract(at, at[0], dtype=np.int64)

    def shift(ts):
        t = np.asarray(ts, np.int64)
        return (t - np.rint(np.interp(t - at[0], x, off)).astype(np.int64)).tolist()

    starts, ends = shift([r[1] for r in rows]), shift([r[2] for r in rows])
    return [(n, s, e, p, th, c) for (n, _, _, p, th, c), s, e in zip(rows, starts, ends)]


def idle_by_span(ops, rows, window_s: float) -> list:
    """The traced window's idle time by the innermost span open over it
    (module docstring), the spans on the device's clock
    (:func:`device_clock`).  The window starts where the first span starts
    (the study's planning), or at the first device operation without
    spans."""
    rows = device_clock(rows, ops)
    starts = [s for _, s, _, _, _, _ in rows] or [s for _, s, _ in ops] or [0]
    w0 = min(starts)
    w1 = w0 + round(window_s * 1e9)
    busy = _busy(ops, w0, w1)
    # idle time before t: the window's time before t less the busy time before it
    b0 = [s for s, _ in busy]
    cum = [0]
    for s, e in busy:
        cum.append(cum[-1] + e - s)

    def idle_before(t: int) -> int:
        i = bisect.bisect_right(b0, t)
        done = cum[i] - (max(busy[i - 1][1] - t, 0) if i else 0)
        return t - w0 - done

    events = []
    for i, (_, s, e, _, _, _) in enumerate(rows):
        s, e = max(s, w0), min(e, w1)
        if e > s:
            events += [(s, 1, i), (e, 0, i)]
    events.sort()
    by, open_, t = {}, set(), w0
    for time, opens, i in events + [(w1, 0, -1)]:
        if time > t:
            name = rows[max(open_, key=lambda j: (rows[j][1], j))][0] if open_ else OUTSIDE
            by[name] = by.get(name, 0) + idle_before(time) - idle_before(t)
            t = time
        if i >= 0:
            (open_.add if opens else open_.discard)(i)
    outside = by.pop(OUTSIDE, 0)
    named = sorted(((k, v) for k, v in by.items() if v > 0), key=lambda kv: -kv[1])
    out = [[k, v / 1e9] for k, v in named[:TOP]]
    rest = sum(v for _, v in named[TOP:])
    if rest:
        out.append([OTHERS, rest / 1e9])
    return out + [[OUTSIDE, outside / 1e9]]
