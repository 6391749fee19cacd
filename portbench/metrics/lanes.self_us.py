"""The lane loop's own host work, its per-lane Python bookkeeping: the
program's ``lanes.loop`` spans less the spans they enclose (tick phases,
gate reads, leaps), over the traced study's batched ticks, µs."""

from portbench import spans


def _loop_self(rows):
    return sum(t for (n, *_), t in zip(rows, spans.self_ns(rows)) if n == "lanes.loop")


def read(run):
    return spans.per_tick_us(run, _loop_self)
