"""The host issuing a batched tick's grants phase (EQDS's pull credits,
``sender.grants``): the program's ``tick.grants`` spans over the traced
study's batched ticks, µs."""

from portbench import spans


def read(run):
    return spans.per_tick_us(run, lambda rows: spans.total_ns(rows, ("tick.grants",)))
