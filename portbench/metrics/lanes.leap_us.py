"""The lane loop's supersteps: the program's ``lanes.leap`` spans (each
lane's horizon, its host read and the jump) over the traced study's
batched ticks, µs."""

from portbench import spans


def read(run):
    return spans.per_tick_us(run, lambda rows: spans.total_ns(rows, ("lanes.leap",)))
