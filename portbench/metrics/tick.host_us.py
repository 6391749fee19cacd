"""The host's time issuing a batched tick's six phases (the PyTorch and
the fused launches of ``Sim.tick``): the program's ``tick.*`` spans over
the traced study's batched ticks, µs."""

from portbench import spans


def read(run):
    return spans.per_tick_us(run, lambda rows: spans.total_ns(rows, spans.TICK))
