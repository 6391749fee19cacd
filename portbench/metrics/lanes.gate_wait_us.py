"""The host blocked on the card in the lane loop: the program's
``lanes.gate_read`` spans (the tick's one host read of the lanes' gate, and
the loop's first reads) over the traced study's batched ticks, µs."""

from portbench import spans


def read(run):
    return spans.per_tick_us(run, lambda rows: spans.total_ns(rows, ("lanes.gate_read",)))
