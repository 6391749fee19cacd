"""Device operations of the grants phase a batched tick: those between
the two marks the program launches at the phase's edges
(``span_ops.between_marks``), over the traced study's batched ticks (one
grants phase each).  One once the phase is a single fused launch."""

from portbench import span_ops


def read(run):
    pairs = span_ops.between_marks(run)
    if pairs is None:
        return None
    return sum(map(len, pairs)) / len(pairs)
