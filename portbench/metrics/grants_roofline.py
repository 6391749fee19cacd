"""The grants phase's share of its roofline over the traced study: the
least bytes the phase must move (``portbench/roofline/grants.py``) at the
card's memory rate, over the device time of the operations between the
marks at the phase's edges (``span_ops.between_marks``), percent."""

from portbench import roofline, span_ops
from portbench.roofline import grants


def read(run):
    pairs = span_ops.between_marks(run)
    if pairs is None or run.shapes is None:
        return None
    study = run.trace["study"]
    nbytes, flops = grants.study_bytes(run.shapes, sum(study["steps"]), study["lanes"],
                                       grants.workload(run))
    return roofline.share(nbytes, flops, sum(d for ops in pairs for _, _, d in ops) / 1e9)
