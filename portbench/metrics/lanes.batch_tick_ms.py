"""A batched tick of the lane loop: the studies' ``wall_s`` over their
batched ticks (``sim.stats["lanes"]["batch_ticks"]``), ms.  ``wall_s``
covers the lane loop and the copy of the final states to the host, so
the copy is spread over the ticks."""


def read(run):
    ticks = sum(s["batch_ticks"] for s in run.studies)
    return 1e3 * sum(s["wall_s"] for s in run.studies) / ticks if ticks else None
