"""Slots of the lane batch that did work: the lanes' executed ticks over
batched ticks times lanes, percent."""


def read(run):
    slots = sum(s["batch_ticks"] * s["lanes"] for s in run.studies)
    return 100.0 * sum(sum(s["steps"]) for s in run.studies) / slots if slots else None
