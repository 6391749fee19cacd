"""Ticks the run loop leapt over in closed form instead of executing: the
lanes' final ticks less their executed ticks, over their final ticks,
percent."""


def read(run):
    ticks = sum(sum(s["ticks"]) for s in run.studies)
    steps = sum(sum(s["steps"]) for s in run.studies)
    return 100.0 * (ticks - steps) / ticks if ticks else None
