"""Lanes a second: the lanes of every study of the window over the
window's wall (host clock, results on the host included)."""


def read(run):
    if not run.studies or run.window_s <= 0:
        return None
    return sum(s["lanes"] for s in run.studies) / run.window_s
