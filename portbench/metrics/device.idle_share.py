"""The card's idle share of the traced study: one less the union of its
device operations' intervals over the traced window, percent."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0 or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
