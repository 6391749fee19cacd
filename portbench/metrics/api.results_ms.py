"""The experiment API's result extraction (``Study.run`` less its own
``wall_s``, which covers the lane loop and the host copy): ms a study."""


def read(run):
    if not run.studies:
        return None
    return 1e3 * sum(s["run_s"] - s["wall_s"] for s in run.studies) / len(run.studies)
