"""Planning a study (``api.study``: derive each point's tables on the card,
stack the lanes' constants), ms a study, by the host's clock."""


def read(run):
    if not run.studies:
        return None
    return 1e3 * sum(s["plan_s"] for s in run.studies) / len(run.studies)
