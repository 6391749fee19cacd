"""The copy of the traced study's final states to the host
(``state.to_numpy`` of the finished batch): the program's
``study.host_copy`` spans, ms a study."""

from portbench import spans


def read(run):
    rows = spans.of(run)
    if rows is None:
        return None
    return spans.total_ns(rows, ("study.host_copy",)) / 1e6
