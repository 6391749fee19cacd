"""The traced study's device operations by the program's phase that
launched them, for the readers of the grants phase's launches
(``metrics/grants.ops_per_tick.py``, ``grants_roofline.py``).

The harness keeps each device operation's name, start and length, not the
host call that launched it, and an operation often starts long after its
launch (a batched tick's eager launches queue behind the fused arrivals
kernel), so its start does not tell which span launched it.  Under a
recording on a card the program launches an empty ``span_mark_kernel`` at
each edge of its grants phase (``repro_torch.kernels.build.span_mark``).
The device runs one stream in launch order, so the operations between two
marks, in the order of their starts, are the phase's.
"""

from __future__ import annotations

import sys

MARK = "span_mark_kernel"


def between_marks(run) -> list | None:
    """The device operations ``(name, start_ns, length_ns)`` between each
    pair of marks of the traced study, one list a pair, so one a batched
    tick; None without a trace, without marks (a program that launches
    none), or where the marks are not two a batched tick (a record
    lost)."""
    if run.trace is None:
        return None
    out, inside = [], None
    for op in sorted(run.trace["ops"], key=lambda o: o[1]):
        if MARK not in op[0].split("(", 1)[0]:
            if inside is not None:
                inside.append(op)
        elif inside is None:
            inside = []
        else:
            out.append(inside)
            inside = None
    if not out:
        return None
    if inside is not None or len(out) != run.trace["study"]["batch_ticks"]:
        print(f"portbench: {len(out)} pairs of {MARK} in the traced study, not one a batched "
              f"tick ({run.trace['study']['batch_ticks']})", file=sys.stderr)
        return None
    return out
