"""PyTorch port, the experiment API's study rows on the CPU against the
JAX package's: ``api.study(...).run().rows()`` equal on every key but
``wall_s``, on tiny_incast3 (2 points x 2 seeds) and on incast8_16n
(three points of ``benchmarks/sweep.py``'s ``GRID`` x 2 seeds) under
SMaRTT and under EQDS's credits.  The JAX study runs its lanes as one
vmapped batch; the port as one lane batch (``netsim/shard.py``)."""

import pytest

pytest.importorskip("torch")

from repro.netsim import api as japi  # noqa: E402
from repro_torch.netsim import api  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)


def _no_wall(rows):
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in rows]


# three points of benchmarks/sweep.py's GRID
GRID3 = ({"start_cwnd_mult": 0.5, "react_every": 1},
         {"start_cwnd_mult": 1.0, "react_every": 4},
         {"kmin_frac": 0.1, "kmax_frac": 0.4})


@pytest.mark.parametrize("name,points,algo", [
    ("tiny_incast3", ({"start_cwnd_mult": 0.5}, {"start_cwnd_mult": 1.0}), "smartt"),
    ("incast8_16n", GRID3, "smartt"),
    ("incast8_16n", GRID3, "eqds"),
], ids=["tiny_incast3", "incast8_16n-smartt", "incast8_16n-eqds"])
def test_study_rows_match_reference(name, points, algo):
    want = japi.study(name, points=points, seeds=(0, 1), algo=algo).run()
    got = api.study(name, points=points, seeds=(0, 1), algo=algo, device="cpu").run()
    assert _no_wall(got.rows()) == _no_wall(want.rows())
    assert (got.n_points, got.n_seeds) == (want.n_points, want.n_seeds)
    assert got.best("completion").name == want.best("completion").name
