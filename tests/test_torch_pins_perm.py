"""PyTorch port, the paper's comparison at its 1024-node scale
(perm_1024n_3t under swift, mprdma and eqds) and the credit pick at its
widest (incast_256x1_3t under eqds: 256 flows into one receiver, the
grant pick over [512, 256] every tick), run whole on the CPU against the
JAX reference.  The summaries and ``RunResult`` rows ``chip_smoke.py``
holds the card's runs to are the reference's own, pinned here."""

import pytest

pytest.importorskip("torch")

from test_torch_engine import assert_run_parity  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)
from test_torch_pins_corefail import assert_pinned  # noqa: E402


@pytest.mark.parametrize("name,algo", [("perm_1024n_3t", "swift"),
                                       ("perm_1024n_3t", "mprdma"),
                                       ("perm_1024n_3t", "eqds"),
                                       ("incast_256x1_3t", "eqds")])
def test_comparison_run_matches_reference(name, algo):
    ts = assert_run_parity(name, algo=algo)
    assert_pinned(f"{name}/{algo}", ts)
