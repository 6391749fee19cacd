"""PyTorch port, perm_512n_3t run whole on the CPU against the JAX
reference: the North star's own "done" scenario (512 nodes on the
three-tier fat tree, one 256 KiB flow a node, a cross-rack permutation).
The summary and ``RunResult`` row ``chip_smoke.py`` holds the card's run
to are the reference's own, pinned here."""

import pytest

pytest.importorskip("torch")

from test_torch_engine import assert_run_parity  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)
from test_torch_pins_corefail import assert_pinned  # noqa: E402


def test_perm512_run_matches_reference():
    ts = assert_run_parity("perm_512n_3t")
    assert ts["n_done"] == 512 and ts["trims"] > 0
    assert_pinned("perm_512n_3t", ts)
