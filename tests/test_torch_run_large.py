"""PyTorch port, the main path's two scenarios run whole on the CPU
against the JAX reference: perm_1024n_3t (the paper's 1024-node
three-tier fat tree, one flow per sender) and alltoall_3t (512 nodes,
992 flows, 31 flows per sender, so the round-robin arbitration runs).
The summaries ``chip_smoke.py`` holds the card's runs to are the
reference's own."""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from test_torch_engine import assert_run_parity  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["perm_1024n_3t", "alltoall_3t"])
def test_main_path_run_matches_reference(name):
    summary = assert_run_parity(name)
    want = _chip_smoke().REFERENCE[name]
    assert {k: summary[k] for k in want} == want
