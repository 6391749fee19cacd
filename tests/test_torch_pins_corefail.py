"""PyTorch port, corefail_128n_3t run whole on the CPU against the JAX
reference, without and with the failover bench's recovery knobs
(``rto_backoff_max=2, evict_on_timeout=True``, benchmarks/failover.py):
the reference strands one flow without recovery (127 of 128 finish in the
6000-tick budget) and finishes all 128 with it.  The summaries and
``RunResult`` rows ``chip_smoke.py`` holds the card's runs to are the
reference's own, pinned here (``assert_pinned``)."""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from test_torch_engine import assert_run_parity  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
RECOVERY = dict(rto_backoff_max=2, evict_on_timeout=True)


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_pinned(key, summary):
    """``chip_smoke.REFERENCE[key]`` equals this run's summary, and
    ``chip_smoke.REFERENCE_ROWS[key]`` its ``RunResult.row()`` under
    ``summary["row"]`` (the same summary and row as the reference's, which
    the caller has checked)."""
    mod = chip_smoke()
    want = mod.REFERENCE[key]
    assert {k: summary[k] for k in want} == want, key
    assert summary["row"] == mod.REFERENCE_ROWS[key], key


@pytest.mark.parametrize("key,overrides", [("corefail_128n_3t", {}),
                                           ("corefail_128n_3t/recovery", RECOVERY)],
                         ids=["no-recovery", "recovery"])
def test_corefail_run_matches_reference(key, overrides):
    ts = assert_run_parity("corefail_128n_3t", require_done=False, **overrides)
    assert ts["n_done"] == (128 if overrides else 127)
    assert ts["blackholed"] > 0 and ts["delivered_bytes_fault"] > 0
    assert_pinned(key, ts)
