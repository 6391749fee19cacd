"""PyTorch port, ``collectives/bridge.py`` on the CPU: ``estimate`` of
the collectives ``chip_smoke.py`` phase 4f drives on the card — the
all-to-all of 4 MiB (a dbrx expert-parallel dispatch) and the all-reduce
of 8 MiB (a cross-pod gradient exchange), 32 nodes at 4:1
oversubscription, under smartt, swift and eqds — every field equal to
the JAX package's ``estimate``, and both equal to the values
``chip_smoke.BRIDGE_REFERENCE`` pins.

Equality is exact: the simulator's integer state runs bit for bit on the
port, so the completion times, trims and everything computed from them
(efficiency, straggler spread, Jain fairness, in float64 from the same
integers) are the same numbers.  The all-reduce cases' port runs are in
``tests/test_torch_bridge_b.py`` (each file stays under a minute).
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.collectives import bridge as jbridge  # noqa: E402
from repro_torch.collectives import bridge  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CASES = tuple(chip_smoke.BRIDGE_REFERENCE)
KW = chip_smoke.BRIDGE_KW


def port_matches(case):
    kind, nbytes, algo = case
    est = bridge.estimate(kind, nbytes, algo=algo, device="cpu", **KW)
    assert isinstance(est, bridge.CollectiveEstimate)
    assert dataclasses.astuple(est) == chip_smoke.BRIDGE_REFERENCE[case]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[2]}")
def test_jax_estimate_equals_the_pinned_values(case):
    kind, nbytes, algo = case
    est = jbridge.estimate(kind, nbytes, algo=algo, **KW)
    assert dataclasses.astuple(est) == chip_smoke.BRIDGE_REFERENCE[case]
    assert [f.name for f in dataclasses.fields(est)] == \
        [f.name for f in dataclasses.fields(bridge.CollectiveEstimate)]


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "all-to-all"],
                         ids=lambda c: f"{c[0]}-{c[2]}")
def test_port_estimate_equals_the_reference(case):
    port_matches(case)


def test_refine_collective_term_equals_the_reference():
    kw = dict(nodes=32, oversub=4, max_bytes=64 * 1024)
    want = jbridge.refine_collective_term(2.0, "collective-permute", 64 * 1024,
                                          algo="smartt", **kw)
    got = bridge.refine_collective_term(2.0, "collective-permute", 64 * 1024,
                                        algo="smartt", device="cpu", **kw)
    assert got == want
    assert got["refined_s"] >= got["ideal_s"] and 0 < got["efficiency"] <= 1.0


def test_unknown_collective_raises_and_the_card_is_the_default():
    with pytest.raises(KeyError):
        bridge.estimate("broadcast", 1 << 20, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    with pytest.raises((RuntimeError, AssertionError)):
        bridge.estimate("all-to-all", 1 << 20)
