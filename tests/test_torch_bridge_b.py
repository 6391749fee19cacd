"""PyTorch port, ``collectives/bridge.py`` on the CPU: the all-reduce
cases of ``chip_smoke.py`` phase 4f, every field equal to the values
``chip_smoke.BRIDGE_REFERENCE`` pins (which ``tests/test_torch_bridge.py``
holds the JAX package's ``estimate`` to)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_bridge import CASES, port_matches  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "all-reduce"],
                         ids=lambda c: f"{c[0]}-{c[2]}")
def test_port_estimate_equals_the_reference(case):
    port_matches(case)
