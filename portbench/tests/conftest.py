"""Fixtures of the benchmark's tests (CPU)."""

import pytest

from portbench_tiny import make_tiny


@pytest.fixture
def tiny(tmp_path):
    """``make(kind, max_ticks=) -> (bench, cell name, mixes dir)``."""
    return lambda kind="permutation", **kw: make_tiny(tmp_path, kind, **kw)


@pytest.fixture
def run_tiny(tiny):
    """Run the tiny cell once on the CPU (the reference in this process)."""
    from portbench import harness

    def go(kind: str = "permutation", seed: int = 2**33 + 7, trace: bool = False, **kw):
        bench, name, mixes = tiny(kind, **kw)
        return harness.run_cell(bench, name, seed, 0.2, trace, device="cpu", mixes=mixes,
                                ref_workers=0)
    return go
