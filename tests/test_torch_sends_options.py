"""PyTorch port, the sends phase on the comparison paths: ``sends_ref``
against the JAX package's ``sender.sends`` from reference pre-sends
states (``test_torch_sends.check_sends_phase``), every leaf exact, under
EQDS (credits and the speculative budget gate and pay), BBR (the pacing
budget accrues, gates and pays) and the other load balancers (spraying's
counter and hash, ECMP, PLB's entropy).  One file apart from
``test_torch_sends.py`` so ``--dist loadfile`` spreads them."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import one_torch_thread  # noqa: E402,F401 (autouse)
from test_torch_sends import check_sends_phase  # noqa: E402


@pytest.mark.parametrize("name,overrides,needs", [
    ("perm_128n_3t", dict(algo="eqds"), {"emit", "retx", "credit", "spec"}),
    ("perm_128n_3t", dict(algo="bbr"), {"emit", "retx", "pace"}),
    ("tiny_incast3", dict(lb="spray"), {"emit", "spray"}),
    ("tiny_incast3", dict(lb="ecmp"), {"emit"}),
    ("tiny_incast3", dict(lb="plb"), {"emit"}),
], ids=["eqds", "bbr", "spray", "ecmp", "plb"])
def test_sends_phase_matches_reference_on_options(name, overrides, needs):
    kinds, _ = check_sends_phase(name, **overrides)
    assert needs <= kinds, (needs - kinds)
