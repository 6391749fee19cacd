"""PyTorch port on a CUDA card: each hand-written kernel against its plain
PyTorch version (bit for bit, at the main path's shapes and ragged
ones), and small scenarios through the kernels against the same runs on
the CPU (final states bit for bit, one launch of each tick kernel per
executed tick).

Every test is marked ``gpu`` and skips without a card; whether there is
one is decided inside the fixture.  This file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.cc_update import kernel as CK  # noqa: E402
from repro_torch.kernels.cc_update import ref as CR  # noqa: E402
from repro_torch.kernels.enqueue_arb import kernel as EK  # noqa: E402
from repro_torch.kernels.enqueue_arb import ref as ER  # noqa: E402
from repro_torch.kernels.ring_drain import kernel as DK  # noqa: E402
from repro_torch.kernels.ring_drain import ref as DR  # noqa: E402
from repro_torch.netsim import scenarios  # noqa: E402
from repro_torch.netsim import state as tstate  # noqa: E402

pytestmark = pytest.mark.gpu

# main-path shapes: perm_1024n_3t and alltoall_3t
NF, NSW, DMAX, NQ, CAP, W, MAXW = 1024, 176, 20, 2304, 40, 64, 2
N_A2A, FMAX_A2A = 512, 31
DRAIN_IN = ("rto", "started", "has_ack", "ack_seq", "lbits", "bitmap",
            "sent0", "sent1", "sent2")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(a, dev):
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _bit_equal(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("F,seed,react", [(1, 1, 1), (7, 2, 3), (1000, 3, 1),
                                          (NF, 4, 1)])
def test_cc_update_kernel_bit_equal(cuda, F, seed, react):
    p, s, ev, now = cases.cc_update_tensors(cases.cc_update_case(F, seed, react), cuda)
    for k, r in zip(CK.cc_update(p, s, ev, now), CR.cc_update_ref(p, s, ev, now)):
        assert _bit_equal(k, r)


@pytest.mark.parametrize("shape,seed", [((1, 1, 4, 3), 1), ((3, 5, 7, 4), 2),
                                        ((NSW, DMAX, NQ, CAP), 3)])
def test_enqueue_rank_kernel_bit_equal(cuda, shape, seed):
    S, D, nq, cap = shape
    c = cases.enqueue_rank_case(S, D, nq, cap, seed)
    args = [_on(c[n], cuda) for n in ("gdst", "ghead", "gsize")]
    for k, r in zip(EK.enqueue_rank(*args, cap=cap, nq=nq),
                    ER.enqueue_rank_ref(*args, cap=cap, nq=nq)):
        assert _bit_equal(k, r)


@pytest.mark.parametrize("shape,seed", [((1, 1), 1), ((5, 33), 2), ((7, 64), 3),
                                        ((N_A2A, FMAX_A2A), 4)])
def test_rr_pick_kernel_bit_equal(cuda, shape, seed):
    N, K = shape
    c = cases.rr_pick_case(N, K, seed)
    e, rr = _on(c["elig"], cuda), _on(c["rr"], cuda)
    for k, r in zip(EK.rr_pick(e, rr, kmax=K), ER.rr_pick_ref(e, rr, kmax=K)):
        assert _bit_equal(k, r)


@pytest.mark.parametrize("shape,seed", [((3, 32, 1), 1), ((2, 1024, 40), 2),
                                        ((NF, W, MAXW), 3)])
def test_ring_drain_kernel_bit_equal(cuda, shape, seed):
    F, w, maxw = shape
    c = cases.ring_drain_case(F, w, maxw, seed)
    a = {n: _on(c[n], cuda) for n in DRAIN_IN}
    # the loss words as the transport hands them: a row-strided view
    a["lbits"] = torch.cat([torch.zeros((F, 2), dtype=torch.int32, device=cuda),
                            a["lbits"]], dim=1)[:, 2:]
    args = [a[n] for n in DRAIN_IN]
    for k, r in zip(DK.ring_drain(c["t"], *args),
                    DR.ring_drain_ref(c["t"], *args, w=w, ww=w // 32, maxw=maxw)):
        assert _bit_equal(k, r)


def test_kernel_wrappers_refuse_bad_operands(cuda):
    c = cases.rr_pick_case(8, 4, 0)
    e, rr = _on(c["elig"], cuda), _on(c["rr"], cuda)
    with pytest.raises(TypeError, match="dtype"):
        EK.rr_pick(e.to(torch.int32), rr, kmax=4)
    with pytest.raises(ValueError, match="shape"):
        EK.rr_pick(e, rr[:4], kmax=4)
    with pytest.raises(ValueError, match="contiguous"):
        EK.rr_pick(e.t().contiguous().t(), rr, kmax=4)
    with pytest.raises(ValueError, match="on cpu"):
        EK.rr_pick(e, rr.cpu(), kmax=4)


@pytest.mark.parametrize("name", ["tiny_sparse", "perm_128n_3t"])
def test_scenario_through_kernels_equals_cpu(cuda, name):
    """A whole run through the kernels on the card ends in the CPU port's
    final state, bit for bit, with one launch of each tick kernel per
    executed tick (and rr_pick wherever senders hold several flows)."""
    sc = scenarios.scenario(name)
    sim = sc.build(device=cuda)
    fns = (CK.cc_update, EK.enqueue_rank, DK.ring_drain, EK.rr_pick)
    for fn in fns:
        fn.launches = 0
    st = sim.run(sc.max_ticks)
    torch.cuda.synchronize()
    steps = sim.stats["steps"]
    assert [fn.launches for fn in fns[:3]] == [steps] * 3
    assert (EK.rr_pick.launches > 0) == (sim.dims.FMAX > 1)
    cpu = sc.build(device="cpu")
    ref = cpu.run(sc.max_ticks)
    a, b = tstate.to_numpy(st), tstate.to_numpy(ref)

    def leaves(t, p=""):
        if hasattr(t, "_fields"):
            for n, v in zip(t._fields, t):
                yield from leaves(v, f"{p}.{n}" if p else n)
        else:
            yield p, t
    for (n, x), (_, y) in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), n
