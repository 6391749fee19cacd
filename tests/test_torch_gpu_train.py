"""PyTorch port on a CUDA card, training slice: the autograd Functions
of ``flash_attention`` and ``ssd_chunk_scan`` (the kernel's forward, a
plain PyTorch backward) against autograd through the plain versions, at
``chip_smoke.py``'s ``GRAD_FLASH_CASES`` and ``GRAD_SSD_CASES`` (the
same checks its phase 5c runs: causal, sliding window, cross-attention's
Sk > Sq, MLA's value head dim as a strided slice, B/C in group form,
bf16 and f32, a training microbatch at full width); remat's recompute
launching each kernel again and reproducing the forward bit for bit; the
sorted MoE dispatch's backward repeatable.

Tolerances (``chip_smoke.grad_tolerance``): the outputs as the kernels'
own checks (``FLASH_TOL``, ``SSD_TOL``); the gradients 1e-5 (f32) and
2e-2 (bf16) of the largest, since both sides' backward is the plain
version's and they differ by f32 summation order and one bf16 rounding.

Every test is marked ``gpu`` and skips without a card; this file imports
no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_train.py
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as FK  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402
from repro_torch.models import lm  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
CHIP_SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CHIP_SMOKE)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CHIP_SMOKE.GRAD_FLASH_CASES)
def test_flash_function_gradients_match_plain(case, cuda):
    errs, launches = CHIP_SMOKE.flash_grad_errors(case, cuda)
    assert launches == (1, 0)
    for name, e in errs.items():
        assert e <= CHIP_SMOKE.grad_tolerance(name, case[-1]), (name, e)


@pytest.mark.parametrize("case", CHIP_SMOKE.GRAD_SSD_CASES)
def test_ssd_function_gradients_match_plain(case, cuda):
    errs, launches = CHIP_SMOKE.ssd_grad_errors(case, cuda)
    assert launches == (1, 0)
    for name, e in errs.items():
        assert e <= CHIP_SMOKE.grad_tolerance(name, case[-1]), (name, e)


def _batch(cfg, dev, b=2, s=64):
    return CHIP_SMOKE.train_batch(cfg, dev, b, s)


@pytest.mark.parametrize("arch,counter", [("qwen3-0.6b", FK.flash_attention),
                                          ("mamba2-780m", SK.ssd_chunk_scan),
                                          ("jamba-1.5-large-398b", SK.ssd_chunk_scan)])
def test_remat_recompute_launches_again_and_equals_the_forward(arch, counter, cuda):
    """The loss and every gradient with remat equal the run without it bit
    for bit (the recompute reproduces the forward: the kernels add without
    atomics), and the recompute launches the kernel once more a layer."""
    cfg = get_config(arch, reduced=True)
    model = lm.init_params(cfg, 1, device=cuda)
    batch = _batch(cfg, cuda)
    out = {}
    for remat in (False, True):
        FK.reset_launches()
        SK.reset_launches()
        loss, _ = lm.loss_fn(model, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        out[remat] = (loss, grads, counter.launches)
    assert out[True][2] == 2 * out[False][2] > 0
    assert CHIP_SMOKE.bit_equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


def test_sorted_moe_backward_is_repeatable(cuda):
    """The sorted dispatch's indexed writes and gathers, forward and
    backward, twice on the same input: the gradients equal bit for bit."""
    cfg = dataclasses.replace(get_config("dbrx-132b", reduced=True), moe_sorted=True)
    model = lm.init_params(cfg, 2, device=cuda)
    batch = _batch(cfg, cuda)
    runs = []
    for _ in range(2):
        loss, _ = lm.loss_fn(model, batch)
        runs.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
