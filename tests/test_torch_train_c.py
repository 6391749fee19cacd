"""PyTorch port, the training path on the CPU, third part
(``tests/test_torch_train.py`` has the first and the tolerances):
jamba-1.5-large-398b's loss and gradients against the JAX package's, in
bf16 and with f32 weights; the training loop learning and resuming from
its checkpoint (``tests/test_system.py::test_train_learns_and_restarts``
mirrored), the resumed run's end equal to an uninterrupted run's bit for
bit; the entry points' devices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, train  # noqa: E402
from repro_torch.train.step import TrainConfig, init_state, make_train_step  # noqa: E402
from test_torch_train import (DEEP_GRAD_REL_L2, F32_GRAD_REL_L2,  # noqa: E402,F401
                              check_loss_and_grads, torch_one_thread)

DEEP = ("jamba-1.5-large-398b",)


@pytest.mark.parametrize("arch", DEEP)
def test_loss_and_grads_match_reference(arch, monkeypatch, torch_one_thread):
    check_loss_and_grads(arch, monkeypatch, DEEP_GRAD_REL_L2)


@pytest.mark.parametrize("arch", DEEP)
def test_deep_stack_grads_match_reference_in_f32(arch, monkeypatch, torch_one_thread):
    """The deep reduced stack's bf16 gradients are chaotic (see
    ``tests/test_torch_train.py``); with f32 weights on both sides the same
    gradients agree to ``F32_GRAD_REL_L2``."""
    check_loss_and_grads(arch, monkeypatch, F32_GRAD_REL_L2, f32=True)


# ------------------------------------------------------------------ the loop


def test_train_learns_and_restarts(tmp_path, torch_one_thread):
    """Loss falls; a second invocation resumes from the checkpoint, and its
    end equals an uninterrupted run's, parameters and optimizer state bit
    for bit."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, structure=16)
    tcfg = TrainConfig(adam=AdamWConfig(lr=2e-2, warmup_steps=5, total_steps=40),
                       microbatches=2)
    ckpt = str(tmp_path / "ck")
    quiet = dict(device="cpu", log=lambda *_: None)
    _, _, losses = train(cfg, tcfg, LoopConfig(steps=25, ckpt_dir=ckpt, ckpt_every=10,
                                               log_every=100), dcfg, **quiet)
    assert losses[-1] < losses[0] - 0.5
    model, opt, losses2 = train(cfg, tcfg, LoopConfig(steps=30, ckpt_dir=ckpt,
                                                      ckpt_every=10, log_every=100),
                                dcfg, **quiet)
    assert len(losses2) == 5           # resumed at 25, ran 5 more
    whole, wopt, wlosses = train(cfg, tcfg, LoopConfig(steps=30, log_every=100), dcfg,
                                 **quiet)
    assert wlosses[:25] == losses and wlosses[25:] == losses2
    for (n, a), b in zip(model.state_dict().items(), whole.state_dict().values()):
        assert torch.equal(a, b), n
    assert int(opt.step) == int(wopt.step) == 30
    for kind in ("mu", "nu"):
        for n, t in getattr(opt, kind).items():
            assert torch.equal(t, getattr(wopt, kind)[n]), (kind, n)


def test_loop_logs_as_the_reference():
    cfg = get_config("mamba2-780m", reduced=True)
    lines = []
    train(cfg, TrainConfig(adam=AdamWConfig(warmup_steps=1)),
          LoopConfig(steps=2, log_every=1),
          DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2), device="cpu",
          log=lines.append)
    assert [ln.split()[:2] for ln in lines] == [["step", "1"], ["step", "2"]]
    assert all(("loss" in ln and "gnorm" in ln and "lr" in ln and "tok/s" in ln)
               for ln in lines)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults succeed")
    cfg = get_config("qwen3-0.6b", reduced=True)
    tcfg = TrainConfig()
    for call in (lambda: lm.init_params(cfg), lambda: init_state(cfg, tcfg),
                 lambda: make_train_step(cfg, tcfg),
                 lambda: train(cfg, tcfg, LoopConfig(steps=1),
                               DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=1))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_train_step_refuses_a_model_elsewhere():
    cfg = get_config("qwen3-0.6b", reduced=True)
    model, opt = init_state(cfg, TrainConfig(), device="cpu")
    step = make_train_step(get_config("qwen2-0.5b", reduced=True), TrainConfig(),
                           device="cpu")
    with pytest.raises(ValueError, match="qwen3"):
        step(model, opt, {"tokens": np.zeros((1, 8), np.int32),
                          "labels": np.zeros((1, 8), np.int32)})
