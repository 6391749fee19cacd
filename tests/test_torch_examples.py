"""The port's example twins: ``examples/torch_quickstart.py --quick`` runs
to its end on the CPU (``--device cpu``) and prints the table of all four
algorithms; ``examples/torch_train_lm.py`` trains a small model on the CPU
and resumes from its checkpoint; ``examples/torch_serve_decode.py``
serves the reduced qwen3-0.6b (B = 4, a 24-token prompt, 16 new tokens)
on the CPU; without ``--device`` they, and
``examples/torch_collective_estimate.py``, ask for the card, so on a
machine without one they stop with the port's error instead of falling
back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(*args, script="torch_quickstart.py"):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_torch_quickstart_runs_on_the_cpu():
    out = _run("--quick", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    rows = [ln.split()[0] for ln in out.stdout.splitlines()[2:6]]
    assert rows == ["smartt", "swift", "mprdma", "eqds"]
    assert "incast8_16n" in out.stdout and "on cpu" in out.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is there")
def test_torch_quickstart_asks_for_the_card_by_default():
    out = _run("--quick")
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr


def test_torch_collective_estimate_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run succeeds")
    out = _run(script="torch_collective_estimate.py")
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr


def test_torch_train_lm_trains_and_resumes_on_the_cpu(tmp_path):
    small = ("--d-model", "64", "--layers", "2", "--seq", "32", "--batch", "8",
             "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu")
    out = _run("--steps", "20", *small, script="torch_train_lm.py")
    assert out.returncode == 0, out.stderr
    assert "on cpu" in out.stdout and "step    20 loss" in out.stdout
    first, last = out.stdout.split("done: loss ")[1].split(" over")[0].split(" -> ")
    assert float(last) < float(first)
    out = _run("--steps", "25", *small, script="torch_train_lm.py")
    assert out.returncode == 0, out.stderr
    assert "[resume] restored step 20" in out.stdout and "over 5 steps" in out.stdout


def test_torch_train_lm_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run succeeds")
    out = _run("--steps", "1", "--ckpt-dir", str(tmp_path / "ck"), script="torch_train_lm.py")
    assert out.returncode != 0
    assert "needs a CUDA card" in out.stderr


def test_torch_serve_decode_runs_on_the_cpu():
    out = _run("--device", "cpu", script="torch_serve_decode.py")
    assert out.returncode == 0, out.stderr
    assert "batch 4, prompt 24, 16 new tokens on cpu" in out.stdout
    ids = out.stdout.split("(first request): [")[1].split("]")[0].split(",")
    assert len(ids) == 16


def test_torch_serve_decode_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run succeeds")
    out = _run(script="torch_serve_decode.py")
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
