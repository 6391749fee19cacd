"""A whole run of the tiny cell on the CPU: the result line's keys, the
checks beside their limits, and the command's refusal without a card."""

import json
import subprocess
import sys

import pytest

from portbench_tiny import ROOT

pytest.importorskip("torch")


@pytest.mark.parametrize("kind", ["permutation", "alltoall"])
def test_result_line_has_the_five_keys_then_checks(run_tiny, kind):
    from portbench import harness

    out = run_tiny(kind)
    line = json.loads(harness.result_line(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 4
    assert set(line["metrics"]) == {"lanes_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["checks"]) == {"unfinished_lanes", "lanes_off", "fct_gap_ticks"}
    for c in line["checks"].values():
        assert c == {"value": 0, "limit": 0}
    text = harness.checks_text(line["checks"]).splitlines()
    assert text[0] == "check unfinished_lanes = 0 (limit 0)"


def test_command_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "perm1024.sweep256",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout == ""


def test_command_alone_without_the_program_fails(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "perm1024.sweep256",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.gpu
def test_command_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "alltoall1024.sweep256",
                        "--seed", "3", "--seconds", "2", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0 and "control_roofline" in line["metrics"]
