"""Neither JAX nor the JAX package in what a run loads: the module names'
top-level parts (before the first dot) compared whole, since the
program's name, ``repro_torch``, begins with the JAX package's."""

import subprocess
import sys

import pytest

from portbench_tiny import ROOT

pytest.importorskip("torch")

CODE = """
import sys, json
sys.path[:0] = [{root!r}, {root!r} + "/portbench/tests"]
import pathlib, portbench_tiny
from portbench import harness
bench, name, mixes = portbench_tiny.make_tiny(pathlib.Path({tmp!r}), "incast")
out = harness.run_cell(bench, name, 5, 0.1, False, device="cpu", mixes=mixes, ref_workers=0)
print(json.dumps(dict(correct=out["correct"], forbidden=harness.forbidden_modules(),
                      top=sorted({{m.split(".", 1)[0] for m in sys.modules}}))))
"""

# a run whose metric reader loads JAX: run.py's last step finds it once
# every reader has run, prints no result and exits 5
READER_CODE = """
import sys, json, shutil
sys.path[:0] = [{root!r}, {root!r} + "/portbench/tests"]
import pathlib, portbench_tiny
from portbench import harness, run
tmp = pathlib.Path({tmp!r})
bench, name, mixes = portbench_tiny.make_tiny(tmp, "incast")
metrics = tmp / "metrics"
shutil.copytree(harness.HERE / "metrics", metrics)
(metrics / "loads_jax.py").write_text(chr(10).join(["import jax", "def read(run):",
                                                    "    return 1.0", ""]))
bench["end_to_end"].append(dict(name="loads_jax", unit="s", better="lower", bound=0.25,
                                source="host_clock"))
out = harness.run_cell(bench, name, 5, 0.1, False, device="cpu", mixes=mixes, ref_workers=0,
                       metrics_dir=metrics)
assert "loads_jax" in out["metrics"]
sys.exit(run.finish(out))
"""


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    p = subprocess.run([sys.executable, "-c", CODE.format(root=str(ROOT), tmp=str(tmp_path))],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    import json

    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["correct"] is True and got["forbidden"] == []
    assert "repro_torch" in got["top"] and "portbench" in got["top"]
    assert not set(got["top"]) & {"jax", "jaxlib", "flax", "repro"}


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    pytest.importorskip("jax")
    p = subprocess.run([sys.executable, "-c",
                        READER_CODE.format(root=str(ROOT), tmp=str(tmp_path))],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 5, p.stderr[-3000:]
    assert p.stdout.strip() == ""
    assert "JAX or the JAX package was loaded" in p.stderr


def test_forbidden_names_compare_whole():
    from portbench import harness

    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    try:
        assert "repro_torch_lookalike_for_test" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike_for_test"]
