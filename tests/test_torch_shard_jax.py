"""PyTorch port, a lane batch over four shards held to the JAX package's
own sharded path.  A subprocess runs the reference's ``shard_map`` path
over four host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
as its CI's multidevice job does: the flag must be set before JAX starts,
so not in this process) and writes the final states to a ``.npz``; the
port runs the same study over ``["cpu"] * 4``.  Integers and booleans
are bit-exact, f32 leaves within the recorded 16-ULP budget of a run
(``RUN_ULP_BUDGET``)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.netsim import api, state  # noqa: E402
from test_torch_engine import RUN_ULP_BUDGET, _ulp, one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
POINTS = ({}, {"start_cwnd_mult": 0.5, "kmin_frac": 0.3})
SEEDS = (0, 1, 2)

REFERENCE = """
import sys
import jax
import numpy as np
from repro.netsim import api, shard
assert jax.device_count() == 4, jax.devices()
points = ({}, {"start_cwnd_mult": 0.5, "kmin_frac": 0.3})
st = api.study("tiny_incast3", points=points, seeds=(0, 1, 2))
out = st.run_states(mesh=shard.lane_mesh())
leaves = jax.tree.leaves(out)
np.savez(sys.argv[1], *[np.asarray(x) for x in leaves])
"""


def test_four_shards_match_the_reference_sharded_run(tmp_path):
    path = tmp_path / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as f:
        want = [f[f"arr_{i}"] for i in range(len(f.files))]
    plan = api.study("tiny_incast3", points=POINTS, seeds=SEEDS, device="cpu")
    got = state.tree_leaves(plan.run_states(mesh=["cpu"] * 4))
    assert plan.sim.stats["lanes"]["shard_ticks"][-1] == 0     # 6 lanes padded to 8
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        if a.dtype == np.float32:
            assert _ulp(a, b) <= RUN_ULP_BUDGET, i
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=str(i))
