"""PyTorch port, the dry run (``repro_torch.launch.dryrun``) on the CPU:
a reduced cell run on a fake 512-rank world under ``FakeTensorMode``,
its state bytes against the JAX package's ``per_device_bytes`` for the
same cell; the step counter on one sharded product; the pinned state
bytes of ``chip_smoke.py``'s phase-8 cells against both packages; the
parameter counts against the JAX package's config.  The JAX package's
own dry-run test compiles in a subprocess and fails in the reference
itself, so it is not this layer's oracle: the specs and bytes are.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.sharding import Shardings as JShardings  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.shapes import applicable_shapes  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_production_mesh  # noqa: E402
from repro_torch.sharding import P, Shardings  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_per_device_bytes():
    """``repro.launch.dryrun.per_device_bytes``, the module imported with
    ``XLA_FLAGS`` as it was (it asks for 512 host devices when imported)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod.per_device_bytes


class FakeMesh:
    def __init__(self, names, sizes):
        self.axis_names, self.axis_sizes = names, sizes
        self.devices = np.empty(sizes, dtype=object)


def jax_train_state_bytes(arch, fm, *, reduced):
    """The JAX package's ``state_bytes_per_device`` of a train cell."""
    per_device_bytes = jax_per_device_bytes()
    cfg = jget_config(arch, reduced=reduced)
    run = TD.ARCH_RUN[arch]
    sh = JShardings(fm, seq_shard=run["sp"])
    sds = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.key(0)))
    specs = JS.param_specs(cfg, sh, sds, fsdp=run["fsdp"])
    acfg = jadamw.AdamWConfig(moment_dtype=run["adam"])
    opt = jax.eval_shape(lambda: jadamw.init(acfg, sds))
    return (per_device_bytes(sds, specs, fm)
            + per_device_bytes(opt, jadamw.zero1_state_specs(acfg, specs, sds, sh), fm))


def test_run_cell_reduced_train_multi_pod():
    """The reduced qwen3-0.6b x train_4k on a fake 512-rank world runs; its
    state bytes equal the JAX package's for the cell."""
    res = TD.run_cell("qwen3-0.6b", "train_4k", multi_pod=True, reduced=True,
                      device="cpu", verbose=False)
    assert res["ok"] and res["mesh"] == "2x16x16" and res["kind"] == "train"
    want = jax_train_state_bytes("qwen3-0.6b", FakeMesh(("pod", "data", "model"),
                                                        (2, 16, 16)), reduced=True)
    assert res["state_bytes_per_device"] == want
    assert res["flops"] > 0 and res["bytes_accessed"] > 0
    coll = res["collectives"]
    assert set(coll) == set(TD.COLLECTIVES) | {"counts"}
    # the data-parallel gradient reductions and the TP all-reduces happen
    assert coll["counts"]["reduce-scatter"] > 0 and coll["counts"]["all-reduce"] > 0


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_run_cell_reduced_serving(shape):
    res = TD.run_cell("qwen3-0.6b", shape, reduced=True, device="cpu", verbose=False)
    assert res["ok"] and res["mesh"] == "16x16" and res["flops"] > 0
    assert res["state_bytes_per_device"] == TD.state_bytes(
        "qwen3-0.6b", shape, TD.PRODUCTION_MESHES[False], reduced=True)


# the reduced grid's heaviest archs (Mamba-2 layers: many small operations
# a layer), run by tests/test_torch_dryrun_b.py so that --dist loadfile
# spreads the grid over two workers
GRID_B = ("mamba2-780m", "jamba-1.5-large-398b")


def grid(archs):
    """(arch, shape) of every applicable shape of ``archs``' reduced configs."""
    return [(a, sh.name) for a in archs for sh in applicable_shapes(get_config(a, reduced=True))]


def check_cell(arch, shape):
    """``run_cell(reduced=True)`` of one cell on the 16x16 mesh runs its
    fake step (a train cell at one microbatch: the same operations a
    microbatch, fewer of them), and reports the specs' state bytes."""
    train = TD.SHAPES[shape].kind == "train"
    res = TD.run_cell(arch, shape, reduced=True, device="cpu", verbose=False,
                      run_overrides={"micro": 1} if train else None)
    assert res["ok"] and res["mesh"] == "16x16" and res["flops"] > 0
    assert res["state_bytes_per_device"] == TD.state_bytes(
        arch, shape, TD.PRODUCTION_MESHES[False], reduced=True)
    if train:       # the data-parallel gradient reductions happen
        assert res["collectives"]["counts"]["reduce-scatter"] > 0


@pytest.mark.parametrize("arch,shape", grid(a for a in ARCH_IDS if a not in GRID_B))
def test_run_cell_reduced_every_cell(arch, shape):
    """Every arch x applicable shape on 16x16 (the MoE routing and
    dispatch, sequence parallelism and MLA's decode on DTensor caches
    included), but ``GRID_B``'s (``tests/test_torch_dryrun_b.py``)."""
    check_cell(arch, shape)


def test_step_counter_counts_local_work():
    """One sharded product and one gather on a fake (16, 16) world: the
    FLOPs of the local product only (not DTensor's shape propagation on
    the global shapes), the gather's output bytes as one all-gather."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        sh = Shardings(mesh)
        with FakeTensorMode():
            x = sh.distribute(torch.empty(256, 64), P("data", None))
            w = sh.distribute(torch.empty(64, 128), P(None, "model"))
            with TD.StepCounter() as count:
                y = x @ w
                sh.constrain(y, P("data", None))
    assert count.flops == 2 * (256 // 16) * 64 * (128 // 16)
    assert count.counts["all-gather"] == 1
    assert count.coll["all-gather"] == (256 // 16) * 128 * 4
    assert sum(count.counts.values()) == 1


def jax_state_bytes(arch, shape_name, fm):
    """The JAX package's state bytes a device of a full-width cell: the
    parameters, plus the ZeRO-1 AdamW state of a train cell or the caches
    of a decode cell (``repro.launch.dryrun``'s ``state_bytes_per_device``)."""
    from repro.configs import shapes as jshapes
    if TD.SHAPES[shape_name].kind == "train":
        return jax_train_state_bytes(arch, fm, reduced=False)
    per_device_bytes = jax_per_device_bytes()
    cfg = jget_config(arch)
    sh = JShardings(fm, seq_shard=TD.ARCH_RUN[arch]["sp"])
    sds = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.key(0)))
    total = per_device_bytes(sds, JS.param_specs(cfg, sh, sds, fsdp=TD.ARCH_RUN[arch]["fsdp"]),
                             fm)
    if TD.SHAPES[shape_name].kind == "decode":
        caches = jshapes.input_specs(cfg, jshapes.SHAPES[shape_name])["caches"]
        total += per_device_bytes(caches, JS.cache_specs(cfg, sh, caches), fm)
    return total


def test_phase8_pinned_state_bytes():
    """``chip_smoke.DRYRUN_CELLS``' pinned state bytes: the port's analytic
    bytes, and the JAX package's for every cell (mamba2-780m on 16x16
    differs by ``tests/test_torch_sharding.py``'s STACKED_ZERO1: ZeRO-1 on
    the JAX package's layer stacks)."""
    cs = chip_smoke()
    stacked = {("mamba2-780m", "train_4k", "16x16"): 348840}
    assert len(cs.DRYRUN_CELLS) == 10
    for arch, shape, multi_pod, overrides, pinned in cs.DRYRUN_CELLS:
        mesh = TD.PRODUCTION_MESHES[multi_pod]
        assert TD.state_bytes(arch, shape, mesh, run_overrides=overrides) == pinned, (
            arch, shape, multi_pod)
        fm = FakeMesh(mesh.axis_names, mesh.axis_sizes)
        name = "2x16x16" if multi_pod else "16x16"
        assert pinned == jax_state_bytes(arch, shape, fm) + stacked.get(
            (arch, shape, name), 0), (arch, shape, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert TD.param_counts(cfg) == (jcfg.param_count(), jcfg.active_param_count())


def test_cli_writes_results(tmp_path):
    out = tmp_path / "cell.json"
    with pytest.raises(SystemExit) as stop:
        TD.main(["--arch", "mamba2-780m", "--shape", "train_4k", "--reduced",
                 "--device", "cpu", "--set", "micro=2", "--out", str(out)])
    assert stop.value.code == 0
    import json
    (res,) = json.loads(out.read_text())
    assert res["ok"] and res["arch"] == "mamba2-780m" and res["kind"] == "train"
