"""PyTorch port, the sharding rules on the CPU against the JAX package's:
``repro_torch.launch.specs`` (parameters, batch, caches), AdamW's ZeRO-1
specs, ``launch.dryrun``'s analytic state bytes and ``configs.shapes``,
leaf for leaf, for all ten architectures at full width, with fsdp and
decode2d off and on, on the JAX tests' ``FakeMesh`` (2, 16, 16) and on a
(16, 16) one.  Neither side needs a device: the specs read a mesh's axis
names and sizes.

Comparison: the JAX package stacks each pattern position's leaves
``[G, ...]`` with a leading ``None`` in its specs; the port holds layer
``l = r * len(pattern) + i`` as ``layers.{l}``.  Each JAX spec, its leading
``None`` dropped, is compared with the port's spec of every repetition's
layer, both padded with ``None`` to the leaf's rank.  Specs and bytes are
exact: no tolerance.  Also here: the port's unsharded train step gives
bit-equal results with ``sh=None`` and with ``NOSHARD``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.sharding import Shardings as JShardings  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sharding import NOSHARD, P, Shardings  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402


def jax_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` as it was: the
    module asks for 512 host devices when imported, which this process
    (whose JAX may not have started yet) must not take up."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


class FakeMesh:
    """``tests/test_dryrun.py``'s mesh, with the ``devices`` array that the
    JAX package's ``per_device_bytes`` reads its sizes from."""

    def __init__(self, names, sizes):
        self.axis_names, self.axis_sizes = names, sizes
        self.devices = np.empty(sizes, dtype=object)


MESHES = {"2x16x16": FakeMesh(("pod", "data", "model"), (2, 16, 16)),
          "16x16": FakeMesh(("data", "model"), (16, 16))}


def norm(spec, rank: int) -> tuple:
    """A spec (JAX ``PartitionSpec`` or the port's ``P``) as a plain tuple
    padded with ``None`` to ``rank``."""
    t = tuple(spec)
    assert len(t) <= rank, (t, rank)
    return t + (None,) * (rank - len(t))


_CACHE = {}


def jparams(arch):
    """The JAX package's parameter shapes (``jax.eval_shape``), once an arch."""
    if arch not in _CACHE:
        cfg = jget_config(arch)
        _CACHE[arch] = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.key(0)))
    return _CACHE[arch]


def port_model(arch):
    key = ("port", arch)
    if key not in _CACHE:
        _CACHE[key] = tlm.LM(get_config(arch), device="meta")
    return _CACHE[key]


def unstack(cfg, jtree):
    """``{port name: (JAX leaf, JAX spec)}`` from a JAX params-shaped pair of
    trees (leaves, specs): each ``groups`` leaf once a repetition, its
    leading stack dim and ``None`` dropped."""
    leaves, specs = jtree
    npat = len(cfg.pattern)
    out = {}
    for i, (g, gs) in enumerate(zip(leaves["groups"], specs["groups"])):
        flat = jax.tree_util.tree_flatten_with_path(g)[0]
        flat_s = jax.tree_util.tree_flatten_with_path(
            gs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        for (path, leaf), (_, sp) in zip(flat, flat_s):
            name = ".".join(str(getattr(k, "key", k)) for k in path)
            assert tuple(sp)[:1] in ((), (None,)), (name, sp)
            for r in range(cfg.repeats):
                out[f"layers.{r * npat + i}.{name}"] = (leaf.shape[1:], tuple(sp)[1:])
    for name in ("embed", "final_norm", "lm_head"):
        if name in leaves:
            out[name] = (leaves[name].shape, tuple(specs[name]))
    return out


def assert_same_specs(cfg, jpairs, tspecs, tshapes_):
    assert set(jpairs) == set(tspecs)
    for name, (shape, jspec) in jpairs.items():
        assert tuple(tshapes_[name]) == tuple(shape), name
        rank = len(shape)
        assert norm(tspecs[name], rank) == norm(jspec, rank), (name, jspec, tspecs[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", tuple(MESHES))
def test_param_and_zero1_specs_match_reference(arch, mesh):
    cfg, jcfg = get_config(arch), jget_config(arch)
    fm = MESHES[mesh]
    jsh, sh = JShardings(fm), Shardings(fm)
    sds = jparams(arch)
    model = port_model(arch)
    shapes = TS.shapes_of(model)
    for fsdp in (False, True):
        for decode2d in (False, True):
            jspecs = JS.param_specs(jcfg, jsh, sds, fsdp=fsdp, decode2d=decode2d)
            tspecs = TS.param_specs(cfg, sh, model, fsdp=fsdp, decode2d=decode2d)
            assert_same_specs(cfg, unstack(cfg, (sds, jspecs)), tspecs, shapes)
            # ZeRO-1: the JAX package's rule on each un-stacked leaf (on its
            # [G, ...] stack the rule may take the stack dim itself; the
            # state bytes below hold both packages' totals equal)
            want = {n: (shp, jadamw.zero1_spec(JP(*sp), shp, jsh.batch_axes or ("data",),
                                                jsh.sizes))
                    for n, (shp, sp) in unstack(cfg, (sds, jspecs)).items()}
            jacfg = jadamw.AdamWConfig(master_weights=True)
            acfg = adamw.AdamWConfig(master_weights=True)
            jz = jadamw.zero1_state_specs(jacfg, jspecs, sds, jsh)
            tz = adamw.zero1_state_specs(acfg, tspecs, model, sh)
            assert tz.step == P() and tuple(jz.step) == ()
            for kind in ("mu", "nu", "master"):
                assert_same_specs(cfg, want, getattr(tz, kind), shapes)
                for name in ("embed", "final_norm", "lm_head"):
                    if name in sds:
                        rank = len(sds[name].shape)
                        assert norm(getattr(tz, kind)[name], rank) == norm(
                            getattr(jz, kind)[name], rank), (kind, name)
            assert adamw.zero1_state_specs(adamw.AdamWConfig(), tspecs, model, sh).master \
                is None


def test_zero1_spec_rules():
    """``tests/test_substrate.py``'s three cases, on both packages."""
    sizes = {"pod": 2, "data": 16, "model": 16}
    cases = (((None, "model"), (8192, 1024), (("pod", "data"), "model")),
             ((("pod", "data"), "model"), (8192, 1024), (("pod", "data"), "model")),
             ((None,), (7,), (None,)))
    for spec, shape, want in cases:
        got = adamw.zero1_spec(P(*spec), shape, ("pod", "data"), sizes)
        jgot = jadamw.zero1_spec(JP(*spec), shape, ("pod", "data"), sizes)
        assert tuple(got) == tuple(jgot) == want


def jcaches(jcfg, shape):
    return jshapes.input_specs(jcfg, shape)["caches"]


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", tuple(MESHES))
def test_batch_and_cache_specs_match_reference(arch, mesh):
    cfg, jcfg = get_config(arch), jget_config(arch)
    fm = MESHES[mesh]
    npat = len(cfg.pattern)
    for shape in tshapes.applicable_shapes(cfg):
        jshape = jshapes.SHAPES[shape.name]
        jcell = jshapes.input_specs(jcfg, jshape)
        cell = tshapes.input_specs(cfg, shape)
        jb = JS.batch_specs(jcfg, JShardings(fm), jcell["batch"])
        tb = TS.batch_specs(cfg, Shardings(fm), cell["batch"])
        assert set(jb) == set(tb)
        for k, t in cell["batch"].items():
            assert norm(tb[k], t.dim()) == norm(jb[k], t.dim()), (shape.name, k)
        if shape.kind != "decode":
            continue
        for dec in (False, True):
            jsh = JShardings(fm, decode_replicate=dec)
            sh = Shardings(fm, decode_replicate=dec)
            jc = JS.cache_specs(jcfg, jsh, jcell["caches"])
            tc = TS.cache_specs(cfg, sh, cell["caches"])
            assert len(tc) == cfg.n_layers
            for layer, specs in enumerate(tc):
                want = jc[layer % npat]
                assert set(specs) == set(want)
                for k, sp in specs.items():
                    rank = cell["caches"][layer][k].dim()
                    assert tuple(want[k])[:1] == (None,)
                    assert norm(sp, rank) == norm(tuple(want[k])[1:], rank), (
                        shape.name, layer, k, dec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """The same shapes and dtypes on both sides, caches layer by layer;
    ``synth_inputs`` realizes them (a reduced config, on the CPU)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    npat = len(cfg.pattern)
    dt = lambda d: str(d).split(".")[-1]  # noqa: E731
    for shape in tshapes.applicable_shapes(cfg):
        jcell = jshapes.input_specs(jcfg, jshapes.SHAPES[shape.name])
        cell = tshapes.input_specs(cfg, shape)
        assert set(jcell) == set(cell)
        for k, t in cell["batch"].items():
            j = jcell["batch"][k]
            assert tuple(t.shape) == tuple(j.shape) and dt(t.dtype) == dt(j.dtype), k
        if shape.kind == "decode":
            assert tuple(cell["cache_len"].shape) == tuple(jcell["cache_len"].shape)
            for layer, c in enumerate(cell["caches"]):
                want = jcell["caches"][layer % npat]
                for k, t in c.items():
                    assert tuple(t.shape) == tuple(want[k].shape)[1:], (layer, k)
                    assert dt(t.dtype) == dt(want[k].dtype), (layer, k)
        if shape.kind == "prefill":
            assert cell["max_len"] == jcell["max_len"]
    rcfg = get_config(arch, reduced=True)
    shape = tshapes.Shape("tiny", 8, 2, "decode")
    got = tshapes.synth_inputs(rcfg, shape, 0, device="cpu")
    want = tshapes.input_specs(rcfg, shape)
    for k, t in want["batch"].items():
        assert got["batch"][k].shape == t.shape and got["batch"][k].dtype == t.dtype
    assert int(got["cache_len"][0]) == 8


# The one cell where ZeRO-1 on the JAX package's [G, ...] stacks differs
# from ZeRO-1 on the port's layers: mamba2-780m's 48 repetitions divide the
# 16 data ranks, so the JAX rule shards every group leaf's moments over the
# stack (a rank holds whole layers' moments); a port layer's conv_x [4,
# 3072] (3072 over model), norm [3072] (over model) and A_log, Dskip,
# dt_bias [48] (over model) have no other dim the data axis divides, so
# their moments stay replicated over data: 7.3 KB a layer more a device.
STACKED_ZERO1 = {("mamba2-780m", "train_4k", "16x16"): 348840}


def layer_zero1_bytes(jcfg, sds, jspecs, jsh, fm, mdt, jd):
    """The JAX package's ZeRO-1 state bytes with its ``zero1_spec`` applied
    to each repetition's leaf (the port's layers) instead of the stack."""
    from jax.sharding import PartitionSpec
    item = jnp.dtype(mdt).itemsize
    total = 4                                           # the step count
    for name, (shape, sp) in unstack(jcfg, (sds, jspecs)).items():
        spec = jadamw.zero1_spec(PartitionSpec(*sp), shape, jsh.batch_axes or ("data",),
                                 jsh.sizes)
        leaf = jax.ShapeDtypeStruct(shape, mdt)
        total += 2 * jd.per_device_bytes({"x": leaf}, {"x": spec}, fm)
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_bytes_match_reference(arch):
    """``per_device_bytes`` of every (applicable shape x mesh) cell, each
    side from its own specs and shapes, with the dry run's knobs: equal,
    but for ``STACKED_ZERO1``, where the port's equals the JAX package's
    rule applied layer by layer and the JAX package's own total differs by
    the bytes pinned there."""
    jd = jax_dryrun()
    jcfg = jget_config(arch)
    run = TD.ARCH_RUN[arch]
    assert jd.ARCH_RUN[arch] == run
    sds = jparams(arch)
    for shape in tshapes.applicable_shapes(get_config(arch)):
        for mesh_name, fm in MESHES.items():
            jsh = JShardings(fm, seq_shard=run["sp"])
            jspecs = JS.param_specs(jcfg, jsh, sds, fsdp=run["fsdp"])
            want = layered = jd.per_device_bytes(sds, jspecs, fm)
            if shape.kind == "train":
                acfg = jadamw.AdamWConfig(moment_dtype=run["adam"])
                opt = jax.eval_shape(lambda: jadamw.init(acfg, sds))
                want += jd.per_device_bytes(
                    opt, jadamw.zero1_state_specs(acfg, jspecs, sds, jsh), fm)
                layered += layer_zero1_bytes(jcfg, sds, jspecs, jsh, fm, run["adam"], jd)
            elif shape.kind == "decode":
                caches = jcaches(jcfg, jshapes.SHAPES[shape.name])
                want += jd.per_device_bytes(caches, JS.cache_specs(jcfg, jsh, caches), fm)
                layered = want
            else:
                layered = want
            got = TD.state_bytes(arch, shape.name, fm)
            assert got == layered, (shape.name, mesh_name, got, layered)
            extra = STACKED_ZERO1.get((arch, shape.name, mesh_name), 0)
            assert got == want + extra, (shape.name, mesh_name, got, want)


def test_per_device_bytes_rules():
    """The port's ``per_device_bytes`` against the JAX package's on one
    hand-made tree: a tuple entry divides by every axis it names."""
    jd = jax_dryrun()
    fm = MESHES["2x16x16"]
    shapes = {"a": (64, 32), "b": (7,), "c": (32, 16, 4)}
    specs = {"a": (("pod", "data"), "model"), "b": (None,), "c": ("model",)}
    jt = {k: jax.ShapeDtypeStruct(s, jnp.bfloat16) for k, s in shapes.items()}
    tt = {k: torch.empty(s, dtype=torch.bfloat16, device="meta") for k, s in shapes.items()}
    want = jd.per_device_bytes(jt, {k: JP(*v) for k, v in specs.items()}, fm)
    got = TD.per_device_bytes(tt, {k: P(*v) for k, v in specs.items()}, fm)
    assert got == want == 64 * 32 * 2 // 512 + 14 + 32 * 16 * 4 * 2 // 16


@pytest.mark.parametrize("microbatches", [1, 2])
def test_unsharded_step_same_with_noshard(microbatches):
    """``sh=None`` and ``NOSHARD`` give the same step, bit for bit."""
    torch.set_num_threads(1)
    cfg = get_config("qwen3-0.6b", reduced=True)
    tcfg = tstep.TrainConfig(adam=adamw.AdamWConfig(lr=1e-3, warmup_steps=1),
                             microbatches=microbatches)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, 16), generator=g)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    out = []
    for sh in (None, NOSHARD):
        model = tlm.init_params(cfg, 0, device="cpu")
        opt = adamw.init(tcfg.adam, model)
        stats = tstep.make_train_step(cfg, tcfg, sh, device="cpu")(model, opt, batch)
        out.append((stats, model.state_dict(), opt))
    (s1, p1, o1), (s2, p2, o2) = out
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert all(torch.equal(o1.mu[k], o2.mu[k]) and torch.equal(o1.nu[k], o2.nu[k])
               for k in o1.mu)
