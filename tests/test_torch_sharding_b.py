"""PyTorch port, the sharded-training layer in a 4-process ``gloo`` world
on the CPU, against the JAX package:

- ``train/compression.py``'s ``compressed_psum_mean`` (through
  ``make_compressed_allreduce`` on a 4-rank data mesh), each rank passing
  its row of seeded ``[4, N]`` gradients and errors, against the JAX
  package's under ``jax.vmap(axis_name="data")`` on the same rows: the
  stage-1 codes and scales bit for bit; the mean and the new error bit for
  bit or, where the reduction sums in another order, within 2 ULPs and one
  int8 step of the block (each difference counted).  Also the JAX tests'
  bound checks (``tests/test_dryrun.py``, ``tests/test_substrate.py``).
- the train step of the reduced qwen3-0.6b and mamba2-780m on a (data=2,
  model=2) ``DeviceMesh``, with fsdp off and on: the parameters placed by
  ``launch.specs.param_specs`` (the JAX package's weights, carried across
  by ``convert``), the batch by ``batch_specs``, the AdamW state (two
  updates in, so Adam's normalized step is smooth) by
  ``zero1_state_specs``.  The loss and every gradient (``full_tensor()``)
  against ``jax.value_and_grad`` of the JAX package's loss and against the
  port's unsharded ones; then one step of 2 microbatches: the loss, the
  gradient norm, the learning rate, every parameter's change of its f32
  master weight and every new first moment against the JAX package's step
  (of one microbatch: the same gradient) and the port's unsharded step.  The budgets are
  ``tests/test_torch_train.py``'s: the loss 2e-4 relative, each gradient
  5e-2 relative L2, each step change and moment 5e-2 relative L2, the
  learning rate 2 f32 ULPs.

The world is one ``torch.multiprocessing.spawn`` of 4 processes (a
``FileStore`` under the test's temporary directory, one thread each,
``faulthandler`` on: a rank that crashes prints every thread's stack)
that runs every case, after the parent has computed the JAX package's and
the port's unsharded results: the parent waits while the world runs, so
the file's five processes never compete for the cores that the other
test workers leave (a rank of this world once died of SIGSEGV under the
whole suite's load, and no run reproduced it: ``CHANGES.md``).
"""

import importlib.util
import os
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import compression as C  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402


def jax_side():
    """The JAX package's modules, imported here and not at the top: the
    world's processes import this file to find their function and need no
    JAX."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw
    from repro.train import compression as jcomp
    from repro.train import step as jstep

    spec = importlib.util.spec_from_file_location(
        "jax_test_models", Path(__file__).resolve().parent / "test_models.py")
    test_models = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(test_models)
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget_config, lm=jlm,
                                 adamw=jadamw, comp=jcomp, step=jstep,
                                 make_batch=test_models.make_batch)


LOSS_REL_TOL = 2e-4
GRAD_REL_L2 = 5e-2
STEP_REL_L2 = 5e-2
LR_ULPS = 2
WORLD = 4
N = WORLD * C.BLOCK * 4
CASES = tuple((arch, fsdp) for arch in ("qwen3-0.6b", "mamba2-780m") for fsdp in (False, True))
ADAM = dict(lr=1e-3, warmup_steps=1, total_steps=10, master_weights=True)
MICRO = 2


# ------------------------------------------------------------- the world


def _case_file(d, arch):
    return os.path.join(d, f"{arch}.pt")


def _world(rank, d):
    """One rank: the compression rows, then every (arch, fsdp) case on the
    (2, 2) mesh; rank 0 writes the full tensors, every rank its own
    compression results."""
    import faulthandler

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import specs as TS
    from repro_torch.sharding import Shardings

    faulthandler.enable(all_threads=True)
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                            world_size=WORLD)
    try:
        rows = np.load(os.path.join(d, "rows.npz"))
        g, e = torch.from_numpy(rows["g"][rank]), torch.from_numpy(rows["e"][rank])
        q, s = C.quantize(g + e)
        allreduce, world = C.make_compressed_allreduce(
            init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",)), "data")
        assert world == WORLD
        out, err = allreduce(g, e)
        torch.save(dict(q=q, s=s, out=out, err=err), os.path.join(d, f"compress{rank}.pt"))

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        sh = Shardings(mesh)
        res = {}
        for arch, fsdp in CASES:
            data = torch.load(_case_file(d, arch), weights_only=False)
            cfg = get_config(arch, reduced=True)
            full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731

            def placed_model():
                model = tlm.LM(cfg, device="cpu")
                model.load_state_dict(data["params"])
                specs = TS.param_specs(cfg, sh, model, fsdp=fsdp)
                return TS.distribute_model(model, sh, specs), specs

            model, specs = placed_model()
            bspecs = TS.batch_specs(cfg, sh, data["batch"])
            batch = {k: sh.distribute(v, bspecs[k]) for k, v in data["batch"].items()}
            loss, met = tlm.loss_fn(model, batch, sh)
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params)
            out = dict(loss=full(loss).detach(), nll=full(met["nll"]).detach(),
                       grads={n: full(g) for n, g in zip(names, grads)},
                       placements={n: str(p.placements) for n, p in zip(names, params)})

            model, specs = placed_model()
            acfg = adamw.AdamWConfig(**ADAM)
            ospecs = adamw.zero1_state_specs(acfg, specs, model, sh)
            opt = TS.distribute_opt_state(data["opt"], sh, ospecs)
            tcfg = tstep.TrainConfig(adam=acfg, microbatches=MICRO)
            stats = tstep.make_train_step(cfg, tcfg, sh, device="cpu")(model, opt,
                                                                      data["batch"])
            out.update(stats={k: full(v) for k, v in stats.items()},
                       params={n: full(p).detach() for n, p in model.named_parameters()},
                       master={n: full(t) for n, t in opt.master.items()},
                       mu={n: full(t) for n, t in opt.mu.items()},
                       mu_placements={n: str(t.placements) for n, t in opt.mu.items()},
                       step=int(opt.step))
            res[(arch, fsdp)] = out
        if rank == 0:
            torch.save(res, os.path.join(d, "steps.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the references


def adam_state_two_updates_in(J, params, acfg):
    rng = np.random.default_rng(1)
    state = J.adamw.init(acfg, params)
    for _ in range(2):
        g = J.jax.tree.map(lambda p: J.jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 0.05), params)
        params, state, _ = J.adamw.update(acfg, state, params, g)
    return params, state


def inputs(J, arch):
    """The JAX package's weights, AdamW state (two updates in) and batch
    for one reduced arch, and the port's copies the world needs."""
    jax = J.jax
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    cfg, jcfg = get_config(arch, reduced=True), J.get_config(arch, reduced=True)
    params, state = adam_state_two_updates_in(
        J, J.lm.init_params(jcfg, jax.random.key(0)), J.adamw.AdamWConfig(**ADAM))
    jb = J.make_batch(jcfg, b=4)
    return dict(
        cfg=cfg, jcfg=jcfg, jax=(params, state, jb),
        batch={k: convert.to_torch(np.asarray(v)) for k, v in jb.items()},
        params=convert.state_dict_from_jax(cfg, np_tree(params)),
        opt=convert.opt_state_from_jax(cfg, np_tree(state), device="cpu"))


def reference(J, ref):
    """The JAX package's loss and gradients (jitted) and its step, added
    to ``inputs``' dict.  The step is ``make_train_step``'s with one
    microbatch (the f32 gradients into ``adamw.update``): every label of
    the batch counts, so the mean of the port's two microbatches is the
    same gradient."""
    jax = J.jax
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    params, state, jb = ref["jax"]
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: J.lm.loss_fn(p, jcfg, jb), has_aux=True))(params)
    f32 = jax.tree.map(lambda g: g.astype(J.jnp.float32), jgrads)
    _, s2, jstats = J.adamw.update(J.adamw.AdamWConfig(**ADAM), state, params, f32)
    jstats = dict(jstats, loss=jloss)
    ref.update(
        loss=float(jloss), nll=float(jmet["nll"]),
        grads=convert.state_dict_from_jax(cfg, np_tree(jgrads)),
        stats={k: np.asarray(v) for k, v in jstats.items()},
        master=convert.state_dict_from_jax(cfg, np_tree(s2.master)),
        mu=convert.state_dict_from_jax(cfg, np_tree(s2.mu)))
    return ref


def unsharded(ref):
    """The port's own loss, gradients and step on one process."""
    cfg = ref["cfg"]
    model = tlm.LM(cfg, device="cpu")
    model.load_state_dict(ref["params"])
    loss, met = tlm.loss_fn(model, ref["batch"])
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    model.load_state_dict(ref["params"])
    opt = adamw.AdamWState(ref["opt"].step.clone(),
                           *({k: v.clone() for k, v in t.items()}
                             for t in (ref["opt"].mu, ref["opt"].nu, ref["opt"].master)))
    tcfg = tstep.TrainConfig(adam=adamw.AdamWConfig(**ADAM), microbatches=MICRO)
    stats = tstep.make_train_step(cfg, tcfg, device="cpu")(model, opt, ref["batch"])
    return dict(loss=loss.detach(), grads=grads, stats=stats, master=opt.master, mu=opt.mu)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the world once: (the JAX references by arch, the port's
    unsharded results by arch, the world's step results by case, the
    compression rows and each rank's results)."""
    d = str(tmp_path_factory.mktemp("world"))
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    g = (rng.standard_normal((WORLD, N)) * rng.uniform(0.1, 3.0, (WORLD, 1))).astype(np.float32)
    e = (rng.standard_normal((WORLD, N)) * 1e-3).astype(np.float32)
    np.savez(os.path.join(d, "rows.npz"), g=g, e=e)
    J = jax_side()
    refs = {arch: inputs(J, arch) for arch in {a for a, _ in CASES}}
    ports = {}
    for arch, ref in refs.items():
        torch.save({k: ref[k] for k in ("params", "opt", "batch")}, _case_file(d, arch))
        reference(J, ref)
        ports[arch] = unsharded(ref)
    # the world runs alone: this process waits (module docstring)
    torch.multiprocessing.spawn(_world, args=(d,), nprocs=WORLD)
    comp = [torch.load(os.path.join(d, f"compress{r}.pt")) for r in range(WORLD)]
    steps = torch.load(os.path.join(d, "steps.pt"), weights_only=False)
    return refs, ports, steps, (g, e), comp


# ------------------------------------------------------------- comparisons


def rel(want, got) -> float:
    want, got = float(want), float(got)
    return abs(want - got) / max(abs(want), 1e-30)


def rel_l2(want, got) -> float:
    want = torch.as_tensor(np.asarray(want) if not isinstance(want, torch.Tensor) else want)
    want, got = want.detach().double(), got.detach().double()
    return float((want - got).norm() / want.norm().clamp_min(1e-30))


def ulps_f32(a, b) -> np.ndarray:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def test_compression_matches_reference(world):
    _, _, _, (g, e), comp = world
    J = jax_side()
    jax, jnp, jcomp = J.jax, J.jnp, J.comp
    G, E = jnp.asarray(g), jnp.asarray(e)
    jq, js = jax.vmap(jcomp.quantize)(G + E)
    jout, jerr = jax.vmap(lambda a, b: jcomp.compressed_psum_mean(a, b, "data", WORLD),
                          axis_name="data")(G, E)
    jq, js, jout, jerr = map(np.asarray, (jq, js, jout, jerr))
    steps = np.repeat(np.asarray(jax.vmap(jcomp.quantize)(
        jnp.asarray(jout[0]).reshape(1, -1))[1]).reshape(-1), C.BLOCK)
    differ = {"out": 0, "err": 0}
    for r, res in enumerate(comp):
        assert np.array_equal(res["q"].numpy(), jq[r]), r
        assert np.array_equal(res["s"].numpy().view(np.int32), js[r].view(np.int32)), r
        for name, want in (("out", jout[r]), ("err", jerr[r])):
            got = res[name].numpy()
            off = got.view(np.int32) != want.view(np.int32)
            differ[name] += int(off.sum())
            close = (ulps_f32(got, want) <= 2) | (np.abs(got - want) <= 1.001 * steps)
            assert close.all(), (r, name, np.abs(got - want)[~close][:4])
    # the differences stay rare: the reductions sum four rows
    assert differ["out"] <= N // 100 and differ["err"] <= N // 100, differ
    # every rank holds the same mean
    for res in comp[1:]:
        assert torch.equal(res["out"], comp[0]["out"])


def test_compression_bounds(world):
    """``tests/test_dryrun.py``'s bounds, on this world's rows: the mean
    within 2% of the largest, the new error below max|g| / 64."""
    _, _, _, (g, e), comp = world
    want = (g + e).mean(0)
    got = comp[0]["out"].numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 0.02
    assert max(np.abs(r["err"].numpy()).max() for r in comp) < np.abs(g).max() / 64


def test_quantize_roundtrip_error_bound():
    """``tests/test_substrate.py``'s: per-block int8 error <= max|block| / 254."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(1024) * 5).astype(np.float32))
    q, s = C.quantize(x)
    err = (C.dequantize(q, s) - x).numpy()
    per_block = np.abs(x.numpy()).reshape(-1, C.BLOCK).max(1)
    bound = per_block / 254 + 1e-6
    assert np.all(np.abs(err).reshape(-1, C.BLOCK).max(1) <= bound)


@pytest.mark.parametrize("arch,fsdp", CASES)
def test_sharded_loss_and_grads(world, arch, fsdp):
    refs, ports, steps, _, _ = world
    ref, port, got = refs[arch], ports[arch], steps[(arch, fsdp)]
    assert rel(ref["loss"], got["loss"]) < LOSS_REL_TOL
    assert rel(ref["nll"], got["nll"]) < LOSS_REL_TOL
    assert rel(port["loss"], got["loss"]) < LOSS_REL_TOL
    assert set(got["grads"]) == set(ref["grads"])
    # the layer is sharded: some parameters live on the model axis, and
    # under fsdp some on the data axis too
    assert any("Shard" in p for p in got["placements"].values())
    for name, w in ref["grads"].items():
        g = got["grads"][name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert rel_l2(w, g) < GRAD_REL_L2, (name, rel_l2(w, g))
        assert rel_l2(port["grads"][name], g) < GRAD_REL_L2, name


@pytest.mark.parametrize("arch,fsdp", CASES)
def test_sharded_step_zero1(world, arch, fsdp):
    refs, ports, steps, _, _ = world
    ref, port, got = refs[arch], ports[arch], steps[(arch, fsdp)]
    before = ref["opt"].master
    assert got["step"] == 3
    assert set(got["stats"]) == set(ref["stats"]) == {"lr", "grad_norm", "loss"}
    assert rel(ref["stats"]["loss"], got["stats"]["loss"]) < LOSS_REL_TOL
    assert rel(ref["stats"]["grad_norm"], got["stats"]["grad_norm"]) < GRAD_REL_L2
    assert rel(port["stats"]["grad_norm"], got["stats"]["grad_norm"]) < GRAD_REL_L2
    lr_bits = (np.asarray(ref["stats"]["lr"], np.float32).view(np.int32),
               got["stats"]["lr"].numpy().view(np.int32))
    assert abs(int(lr_bits[0]) - int(lr_bits[1])) <= LR_ULPS
    # ZeRO-1: some moments are split over the data axis
    assert any("Shard" in p.split(",")[0] for p in got["mu_placements"].values())
    for name, p in got["params"].items():
        assert torch.equal(p, got["master"][name].to(p.dtype)), name
        change = got["master"][name] - before[name]
        assert rel_l2(ref["master"][name] - before[name], change) < STEP_REL_L2, name
        assert rel_l2(port["master"][name] - before[name], change) < STEP_REL_L2, name
        assert rel_l2(ref["mu"][name], got["mu"][name]) < STEP_REL_L2, name
        assert rel_l2(port["mu"][name], got["mu"][name]) < STEP_REL_L2, name
