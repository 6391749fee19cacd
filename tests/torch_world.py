"""The 4-process gloo rehearsals of the sharded-training layer
(``tests/test_torch_sharding_c.py``, ``_d.py``): a (data=2, model=2)
``DeviceMesh`` on the CPU, one ``torch.multiprocessing.spawn`` of 4
processes (a ``FileStore`` under the test's temporary directory, one
thread each, ``faulthandler`` on, so a crash prints each thread's stack)
that runs every case of its file after the parent has computed the JAX
package's references: the parent waits while the world runs, as
``tests/test_torch_sharding_b.py``'s does.

A train case is ``launch.dryrun.ARCH_RUN``'s fsdp and sequence
parallelism for its arch: the parameters placed by ``param_specs``, the
batch by ``batch_specs``, the AdamW state (two updates in) by
``zero1_state_specs``; the loss and every gradient, then one step of
``MICRO`` microbatches.  MoE routing is forced to the JAX package's
choice everywhere (``Forcing``): where the router decided a token the
choice is its own; where it did not (its k-th and (k+1)-th probabilities
within twice the two packages' router difference) the choice is the JAX
package's, as ``tests/test_torch_train.py``'s ``Routes.forcing`` does; a
token routed otherwise at a decided margin fails the test.

Not a test module: pytest collects nothing here, and the world's
processes import it without JAX.
"""

import faulthandler
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import ARCH_RUN
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.config import FFN_MOE
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

WORLD = 4
ADAM = dict(lr=1e-3, warmup_steps=1, total_steps=10, master_weights=True)
MICRO = 2
LOSS_REL_TOL = 2e-4
GRAD_REL_L2 = 5e-2
STEP_REL_L2 = 5e-2
LR_ULPS = 2


# ------------------------------------------------------------- in the world


def init_rank(rank, d):
    """This process as rank ``rank`` of the gloo world under ``d``; returns
    the (data=2, model=2) mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    faulthandler.enable(all_threads=True)
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                            world_size=WORLD)
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def moe_modules(model):
    return [layer.ffn for layer in model.layers if layer.spec.ffn == FFN_MOE]


class Forcing:
    """``moe.route`` with each MoE module's expert ids set to the JAX
    package's (``want[i]``, ``[B, S, K]`` for the i-th MoE module, with the
    JAX probabilities ``probs[i]``) on the rows of the global batch this
    call routes: ``rows`` (set by the patched ``loss_fn`` from the
    microbatch's tokens), the data rank's share of them when the call sees
    a batch shard.  Each call's tokens routed otherwise than the port's own
    choice are recorded with their JAX margin and the call's router
    difference (``flips``)."""

    def __init__(self, model, want, probs, tokens, coord=None):
        self.by_module = {m: i for i, m in enumerate(moe_modules(model))}
        self.want, self.probs, self.tokens, self.coord = want, probs, tokens, coord
        self.rows = np.arange(tokens.shape[0])
        self.flips = []

    def __enter__(self):
        self.route, self.loss_fn = tmoe.route, tlm.loss_fn

        def route(p, cfg, x2):
            probs, _, own = self.route(p, cfg, x2)
            i = self.by_module[getattr(p, "module", p)]
            rows = self.rows
            if x2.shape[0] != len(rows):            # a data rank's batch shard
                n = x2.shape[0]
                rows = rows[self.coord * n:(self.coord + 1) * n]
            want = torch.from_numpy(self.want[i][rows]).to(own.dtype)
            jp = self.probs[i][rows]
            flip = (own.sort(-1).values != want.sort(-1).values).any(-1).numpy()
            top = -np.sort(-jp, axis=-1)
            k = own.shape[-1]
            self.flips.append((int(flip.sum()), float((top[..., k - 1] - top[..., k])[flip].max(
                initial=0.0)), float(np.abs(jp - probs.detach().numpy()).max())))
            gates = torch.gather(probs, -1, want)
            return probs, gates / gates.sum(dim=-1, keepdim=True), want

        def loss_fn(model, batch, *a, **kw):
            toks = full(batch["tokens"]).numpy()
            self.rows = np.array([int(np.flatnonzero((self.tokens == t).all(-1))[0])
                                  for t in toks])
            return self.loss_fn(model, batch, *a, **kw)
        tmoe.route, tlm.loss_fn = route, loss_fn
        return self

    def __exit__(self, *exc):
        tmoe.route, tlm.loss_fn = self.route, self.loss_fn


def train_case(d, mesh, arch):
    """One arch's loss, gradients and step on the mesh (the module's
    docstring); the full tensors of rank 0's results."""
    from repro_torch.launch import specs as TS
    from repro_torch.sharding import Shardings

    data = torch.load(os.path.join(d, f"{arch}.pt"), weights_only=False)
    run = ARCH_RUN[arch]
    cfg = get_config(arch, reduced=True)
    sh = Shardings(mesh, seq_shard=run["sp"])
    coord = mesh.get_coordinate()[0]

    def placed_model():
        model = tlm.LM(cfg, device="cpu")
        if data["f32"]:
            model = model.float()
        model.load_state_dict(data["params"])
        specs = TS.param_specs(cfg, sh, model, fsdp=run["fsdp"])
        return TS.distribute_model(model, sh, specs), specs

    def forcing(model):
        return Forcing(model, data["want"], data["probs"], data["batch"]["tokens"].numpy(),
                       coord)

    model, specs = placed_model()
    bspecs = TS.batch_specs(cfg, sh, data["batch"])
    batch = {k: sh.distribute(v, bspecs[k]) for k, v in data["batch"].items()}
    with forcing(model) as f:
        loss, met = tlm.loss_fn(model, batch, sh)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    out = dict(loss=full(loss).detach(), nll=full(met["nll"]).detach(),
               aux=full(met["aux"]).detach(),
               grads={n: full(g) for n, g in zip(names, grads)},
               placements={n: str(p.placements) for n, p in zip(names, params)},
               flips=f.flips)

    model, specs = placed_model()
    acfg = adamw.AdamWConfig(**ADAM)
    opt = TS.distribute_opt_state(data["opt"], sh,
                                  adamw.zero1_state_specs(acfg, specs, model, sh))
    tcfg = tstep.TrainConfig(adam=acfg, microbatches=MICRO)
    with forcing(model) as f:
        stats = tstep.make_train_step(cfg, tcfg, sh, device="cpu")(model, opt, data["batch"])
    out.update(stats={k: full(v) for k, v in stats.items()},
               master={n: full(t) for n, t in opt.master.items()},
               mu={n: full(t) for n, t in opt.mu.items()},
               mu_placements={n: str(t.placements) for n, t in opt.mu.items()},
               step=int(opt.step), step_flips=f.flips)
    return out


# ------------------------------------------------------------- the parent


def jax_side():
    """The JAX package's modules (the parent's only)."""
    import importlib.util
    import types
    from pathlib import Path

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    from repro.models import moe as jmoe
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep

    spec = importlib.util.spec_from_file_location(
        "jax_test_models", Path(__file__).resolve().parent / "test_models.py")
    test_models = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(test_models)
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget_config, lm=jlm,
                                 moe=jmoe, adamw=jadamw, step=jstep,
                                 make_batch=test_models.make_batch)


def adam_state_two_updates_in(J, params, acfg):
    rng = np.random.default_rng(1)
    state = J.adamw.init(acfg, params)
    for _ in range(2):
        g = J.jax.tree.map(lambda p: J.jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 0.05), params)
        params, state, _ = J.adamw.update(acfg, state, params, g)
    return params, state


def train_reference(J, arch, *, f32=False, b=4):
    """The JAX package's weights (f32 under ``f32``), AdamW state and
    batch for one reduced arch, its loss and gradients, the MoE routes of
    its forward (a route is a function of its own batch row: the
    microbatches route their rows alike), and the port's copies."""
    jax, jnp = J.jax, J.jnp
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    cfg, jcfg = get_config(arch, reduced=True), J.get_config(arch, reduced=True)
    params = J.lm.init_params(jcfg, jax.random.key(0))
    if f32:
        params = jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                              else x, params)
    params, state = adam_state_two_updates_in(J, params, J.adamw.AdamWConfig(**ADAM))
    jb = J.make_batch(jcfg, b=b)
    routes = []
    orig = J.moe.moe_apply

    def recorded(p, c, x, sh=None):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        _, idx = jax.lax.top_k(probs, c.top_k)
        jax.debug.callback(lambda a, i: routes.append((np.asarray(a), np.asarray(i))),
                           probs, idx, ordered=True)
        return orig(p, c, x, sh)
    J.moe.moe_apply = recorded
    try:
        (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
            lambda p: J.lm.loss_fn(p, jcfg, jb), has_aux=True))(params)
    finally:
        J.moe.moe_apply = orig
    n_moe = sum(sp.ffn == FFN_MOE for sp in cfg.pattern) * cfg.repeats
    routes = routes[:n_moe]
    return dict(
        cfg=cfg, jcfg=jcfg, jax=(params, state, jb), f32=f32, loss=float(jloss),
        nll=float(jmet["nll"]), aux=float(jmet["aux"]),
        grads=convert.state_dict_from_jax(cfg, np_tree(jgrads)),
        want=[i for _, i in routes], probs=[p for p, _ in routes],
        batch={k: convert.to_torch(np.asarray(v)) for k, v in jb.items()},
        params=convert.state_dict_from_jax(cfg, np_tree(params)),
        opt=convert.opt_state_from_jax(cfg, np_tree(state), device="cpu"))


def step_reference(J, ref):
    """``train_reference``'s dict with the JAX package's train step of
    ``MICRO`` microbatches (the MoE load-balance loss is a function of a
    microbatch's means, so one microbatch would take another gradient)."""
    jax = J.jax
    params, state, jb = ref["jax"]
    jt = J.step.TrainConfig(adam=J.adamw.AdamWConfig(**ADAM), microbatches=MICRO)
    _, s2, jstats = jax.jit(J.step.make_train_step(ref["jcfg"], jt))(params, state, jb)
    ref.update(stats={k: np.asarray(v) for k, v in jstats.items()},
               master=convert.state_dict_from_jax(ref["cfg"], jax.tree.map(np.asarray,
                                                                        s2.master)),
               mu=convert.state_dict_from_jax(ref["cfg"], jax.tree.map(np.asarray, s2.mu)))
    return ref


def save_case(d, arch, ref):
    torch.save({k: ref[k] for k in ("params", "opt", "batch", "want", "probs", "f32")},
               os.path.join(d, f"{arch}.pt"))


# ------------------------------------------------------------- comparisons


def rel(want, got) -> float:
    want, got = float(want), float(got)
    return abs(want - got) / max(abs(want), 1e-30)


def rel_l2(want, got) -> float:
    want = torch.as_tensor(np.asarray(want) if not isinstance(want, torch.Tensor) else want)
    want, got = want.detach().double(), got.detach().double()
    return float((want - got).norm() / want.norm().clamp_min(1e-30))


def check_flips(flips):
    """Every token routed otherwise than the port's own choice was one
    the router did not decide: its JAX margin within twice the call's
    router difference."""
    for n, margin, noise in flips:
        assert n == 0 or margin <= 2 * noise, (n, margin, noise)


def check_loss_and_grads(ref, got):
    assert rel(ref["loss"], got["loss"]) < LOSS_REL_TOL
    assert rel(ref["nll"], got["nll"]) < LOSS_REL_TOL
    check_flips(got["flips"])
    assert set(got["grads"]) == set(ref["grads"])
    assert any("Shard" in p for p in got["placements"].values())
    worst = {}
    for name, w in ref["grads"].items():
        g = got["grads"][name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        worst[name] = rel_l2(w, g)
    assert max(worst.values()) < GRAD_REL_L2, max(worst.items(), key=lambda kv: kv[1])
    return worst


def check_step(ref, got):
    before = ref["opt"].master
    assert got["step"] == 3
    check_flips(got["step_flips"])
    assert set(got["stats"]) == {"lr", "grad_norm", "loss"}
    assert rel(ref["stats"]["loss"], got["stats"]["loss"]) < LOSS_REL_TOL
    assert rel(ref["stats"]["grad_norm"], got["stats"]["grad_norm"]) < GRAD_REL_L2
    lr_bits = (np.asarray(ref["stats"]["lr"], np.float32).view(np.int32),
               got["stats"]["lr"].numpy().view(np.int32))
    assert abs(int(lr_bits[0]) - int(lr_bits[1])) <= LR_ULPS
    assert any("Shard" in p.split(",")[0] for p in got["mu_placements"].values())
    for name, m in got["master"].items():
        change = m - before[name]
        assert rel_l2(ref["master"][name] - before[name], change) < STEP_REL_L2, name
        assert rel_l2(ref["mu"][name], got["mu"][name]) < STEP_REL_L2, name


def serve_case(d, mesh, arch, steps):
    """One arch's prefill and ``steps`` teacher-forced decode steps under
    ``ARCH_RUN``'s sequence parallelism, the caches placed by
    ``cache_specs`` after the prefill: the logits of the prefill and of
    each step (full tensors) and the caches at the end."""
    from repro_torch.launch import specs as TS
    from repro_torch.sharding import P, Shardings

    data = torch.load(os.path.join(d, f"serve-{arch}.pt"), weights_only=False)
    run = ARCH_RUN[arch]
    cfg = get_config(arch, reduced=True)
    sh = Shardings(mesh, seq_shard=run["sp"])
    model = tlm.LM(cfg, device="cpu")
    model.load_state_dict(data["params"])
    TS.distribute_model(model, sh, TS.param_specs(cfg, sh, model, fsdp=run["fsdp"]))
    prompt = data["prompt"]
    bspecs = TS.batch_specs(cfg, sh, {"tokens": prompt})
    logits, caches, cache_len = tlm.prefill(
        model, {"tokens": sh.distribute(prompt, bspecs["tokens"])}, data["max_len"], sh)
    caches = [{k: sh.constrain(v, spec[k]) for k, v in c.items()}
              for c, spec in zip(caches, TS.cache_specs(cfg, sh, caches))]
    cache_len = sh.distribute(cache_len, P(sh.batch_of(cache_len)))
    out = [full(logits)]
    for i in range(steps):
        cache_len = cache_len + 1
        tok = sh.distribute(data["feed"][:, i:i + 1], bspecs["tokens"])
        logits, caches = tlm.decode_step(model, {"tokens": tok}, caches, cache_len, sh)
        out.append(full(logits))
    return dict(logits=out, caches=[{k: full(v) for k, v in c.items()} for c in caches],
                placements=[{k: str(v.placements) for k, v in c.items()} for c in caches])


def serve_unsharded(d, arch, steps):
    """``serve_case`` on one process without a mesh (the port's decode,
    held to the JAX package's by ``tests/test_torch_mla.py``)."""
    data = torch.load(os.path.join(d, f"serve-{arch}.pt"), weights_only=False)
    model = tlm.LM(get_config(arch, reduced=True), device="cpu")
    model.load_state_dict(data["params"])
    logits, caches, cache_len = tlm.prefill(model, {"tokens": data["prompt"]},
                                            data["max_len"])
    out = [logits]
    for i in range(steps):
        cache_len = cache_len + 1
        logits, caches = tlm.decode_step(model, {"tokens": data["feed"][:, i:i + 1]},
                                         caches, cache_len)
        out.append(logits)
    return dict(logits=out, caches=caches)


def serve_inputs(J, arch, d, *, b, s, steps, seed=11):
    """The JAX package's seeded weights for ``arch``, a prompt ``[b, s]``
    and ``steps`` tokens to feed, saved for the world."""
    cfg, jcfg = get_config(arch, reduced=True), J.get_config(arch, reduced=True)
    params = J.jax.tree.map(np.asarray, J.lm.init_params(jcfg, J.jax.random.key(0)))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + steps)).astype(np.int32))
    torch.save(dict(params=convert.state_dict_from_jax(cfg, params), prompt=toks[:, :s],
                    feed=toks[:, s:], max_len=s + steps + 1),
               os.path.join(d, f"serve-{arch}.pt"))


def check_moe(ref, res):
    """The aux loss within ``tests/test_torch_train.py``'s 1e-3, and the
    experts split over the model axis: by expert under expert parallelism,
    else by d_ff."""
    assert rel(ref["aux"], res["aux"]) < 1e-3
    want = "Shard(dim=0)" if ref["cfg"].moe_ep else "Shard(dim=2)"
    experts = [p for n, p in res["placements"].items()
               if n.endswith("ffn.gate") and ref["grads"][n].dim() == 3]
    assert experts and all(p.split(", ")[-1].startswith(want) for p in experts), experts


MOE_FORMS = {"einsum": {}, "local": {"moe_local_chunks": 4}, "sorted": {"moe_sorted": True}}


def moe_forms_case(d, mesh, arch):
    """One MoE layer of ``arch`` in each dispatch form (``MOE_FORMS``) on
    the mesh: the parameters placed by ``param_specs`` (``ARCH_RUN``'s
    fsdp), x ``[B, S, d]`` split over the batch and, under sequence
    parallelism, the sequence; the output, the aux loss and the gradients
    of ``sum(y**2) + aux`` by x, the router and the expert weights (full
    tensors)."""
    import dataclasses

    from repro_torch.launch import specs as TS
    from repro_torch.sharding import P, Shardings

    data = torch.load(os.path.join(d, "moe_forms.pt"), weights_only=False)
    run = ARCH_RUN[arch]
    sh = Shardings(mesh, seq_shard=run["sp"])
    out = {}
    for form, over in MOE_FORMS.items():
        cfg = dataclasses.replace(get_config(arch, reduced=True), **over)
        layer = tmoe.MoE(cfg, "cpu")
        layer.load_state_dict(data["params"])
        names = {f"layers.0.ffn.{n}": n for n, _ in layer.named_parameters()}
        specs = TS.param_specs(cfg, sh, {k: getattr(layer, n) for k, n in names.items()},
                               fsdp=run["fsdp"])
        for k, n in names.items():
            layer.register_parameter(n, torch.nn.Parameter(sh.distribute(
                getattr(layer, n).detach(), specs[k])))
        x = sh.distribute(data["x"], P(sh.batch, sh.seq, None)).requires_grad_()
        y, aux = tmoe.moe_apply(layer, cfg, x, sh)
        leaves = (x, layer.router, layer.gate, layer.down)
        grads = torch.autograd.grad((y.float() ** 2).sum() + aux, leaves)
        out[form] = dict(y=full(y).detach(), aux=full(aux).detach(),
                         grads=[full(g) for g in grads])
    return out


def moe_forms_unsharded(d, arch):
    """``moe_forms_case`` on one process without a mesh."""
    import dataclasses

    data = torch.load(os.path.join(d, "moe_forms.pt"), weights_only=False)
    out = {}
    for form, over in MOE_FORMS.items():
        cfg = dataclasses.replace(get_config(arch, reduced=True), **over)
        layer = tmoe.MoE(cfg, "cpu")
        layer.load_state_dict(data["params"])
        x = data["x"].clone().requires_grad_()
        y, aux = tmoe.moe_apply(layer, cfg, x)
        grads = torch.autograd.grad((y.float() ** 2).sum() + aux,
                                    (x, layer.router, layer.gate, layer.down))
        out[form] = dict(y=y.detach(), aux=aux.detach(), grads=list(grads))
    return out


def moe_forms_inputs(d, arch, *, b=4, s=32, seed=5):
    """A seeded MoE layer of ``arch``'s reduced config and x ``[b, s, d]``
    (bf16), saved for the world."""
    cfg = get_config(arch, reduced=True)
    g = torch.Generator().manual_seed(seed)
    layer = tmoe.MoE(cfg, "cpu", g)
    x = torch.randn((b, s, cfg.d_model), generator=g).to(torch.bfloat16)
    torch.save(dict(params=layer.state_dict(), x=x), os.path.join(d, "moe_forms.pt"))
