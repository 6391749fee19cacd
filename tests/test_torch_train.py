"""PyTorch port, the training path on the CPU against the JAX package's:
``lm.loss_fn`` and its gradients for five of the ten architectures
(``tests/test_torch_train_b.py`` has the other five, the loop and the
kernels' backward), and one ``make_train_step`` of each package with one
and two microbatches.  Reduced configs; the weights are the JAX package's
seeded init carried across by ``models/convert.py``; the batch is
``tests/test_models.py``'s ``make_batch`` (B=2, S=32).  The port runs its
plain versions, as the CPU has no kernels, with remat on, as the JAX
package's ``loss_fn`` by default.

Tolerances and why:
- the loss (``LOSS_REL_TOL`` = 2e-4 relative) and the MoE aux loss
  (``AUX_REL_TOL`` = 1e-3): weights and activations are bf16 and eager
  PyTorch rounds each operation's result where XLA:CPU fuses a chain and
  rounds once; through the depth the loss moves a few 1e-5.
- each parameter's gradient (``GRAD_REL_L2`` = 5e-2 relative L2 error):
  the gradients are bf16 and go back through the same bf16 roundings;
  the worst leaves (a bias, a norm scale: short vectors summed over every
  token) reach ~3e-2.  jamba-1.5-large-398b's reduced config is 8 layers,
  six of them Mamba-2, and its bf16 gradients are chaotic: the JAX
  package's own two lowerings of the same function (scan and unrolled)
  differ by up to 0.47 on a leaf (median 0.11); the port's differ from
  the scan's by up to 0.22 (median 0.05) with every route the same.  Its
  bf16 leaves are held to ``DEEP_GRAD_REL_L2`` = 0.3, and the same
  gradients with f32 weights (``tests/test_torch_train_b.py``) to
  ``F32_GRAD_REL_L2`` = 1e-3 (the port's worst leaf: 2e-5).
- MoE routing: the two packages' router probabilities differ by f32
  rounding, and a token whose k-th and (k+1)-th probabilities are within
  twice that difference (the router did not decide it) may be routed
  otherwise (``tests/test_torch_moe.py``, ``tests/test_torch_zoo_serve.py``).
  A flip anywhere changes every later position's activations and with
  them every gradient, so where a call has one, the test asserts that each
  flip is such an undecided token and runs the port again with that
  call's expert choices set to the JAX package's (``Routes.forcing``), the
  same function at tokens the router left open; a flip at a decided token
  fails.
- one train step from the same AdamW state two updates in (so Adam's
  normalized step is smooth in the gradient, not its sign): ``loss``,
  ``nll``, ``aux`` as above, ``grad_norm`` (``GRAD_REL_L2``) and ``lr``
  (2 f32 ULPs); each leaf's change of its f32 master weight and its new
  first moment within ``STEP_REL_L2`` = 5e-2 relative L2.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import FFN_MOE  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "jax_test_models", Path(__file__).resolve().parent / "test_models.py")
JAX_TEST_MODELS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JAX_TEST_MODELS)

LOSS_REL_TOL = 2e-4
AUX_REL_TOL = 1e-3
GRAD_REL_L2 = 5e-2
DEEP_GRAD_REL_L2 = 0.3
F32_GRAD_REL_L2 = 1e-3
STEP_REL_L2 = 5e-2
LR_ULPS = 2

ARCHS = ("qwen3-0.6b", "qwen2-0.5b", "phi3-mini-3.8b", "minicpm3-4b", "musicgen-large")


@pytest.fixture(scope="module")
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(want, got) -> float:
    want = torch.as_tensor(np.asarray(want, np.float64)) if not isinstance(
        want, torch.Tensor) else want.detach().double()
    got = got.detach().double() if isinstance(got, torch.Tensor) else torch.as_tensor(
        np.asarray(got, np.float64))
    return float((want - got).abs().max() / want.abs().max().clamp_min(1e-30))


def rel_l2(want: torch.Tensor, got: torch.Tensor) -> float:
    want, got = want.detach().double(), got.detach().double()
    return float((want - got).norm() / want.norm().clamp_min(1e-30))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def batches(jcfg, **kw):
    """(the JAX batch of ``test_models.make_batch``, the port's copy)."""
    jb = JAX_TEST_MODELS.make_batch(jcfg, **kw)
    return jb, {k: convert.to_torch(np.asarray(v)) for k, v in jb.items()}


def pair(arch, f32=False):
    """(cfg, jcfg, JAX params, the port's model holding them); ``f32``
    casts every bf16 weight to f32 on both sides."""
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    params = jlm.init_params(jcfg, jax.random.key(0))
    if not f32:
        return cfg, jcfg, params, convert.from_jax_params(cfg, np_tree(params), device="cpu")
    params = jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                          else x, params)
    model = tlm.LM(cfg, device="cpu").float()
    model.load_state_dict(convert.state_dict_from_jax(cfg, np_tree(params)), strict=True)
    return cfg, jcfg, params, model


class Routes:
    """The MoE routing of each package while a block runs: the JAX side's
    through ``jax.debug.callback`` (inside ``lax.scan``), the port's by
    wrapping ``moe.route`` (only while ``self.port_on``); each entry
    (probs, expert ids) in numpy.  ``forcing`` maps a port MoE module to
    the expert ids it must take (``[..., K]``): its gate values are then
    its own probabilities at those experts, renormalized."""

    def __init__(self, monkeypatch):
        self.jax, self.port, self.forcing, self.port_on = [], [], {}, True
        orig_j, orig_t = JMOE.moe_apply, tmoe.route

        def jax_moe(p, cfg, x, sh=None):
            probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
            _, idx = jax.lax.top_k(probs, cfg.top_k)
            jax.debug.callback(lambda a, b: self.jax.append((np.asarray(a), np.asarray(b))),
                               probs, idx, ordered=True)
            return orig_j(p, cfg, x, sh)

        def port_route(p, cfg, x2):
            probs, gate_vals, idx = orig_t(p, cfg, x2)
            if p in self.forcing:
                idx = self.forcing[p]
                gate_vals = torch.gather(probs, -1, idx)
                gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
            if self.port_on:
                self.port.append((probs.detach().numpy(), idx.numpy()))
            return probs, gate_vals, idx
        monkeypatch.setattr(JMOE, "moe_apply", jax_moe)
        monkeypatch.setattr(tmoe, "route", port_route)

    def flips(self, n):
        """Per call of the first ``n`` (the forward's), the tokens routed
        to another set of experts; asserts each was undecided (its JAX
        margin within twice the call's router difference)."""
        out = []
        for (jp, ji), (tp, ti) in zip(self.jax[:n], self.port[:n]):
            k = ji.shape[-1]
            flip = (np.sort(ji, -1) != np.sort(ti, -1)).any(-1)
            top = -np.sort(-jp, axis=-1)
            margin = top[..., k - 1] - top[..., k]
            noise = float(np.abs(jp - tp).max())
            assert (margin[flip] <= 2 * noise).all(), (margin[flip], noise)
            out.append(flip)
        return out


def moe_modules(model):
    return [layer.ffn for layer in model.layers if layer.spec.ffn == FFN_MOE]


def port_loss_and_grads(model, batch, routes=None, **kw):
    """The port's (loss, metrics, {name: gradient}) through ``loss_fn``
    and one backward; ``routes`` records the forward's routing only."""
    if routes is not None:
        routes.port.clear()
        routes.port_on = True
    loss, met = tlm.loss_fn(model, batch, **kw)
    if routes is not None:
        routes.port_on = False
    names, params = zip(*model.named_parameters())
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in met.items()}, dict(zip(names, gs))


def check_loss_and_grads(arch, monkeypatch, grad_tol=GRAD_REL_L2, f32=False):
    """The port's loss, nll, aux and every gradient leaf against
    ``jax.value_and_grad(lm.loss_fn)`` on the same weights and batch."""
    cfg, jcfg, params, model = pair(arch, f32)
    jb, tb = batches(jcfg)
    routes = Routes(monkeypatch)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, jb), has_aux=True)(params)
    loss, met, grads = port_loss_and_grads(model, tb, routes)
    mods = moe_modules(model)
    if mods:
        assert len(routes.port) == len(mods) and len(routes.jax) >= len(mods)
        flips = routes.flips(len(mods))
        forced = {m: torch.from_numpy(np.array(routes.jax[i][1])).long()
                  for i, (m, f) in enumerate(zip(mods, flips)) if f.any()}
        if forced:
            routes.forcing = forced
            loss, met, grads = port_loss_and_grads(model, tb, routes)
            assert not any(f.any() for f in routes.flips(len(mods)))
    assert rel(float(jloss), loss) < LOSS_REL_TOL
    assert rel(float(jmet["nll"]), met["nll"]) < LOSS_REL_TOL
    if cfg.n_experts:
        assert float(met["aux"]) > 0
        assert rel(float(jmet["aux"]), met["aux"]) < AUX_REL_TOL
    else:
        assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    want = convert.state_dict_from_jax(cfg, np_tree(jgrads))
    assert set(want) == set(grads)
    for name, w in want.items():
        g = grads[name]
        assert g is not None and g.dtype == w.dtype and g.shape == w.shape, name
        assert rel_l2(w, g) < grad_tol, (name, rel_l2(w, g))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch, torch_one_thread):
    check_loss_and_grads(arch, monkeypatch)


# ------------------------------------------------------------- the train step


def adam_state_two_updates_in(jcfg, params, acfg):
    """The JAX package's AdamW state (and parameters) after two updates with
    seeded random gradients."""
    rng = np.random.default_rng(1)
    state = jadamw.init(acfg, params)
    for _ in range(2):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 0.05), params)
        params, state, _ = jadamw.update(acfg, state, params, g)
    return params, state


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches, torch_one_thread):
    arch = "qwen3-0.6b"
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, master_weights=True)
    jt = jstep.TrainConfig(adam=jadamw.AdamWConfig(**kw), microbatches=microbatches)
    tt = tstep.TrainConfig(adam=adamw.AdamWConfig(**kw), microbatches=microbatches)
    params, state = adam_state_two_updates_in(
        jcfg, jlm.init_params(jcfg, jax.random.key(0)), jt.adam)
    model = convert.from_jax_params(cfg, np_tree(params), device="cpu")
    opt = convert.opt_state_from_jax(cfg, np_tree(state), device="cpu")
    before = {n: t.clone() for n, t in opt.master.items()}
    jb, tb = batches(jcfg, b=4)
    p2, s2, jstats = jstep.make_train_step(jcfg, jt)(params, state, jb)
    stats = tstep.make_train_step(cfg, tt, device="cpu")(model, opt, tb)
    keys = {"lr", "grad_norm", "loss"} | ({"nll", "aux"} if microbatches == 1 else set())
    assert set(stats) == set(jstats) == keys
    assert int(opt.step) == int(s2.step) == 3
    assert rel(float(jstats["loss"]), stats["loss"]) < LOSS_REL_TOL
    assert rel(float(jstats["grad_norm"]), stats["grad_norm"]) < GRAD_REL_L2
    lr_bits = np.asarray(jstats["lr"]).view(np.int32), np.asarray(stats["lr"]).view(np.int32)
    assert abs(int(lr_bits[0]) - int(lr_bits[1])) <= LR_ULPS
    masters = convert.state_dict_from_jax(cfg, np_tree(s2.master))
    mus = convert.state_dict_from_jax(cfg, np_tree(s2.mu))
    for name, p in model.named_parameters():
        assert torch.equal(p, opt.master[name].to(p.dtype)), name
        step = rel_l2(masters[name] - before[name], opt.master[name] - before[name])
        assert step < STEP_REL_L2, (name, step)
        assert rel_l2(mus[name], opt.mu[name]) < STEP_REL_L2, name
