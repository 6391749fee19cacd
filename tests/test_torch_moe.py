"""PyTorch port, ``models/moe.py`` on the CPU against the JAX package's
``models/moe.py``: the one-hot einsum dispatch, the local-capacity form
and the sort-based dispatch, each with f32 and bf16 (``moe_bf16``)
one-hots, at the reduced dbrx-132b (4 experts, top-2) and mixtral-8x22b
configs, at their capacity factor and at 0.5 (tokens dropped), on the
same parameters (the JAX package's ``moe_init``) and the same bf16 input
made with numpy from a seed.

Tolerances and why:
- routing: equal wherever it is decided.  Both sides compute the router
  in f32 from the same bf16 input, so their probabilities differ by f32
  rounding only; a token whose k-th and (k+1)-th probabilities differ by
  more than ``ROUTE_MARGIN`` (1e-5) must be routed to the same experts,
  in the same order unless its first choices are as close.
- output and aux loss (``LAYER_REL_TOL``, max |Δ| / max |ref|): the expert
  products are bf16, and eager PyTorch rounds each bf16 product where
  XLA:CPU fuses; a few bf16 ULPs (2^-8 each), so 2e-2, as the other
  layers' tests.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import to_torch  # noqa: E402


@pytest.fixture(autouse=True)
def serving_without_autograd():
    """The layers run here as serving runs them, under ``torch.no_grad()``
    (the parameters are trainable: a result that requires grad has no
    ``.numpy()``)."""
    with torch.no_grad():
        yield


ROUTE_MARGIN = 1e-5
LAYER_REL_TOL = 2e-2

# (arch, dispatch, moe_bf16, capacity_factor, batch, sequence)
CASES = [(arch, how, bf16, cf, 2, 16)
         for arch in ("dbrx-132b", "mixtral-8x22b")
         for how in ("einsum", "local", "sorted")
         for bf16 in (False, True)
         for cf in (None, 0.5)]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _rel(want, got):
    want, got = _f32(want), _f32(got)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)), 1e-30))


def _configs(arch, how="einsum", bf16=False, cf=None):
    extra = dict(moe_bf16=bf16, moe_sorted=how == "sorted",
                 moe_local_chunks=2 if how == "local" else 0)
    if cf is not None:
        extra["capacity_factor"] = cf
    return (dataclasses.replace(get_config(arch, reduced=True), **extra),
            dataclasses.replace(jget_config(arch, reduced=True), **extra))


def _pair(cfg, jcfg, seed=0):
    """The JAX package's ``moe_init`` parameters and the port's ``MoE``
    holding them."""
    p = jmoe.moe_init(jax.random.key(seed), jcfg)
    mod = tmoe.MoE(cfg, "cpu")
    mod.load_state_dict({k: to_torch(np.asarray(v)) for k, v in p.items()}, strict=True)
    return p, mod


def _x(shape, seed=5):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _jax_route(p, cfg, x):
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    return np.asarray(probs), np.asarray(idx)


def _decided(probs, k):
    top = -np.sort(-probs, axis=-1)
    return top[..., k - 1] - top[..., k] > ROUTE_MARGIN, top


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_matches_reference(case):
    arch, how, bf16, cf, b, s = case
    cfg, jcfg = _configs(arch, how, bf16, cf)
    p, mod = _pair(cfg, jcfg)
    jx, x = _x((b, s, cfg.d_model))

    # routing, where it is decided
    jprobs, jidx = _jax_route(p, jcfg, jx)
    probs, gates, idx = tmoe.route(mod, cfg, x)
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=1e-5, atol=1e-6)
    decided, top = _decided(jprobs, cfg.top_k)
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1)[decided],
                                  np.sort(jidx, -1)[decided])
    ordered = decided & (top[..., 0] - top[..., 1] > ROUTE_MARGIN)
    np.testing.assert_array_equal(idx.numpy()[ordered], jidx[ordered])
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)

    want, jaux = jmoe.moe_apply(p, jcfg, jx)
    got, aux = tmoe.moe_apply(mod, cfg, x)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert _rel(want, got) < LAYER_REL_TOL
    assert abs(float(aux) - float(jaux)) <= LAYER_REL_TOL * abs(float(jaux))
    # a token that no expert kept has a zero output row, on both sides
    zero_w = ~np.asarray(jnp.any(want != 0, axis=-1))
    zero_g = ~got.ne(0).any(dim=-1).numpy()
    np.testing.assert_array_equal(zero_g, zero_w)
    if cf is not None:
        assert zero_w.any(), "capacity 0.5 drops whole tokens"
    else:
        assert not zero_w.any()


@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-1.5-large-398b"])
def test_decode_shape_takes_the_einsum_path(arch, monkeypatch):
    """S = 1 (decode) is no multiple of ``moe_local_chunks``: the local
    form falls back to the einsum dispatch with one slot an expert,
    as in the JAX package."""
    cfg, jcfg = _configs(arch, "local")
    p, mod = _pair(cfg, jcfg, seed=2)
    jx, x = _x((3, 1, cfg.d_model), seed=8)
    called = []
    orig = tmoe.moe_apply_local
    monkeypatch.setattr(tmoe, "moe_apply_local", lambda *a: called.append(1) or orig(*a))
    want, jaux = jmoe.moe_apply(p, jcfg, jx)
    got, aux = tmoe.moe_apply(mod, cfg, x)
    assert not called
    assert _rel(want, got) < LAYER_REL_TOL
    assert abs(float(aux) - float(jaux)) <= LAYER_REL_TOL * abs(float(jaux))


def test_sorted_dispatch_is_repeatable_and_sums_choices_in_order():
    """The sorted path sorts stably and sums a token's k contributions in
    a fixed order: two runs are bit-equal, and at a capacity that keeps
    every choice it equals the einsum dispatch (the JAX package's own
    equivalence at high capacity)."""
    cfg, jcfg = _configs("dbrx-132b", "sorted", cf=8.0)
    p, mod = _pair(cfg, jcfg, seed=3)
    _, x = _x((2, 16, cfg.d_model), seed=9)
    a, _ = tmoe.moe_apply(mod, cfg, x)
    b, _ = tmoe.moe_apply(mod, cfg, x)
    assert torch.equal(a, b)
    e, _ = tmoe.moe_apply(mod, dataclasses.replace(cfg, moe_sorted=False), x)
    assert _rel(e, a) < LAYER_REL_TOL


def test_moe_parameters_follow_the_reference_layout():
    """router [d, E] f32; gate/up [E, d, F], down [E, F, d] bf16; the seeded
    init's scales (0.02, d^-0.5, F^-0.5)."""
    cfg = dataclasses.replace(get_config("dbrx-132b", reduced=True), d_ff=512)
    mod = tmoe.MoE(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: jmoe.moe_init(jax.random.key(0), cfg))
    for name, t in mod.named_parameters():
        assert tuple(t.shape) == want[name].shape
        assert str(t.dtype).split(".")[-1] == want[name].dtype.name
    d, f = cfg.d_model, cfg.d_ff
    for name, scale in (("router", 0.02), ("gate", d ** -0.5), ("up", d ** -0.5),
                        ("down", f ** -0.5)):
        std = float(getattr(mod, name).float().std())
        assert abs(std / scale - 1) < 0.1, name
