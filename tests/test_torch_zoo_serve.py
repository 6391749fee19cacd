"""PyTorch port, the model zoo's other eight architectures on the CPU:
the port's ``prefill`` (logits and caches, and every layer from the same
input) against the JAX package's ``lm.prefill`` and its layer body, and
the empty caches against ``lm.init_cache``, at the reduced configs (B=2,
S=16).  ``tests/test_torch_zoo_serve_b.py`` holds ``decode_step`` and the
teacher-forced ``generate``.  The weights are the JAX package's seeded
init, carried across by ``models/convert.py``; the port runs its plain
versions (the CPU has no kernels).  Inputs come from numpy with a seed:
tokens, frame embeddings (musicgen-large) and the cross feed
(llama-3.2-vision-90b).

Tolerances and why (those of ``tests/test_torch_serve.py``):
- every layer from the same input (``LAYER_REL_TOL``, max |Δ| / max |ref|):
  weights and activations are bf16, and eager PyTorch rounds each
  operation's bf16 result where XLA:CPU fuses an elementwise chain and
  rounds once: a few bf16 ULPs (2^-8 each), so 2e-2.
- logits and caches through the whole depth (``LOGITS_REL_TOL``,
  ``CACHE_REL_TOL``): the same 2e-2.  jamba-1.5-large-398b's reduced
  config has 8 layers, six of them Mamba-2 with their f32 state summed
  over the prompt, and its caches and decode logits drift up to ~2.6 %
  apart through the depth with no routing difference (each layer stays
  within 2e-2 from the same input); its whole depth is held to 5e-2
  (``DEEP_REL_TOL``, ``whole_depth_tol``), the bound the JAX package
  allows between its own two serving paths
  (``tests/test_models.py::test_decode_matches_forward``).
- MoE routing: a token's top-k is decided where its k-th minus (k+1)-th
  router probability exceeds the two runs' largest router difference
  twice over.  Every decided token is routed alike; an undecided one may
  be routed otherwise, and then its row is compared only before it (its
  output differs, and through attention and the SSM state so do the
  positions after it), as is a token whose expert's capacity an earlier
  flip in its row took.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import (FFN_MOE, FFN_NONE, MIXER_CROSS,  # noqa: E402
                                       MIXER_MAMBA)


@pytest.fixture(autouse=True)
def serving_without_autograd():
    """The layers run here as serving runs them, under ``torch.no_grad()``
    (the parameters are trainable: a result that requires grad has no
    ``.numpy()``)."""
    with torch.no_grad():
        yield


_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
CHIP_SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CHIP_SMOKE)

LAYER_REL_TOL = 2e-2
LOGITS_REL_TOL = 2e-2
CACHE_REL_TOL = 2e-2
DEEP_REL_TOL = 5e-2
DEEP = ("jamba-1.5-large-398b",)

ARCHS = ("qwen2-0.5b", "phi3-mini-3.8b", "minicpm3-4b", "musicgen-large",
         "llama-3.2-vision-90b", "dbrx-132b", "mixtral-8x22b", "jamba-1.5-large-398b")
B, S, NEW = 2, 16, 5
MAX_LEN = S + NEW + 1
POSITIONAL = ("k", "v", "ckv", "kr")      # caches with a row per position


def whole_depth_tol(arch, tol):
    """``tol`` through the whole depth, DEEP_REL_TOL for the 8-layer jamba."""
    return DEEP_REL_TOL if arch in DEEP else tol


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def rel(want, got):
    want, got = f32(want), f32(got)
    if not want.size:
        return 0.0
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)), 1e-30))


# ------------------------------------------------------ MoE routes, both sides


class Routes:
    """Every MoE routing decision of each package while recording: the JAX
    side through ``jax.debug.callback`` (it runs inside ``lax.scan``), the
    port's by wrapping ``moe.route``; each entry (probs ``[..., E]``,
    expert ids ``[..., K]``) in numpy."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        orig_j, orig_t = JMOE.moe_apply, tmoe.route

        def jax_moe(p, cfg, x, sh=None):
            probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
            _, idx = jax.lax.top_k(probs, cfg.top_k)
            jax.debug.callback(lambda a, b: self.jax.append((np.asarray(a), np.asarray(b))),
                               probs, idx, ordered=True)
            return orig_j(p, cfg, x, sh)

        def port_route(p, cfg, x2):
            out = orig_t(p, cfg, x2)
            self.port.append((out[0].numpy(), out[2].numpy()))
            return out
        monkeypatch.setattr(JMOE, "moe_apply", jax_moe)
        monkeypatch.setattr(tmoe, "route", port_route)

    def clear(self):
        self.jax.clear()
        self.port.clear()


def kept_experts(cfg, idx):
    """``[B, S, E]``: the experts that keep a token's choices under the
    einsum dispatch (``chip_smoke.kept_experts``, which the card's gates
    use)."""
    return CHIP_SMOKE.kept_experts(cfg, torch.from_numpy(np.array(idx))).numpy()


def flagged(routes, cfg, calls=None):
    """The tokens whose MoE output may differ, one ``[B, S]`` mask a call
    (``calls``: a slice of the recorded calls).  Asserts that every token
    routed otherwise was undecided (its JAX margin within twice the calls'
    router difference) and that a token kept in other experts has a flip
    at or before it in its row."""
    sel = calls if calls is not None else slice(None)
    jcalls, tcalls = routes.jax[sel], routes.port[sel]
    assert len(jcalls) == len(tcalls)
    out = []
    for (jp, ji), (tp, ti) in zip(jcalls, tcalls):
        k = ji.shape[-1]
        flip = (np.sort(ji, -1) != np.sort(ti, -1)).any(-1)
        top = -np.sort(-jp, axis=-1)
        margin = top[..., k - 1] - top[..., k]
        noise = float(np.abs(jp - tp).max())
        assert (margin[flip] <= 2 * noise).all(), (margin[flip], noise)
        kept = (kept_experts(cfg, ji) != kept_experts(cfg, ti)).any(-1) & ~flip
        assert not (kept & ~(np.cumsum(flip, axis=1) > 0)).any()
        out.append(flip | kept)
    return out


def first_flag(masks, b):
    """Per row, the first position flagged in any of ``masks`` (``[B, S]``
    each), or a large number."""
    first = np.full(b, 1 << 30)
    for m in masks:
        for r in range(b):
            hit = np.flatnonzero(m[r])
            if hit.size:
                first[r] = min(first[r], hit[0])
    return first


# ------------------------------------------------------------ the models


def configs(arch):
    return get_config(arch, reduced=True), jget_config(arch, reduced=True)


def inputs(cfg, b=B, s=S, seed=17):
    """(JAX batch, port batch) from numpy: tokens or frame embeddings, and
    the cross feed where the model has cross-attention layers."""
    rng = np.random.default_rng(seed)
    jb, tb = {}, {}
    if cfg.frontend == "tokens":
        tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        jb["tokens"], tb["tokens"] = jnp.asarray(tok), torch.from_numpy(tok)
    else:
        e = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        jb["embeds"], tb["embeds"] = jnp.asarray(e), torch.from_numpy(e)
    if any(sp.mixer == MIXER_CROSS for sp in cfg.pattern):
        c = rng.standard_normal((b, cfg.cross_kv_len, cfg.d_model)).astype(np.float32)
        jb["cross"] = jnp.asarray(c, jnp.bfloat16)
        tb["cross"] = torch.from_numpy(c).to(torch.bfloat16)
    return jb, tb


@pytest.fixture(scope="module")
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def pair(arch):
    """(cfg, jcfg, JAX params, the port's model holding them), made once."""
    if arch not in _PAIRS:
        cfg, jcfg = configs(arch)
        params = jlm.init_params(jcfg, jax.random.key(0))
        model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
        _PAIRS[arch] = (cfg, jcfg, params, model)
    return _PAIRS[arch]


def compare_caches(cfg, caches, jcaches, flags, tol):
    """Each layer's cache against the JAX package's (``[G, ...]`` stacks):
    a row's positional caches before its first flagged position, its
    end-of-prompt caches (SSM state, conv tails) only without a flag; the
    cross caches (the feed's k/v) whole."""
    first = first_flag(flags, caches[0][next(iter(caches[0]))].shape[0]) if flags \
        else None
    assert len(caches) == cfg.n_layers
    for l, cache in enumerate(caches):
        r, i = divmod(l, len(cfg.pattern))
        want = jcaches[i]
        assert set(cache) == set(want), l
        cross = cfg.pattern[i].mixer == MIXER_CROSS
        for name, got in cache.items():
            ref = f32(want[name][r])
            assert str(got.dtype).split(".")[-1] == want[name].dtype.name, name
            assert tuple(got.shape) == ref.shape, name
            g = f32(got)
            keep = np.ones(ref.shape[:2], bool)
            if first is not None and not cross:
                for row in range(ref.shape[0]):
                    keep[row, (first[row] if name in POSITIONAL else
                               ref.shape[1] if first[row] > S else 0):] = False
            err = np.max(np.abs(ref - g)[keep], initial=0.0) / max(np.max(np.abs(ref)), 1e-30)
            assert err < tol, (l, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(arch, monkeypatch, torch_one_thread):
    cfg, jcfg, params, model = pair(arch)
    routes = Routes(monkeypatch)
    jb, tb = inputs(cfg)
    jlogits, jcaches, jclen = jlm.prefill(params, jcfg, jb, max_len=MAX_LEN)
    logits, caches, clen = tlm.prefill(model, tb, MAX_LEN)
    assert tuple(logits.shape) == jlogits.shape and logits.dtype == torch.bfloat16
    np.testing.assert_array_equal(clen.numpy(), np.asarray(jclen))
    flags = flagged(routes, cfg) if cfg.n_experts else []
    rows = first_flag(flags, B) > S if flags else np.ones(B, bool)
    assert rows.any()
    assert rel(f32(jlogits)[rows], f32(logits)[rows]) < whole_depth_tol(arch, LOGITS_REL_TOL)
    compare_caches(cfg, caches, jcaches, flags, whole_depth_tol(arch, CACHE_REL_TOL))


def jax_prefill_layer(p, cfg, spec, x, positions, cross):
    """One layer of the JAX package's ``lm.prefill`` body (models/lm.py),
    from a residual stream ``x``: (x, the layer's cache)."""
    h = JL.rmsnorm(x, p["ln"], cfg.rms_eps)
    pad = MAX_LEN - x.shape[1]
    if spec.mixer == MIXER_MAMBA:
        mix, cache = JM.mamba_apply(p["mixer"], cfg, h, None, return_state=True)
    elif spec.mixer == MIXER_CROSS:
        mix = JA.attn_apply(p["mixer"], cfg, h, None, None, cross_feed=cross)
        _, k, v = JA.attn_qkv(p["mixer"], cfg, cross, cross, None, None)
        cache = {"k": k.astype(jnp.bfloat16), "v": v.astype(jnp.bfloat16)}
    elif cfg.mla is not None:
        mix = JMLA.mla_apply(p["mixer"], cfg, h, positions, None)
        ckv, kr = JMLA.mla_latents(p["mixer"], cfg, h, positions)
        cache = {"ckv": jnp.pad(ckv, ((0, 0), (0, pad), (0, 0))).astype(jnp.bfloat16),
                 "kr": jnp.pad(kr[:, :, 0, :], ((0, 0), (0, pad), (0, 0))).astype(jnp.bfloat16)}
    else:
        q, k, v = JA.attn_qkv(p["mixer"], cfg, h, h, positions, None)
        mix = JA.gqa(q, k, v, causal=True, window=cfg.sliding_window,
                     q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
        mix = mix.reshape(*x.shape[:-1], cfg.n_heads * cfg.head_dim_) @ p["mixer"]["wo"]
        cache = {"k": jnp.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0))).astype(jnp.bfloat16),
                 "v": jnp.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0))).astype(jnp.bfloat16)}
    x = x + mix
    if spec.ffn != FFN_NONE:
        h2 = JL.rmsnorm(x, p["ln2"], cfg.rms_eps)
        x = x + (JMOE.moe_apply(p["ffn"], cfg, h2, None)[0] if spec.ffn == FFN_MOE
                 else JL.swiglu(p["ffn"], h2, None))
    return x, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_every_layer_matches_reference_from_the_same_input(arch, monkeypatch,
                                                          torch_one_thread):
    """Each layer of the port from the JAX package's residual stream
    against the JAX layer body from the same stream: the output (a MoE
    layer's on the tokens routed alike) and the cache."""
    cfg, jcfg, params, model = pair(arch)
    routes = Routes(monkeypatch)
    jb, tb = inputs(cfg)
    jx = (params["embed"][jb["tokens"]] if "tokens" in jb
          else jb["embeds"].astype(jnp.bfloat16))
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    x, tpos, cross = tlm.prefill_inputs(model, tb)
    assert rel(jx, x) == 0.0
    for l, layer in enumerate(model.layers):
        r, i = divmod(l, len(cfg.pattern))
        p = jax.tree.map(lambda t: t[r], params["groups"][i])
        routes.clear()
        want, wcache = jax_prefill_layer(p, jcfg, cfg.pattern[i], jx,
                                         positions, jb.get("cross"))
        jax.effects_barrier()
        tx = torch.from_numpy(f32(jx).copy()).to(torch.bfloat16)
        got, cache = tlm.prefill_layer(model, layer, tx, tpos, MAX_LEN, cross)
        same = ~flagged(routes, cfg)[0] if routes.port else np.ones((B, S), bool)
        assert rel(f32(want)[same], f32(got)[same]) < LAYER_REL_TOL, l
        for name in wcache:
            assert rel(wcache[name], cache[name]) < LAYER_REL_TOL, (l, name)
        jx = want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    """Empty caches: one dict a layer with the reference's names, shapes
    (its ``[G, ...]`` stack split per layer) and dtypes, all zeros."""
    cfg, jcfg = configs(arch)
    want = jlm.init_cache(jcfg, 3, 20)
    got = tlm.init_cache(cfg, 3, 20, "cpu")
    assert len(got) == cfg.n_layers
    for l, cache in enumerate(got):
        ref = want[l % len(cfg.pattern)]
        assert set(cache) == set(ref)
        for name, t in cache.items():
            assert tuple(t.shape) == ref[name].shape[1:], name
            assert str(t.dtype).split(".")[-1] == ref[name].dtype.name, name
            assert not t.any()


def test_cross_model_needs_its_feed_and_embeddings_need_no_generate():
    """A model with cross-attention layers and no ``cross`` in the batch
    raises ``ValueError`` (the JAX package fails there too, with a
    ``TypeError``); ``generate`` keeps the JAX package's ``ValueError`` for
    the embeddings frontend; neither model has a token embedding it does
    not use."""
    from repro_torch.serve import engine
    cfg, _, _, model = pair("llama-3.2-vision-90b")
    _, tb = inputs(cfg)
    with pytest.raises(ValueError, match="cross"):
        tlm.prefill(model, {"tokens": tb["tokens"]}, MAX_LEN)
    with pytest.raises(ValueError, match="cross"):
        engine.generate(model, tb["tokens"], max_new=2, max_len=MAX_LEN)
    mcfg, _, _, music = pair("musicgen-large")
    assert not hasattr(music, "embed") and music.lm_head.shape == (64, mcfg.padded_vocab)
    with pytest.raises(ValueError, match="token frontend"):
        engine.generate(music, torch.zeros((1, 4), dtype=torch.int32), max_new=2, max_len=8)
    assert dataclasses.asdict(mcfg)["frontend"] == "embeddings"
