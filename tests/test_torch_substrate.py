"""PyTorch port, the training substrate on the CPU against the JAX
package's: AdamW (``optim/adamw.py``), the synthetic data pipeline
(``data/pipeline.py``) and the checkpointer
(``checkpoint/checkpointer.py``), mirroring ``tests/test_substrate.py``.

Tolerances and why:
- AdamW ``update`` from the same numpy parameters, gradients and state
  (``convert.opt_state_from_jax``), without clipping: the new moments
  and every f32 parameter (f32 leaves, f32 masters) within ``ADAM_ULPS``
  = 2 units in the last place.  Both sides compute the same f32
  expressions with f32 scalars; ``pow`` may round its last bit otherwise
  and XLA may contract a product and a sum into one FMA.  An update is a
  sum (``base - lr * u``, ``b1 * m + (1 - b1) * g``), whose error is in
  units of its operands, not of a result that cancels, so the unit is
  the ULP of the largest of the old value, the new value and the change.
  A bf16 parameter or moment is an f32 result rounded once, so it may
  land one bf16 ULP away where that result sits at a rounding boundary
  (``BF16_ULPS`` = 1).
- The same with the clip on (the norm far above it): the global norm sums
  its squares in another order and is held within 2 ULPs; its last bit
  reaches every gradient through the clip scale and, where
  ``b1 * m + (1 - b1) * g`` cancels, grows to several ULPs of the
  result, so each f32 leaf's change (new - old) is held within
  ``CLIP_REL_L2`` = 1e-5 relative L2 (1 ULP is 6e-8); bf16 leaves within
  ``BF16_ULPS``.
- ``schedule`` within 2 ULPs over every step of a run; ``global_norm``
  within 2 ULPs.
- ``SyntheticLM``: equal bit for bit (numpy on both sides).
- The checkpointer: a round trip is exact, dtypes included.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ADAM_ULPS = 2
BF16_ULPS = 1
CLIP_REL_L2 = 1e-5


def ulps(want, got) -> int:
    """The largest distance in units in the last place between two float
    arrays of one dtype (f32 or bf16), through their ordered integer
    views."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    bits = {4: np.int32, 2: np.int16}[want.dtype.itemsize]
    def ordered(a):
        i = a.view(bits).astype(np.int64)
        return np.where(i < 0, np.iinfo(bits).min - i, i)
    return int(np.abs(ordered(want) - ordered(got)).max(initial=0))


def update_ulps(want, got, before) -> float:
    """The largest ``|want - got|`` of an f32 update, in units in the last
    place of the larger of the value before, the value after and the
    change (the operands of the update's last sum), element by element."""
    want, got, before = (np.asarray(a, np.float64) for a in (want, got, before))
    scale = np.maximum.reduce([np.abs(before), np.abs(want), np.abs(want - before)])
    return float((np.abs(want - got) / np.spacing(scale.astype(np.float32))).max(initial=0))


def np_of(t: torch.Tensor) -> np.ndarray:
    """A port tensor as numpy, bf16 as ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


# --------------------------------------------------------------------- AdamW


def _adam_pair(mdt, master, clip, arch="qwen3-0.6b"):
    """The JAX package's parameters and an AdamW state two updates in,
    the next gradients, and the port's copies of all three."""
    jcfg, cfg = jget_config(arch, reduced=True), get_config(arch, reduced=True)
    acfg = dict(lr=1e-2, warmup_steps=2, total_steps=8, moment_dtype=mdt,
                master_weights=master, grad_clip=clip)
    params = jlm.init_params(jcfg, jax.random.key(0))
    rng = np.random.default_rng(1)

    def grads():
        return jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 0.05), params)
    state = jadamw.init(jadamw.AdamWConfig(**acfg), params)
    for _ in range(2):
        params, state, _ = jadamw.update(jadamw.AdamWConfig(**acfg), state, params, grads())
    g = grads()
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    model = convert.from_jax_params(cfg, np_tree(params), device="cpu")
    tstate = convert.opt_state_from_jax(cfg, np_tree(state), device="cpu")
    tgrads = convert.state_dict_from_jax(cfg, np_tree(g))
    return (acfg, params, state, g), (cfg, model, tstate, tgrads)


def _update_both(mdt, master, clip):
    """One update on each side; returns (the reference's new values and
    the port's, by kind and name, the values before, the stats)."""
    (acfg, params, state, g), (cfg, model, tstate, tgrads) = _adam_pair(mdt, master, clip)
    before = {"param": {n: p.detach().clone() for n, p in model.named_parameters()},
              "mu": dict(tstate.mu), "nu": dict(tstate.nu), "master": dict(tstate.master or {})}
    p2, s2, stats = jadamw.update(jadamw.AdamWConfig(**acfg), state, params, g)
    tstats = adamw.update(adamw.AdamWConfig(**acfg), tstate, model, tgrads)
    assert int(tstate.step) == int(s2.step) == 3
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    want = {"param": convert.state_dict_from_jax(cfg, np_tree(p2)),
            "mu": convert.state_dict_from_jax(cfg, np_tree(s2.mu)),
            "nu": convert.state_dict_from_jax(cfg, np_tree(s2.nu))}
    got = {"param": dict(model.named_parameters()), "mu": tstate.mu, "nu": tstate.nu}
    if master:
        want["master"] = convert.state_dict_from_jax(cfg, np_tree(s2.master))
        got["master"] = tstate.master
    for kind in want:
        assert set(want[kind]) == set(got[kind]), kind
        for name, w in want[kind].items():
            assert got[kind][name].dtype == w.dtype, (kind, name)
    return want, got, before, (stats, tstats)


@pytest.mark.parametrize("mdt,master", [("float32", False), ("float32", True),
                                        ("bfloat16", False), ("bfloat16", True)])
def test_adamw_update_matches_reference(mdt, master):
    want, got, before, (stats, tstats) = _update_both(mdt, master, 0.0)
    for k in ("lr", "grad_norm"):
        assert ulps(np.asarray(stats[k]), np_of(tstats[k])) <= ADAM_ULPS, k
    for kind in want:
        for name, w in want[kind].items():
            t = got[kind][name]
            if t.dtype == torch.bfloat16:
                assert ulps(np_of(w), np_of(t)) <= BF16_ULPS, (kind, name)
            else:
                err = update_ulps(np_of(w), np_of(t), np_of(before[kind][name].float()))
                assert err <= ADAM_ULPS, (kind, name, err)


@pytest.mark.parametrize("mdt,master", [("float32", True), ("bfloat16", False)])
def test_adamw_clipped_update_matches_reference(mdt, master):
    want, got, before, (stats, tstats) = _update_both(mdt, master, 1.0)
    assert float(stats["grad_norm"]) > 2        # the clip scale is on the path
    for k in ("lr", "grad_norm"):
        assert ulps(np.asarray(stats[k]), np_of(tstats[k])) <= ADAM_ULPS, k
    for kind in want:
        for name, w in want[kind].items():
            t = got[kind][name]
            if t.dtype == torch.bfloat16:
                assert ulps(np_of(w), np_of(t)) <= BF16_ULPS, (kind, name)
                continue
            b = before[kind][name].double()
            dw, dt = w.double() - b, t.detach().double() - b
            err = float((dw - dt).norm() / dw.norm().clamp_min(1e-30))
            assert err <= CLIP_REL_L2, (kind, name, err)


def test_schedule_and_global_norm_match_reference():
    kw = dict(lr=3e-4, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    jc, tc = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for step in range(0, 60):
        want = np.asarray(jadamw.schedule(jc, jnp.asarray(step, jnp.int32)))
        got = np_of(adamw.schedule(tc, torch.tensor(step, dtype=torch.int32)))
        assert ulps(want, got) <= ADAM_ULPS, step
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((7, 5), (300,), (2, 3, 4))]
    leaves.append(rng.standard_normal(64).astype(jnp.bfloat16))
    want = np.asarray(jadamw.global_norm([jnp.asarray(x) for x in leaves]))
    got = adamw.global_norm([convert.to_torch(x) for x in leaves])
    assert ulps(want, np_of(got)) <= ADAM_ULPS


def test_adamw_optimizes_quadratic():
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=1,
                            total_steps=200, grad_clip=0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw.init(cfg, params)
    for _ in range(150):
        adamw.update(cfg, state, params, {"w": 2 * (params["w"] - target)})
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


def test_adamw_bf16_moments_close_to_f32():
    t = torch.from_numpy(np.random.default_rng(0).standard_normal(64).astype(np.float32))
    outs = {}
    for mdt in ("float32", "bfloat16"):
        cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, moment_dtype=mdt,
                                warmup_steps=1, grad_clip=0)
        params = {"w": torch.zeros(64)}
        state = adamw.init(cfg, params)
        assert state.mu["w"].dtype == getattr(torch, mdt)
        for _ in range(100):
            adamw.update(cfg, state, params, {"w": 2 * (params["w"] - t)})
        outs[mdt] = params["w"].numpy()
    assert np.max(np.abs(outs["float32"] - outs["bfloat16"])) < 0.15


def test_adamw_init_matches_reference_layout():
    jcfg, cfg = jget_config("mamba2-780m", reduced=True), get_config("mamba2-780m",
                                                                      reduced=True)
    acfg = dict(moment_dtype="bfloat16", master_weights=True)
    params = jlm.init_params(jcfg, jax.random.key(0))
    state = jadamw.init(jadamw.AdamWConfig(**acfg), params)
    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    tstate = adamw.init(adamw.AdamWConfig(**acfg), model)
    conv = convert.opt_state_from_jax(cfg, jax.tree.map(np.asarray, state), device="cpu")
    for kind in ("mu", "nu", "master"):
        a, b = getattr(tstate, kind), getattr(conv, kind)
        assert set(a) == set(b) == set(dict(model.named_parameters()))
        for n in a:
            assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), (kind, n)
    assert int(tstate.step) == 0 and tstate.step.dtype == torch.int32


# ---------------------------------------------------------------------- data


@pytest.mark.parametrize("kw", [dict(vocab=512, seq_len=32, global_batch=4, seed=7),
                                dict(vocab=50_000, seq_len=48, global_batch=6, seed=3,
                                     host_id=1, n_hosts=3, structure=16)])
def test_synthetic_lm_equals_reference(kw):
    a, b = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    for _ in range(4):
        x, y = next(a), next(b)
        assert set(x) == set(y) == {"tokens", "labels"}
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    assert a.state() == b.state() == {"step": 4}
    a2, b2 = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    a2.restore({"step": 2})
    b2.restore({"step": 2})
    for _ in range(2):
        np.testing.assert_array_equal(next(a2)["tokens"], next(b2)["tokens"])


def test_data_pipeline_deterministic_and_restartable():
    cfg = DataConfig(vocab=512, seq_len=32, global_batch=4, seed=7)
    a = SyntheticLM(cfg)
    b1 = next(a)
    b2 = next(a)
    c = SyntheticLM(cfg)
    c.restore({"step": 1})
    np.testing.assert_array_equal(next(c)["tokens"], b2["tokens"])
    d = SyntheticLM(DataConfig(vocab=512, seq_len=32, global_batch=4, seed=7,
                               host_id=1, n_hosts=2))
    assert not np.array_equal(next(d)["tokens"][:2], b1["tokens"][:2])
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    assert (b1["labels"][:, -1] == -1).all()


# ---------------------------------------------------------------- checkpoints


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16) * 1.5,
                  "d": torch.tensor(3, dtype=torch.int32),
                  "e": [torch.tensor([-1, 2**40], dtype=torch.int64), None]}}


def _flat(tree):
    return list(ckpt._leaves(tree))


def test_checkpoint_roundtrip_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    for step in (1, 2, 3, 4):
        ckpt.save(d, step, tree, extra={"data": {"step": step}}, keep=2)
    assert ckpt.all_steps(d) == [3, 4]
    step, restored, extra = ckpt.restore_latest(d, tree)
    assert step == 4 and extra == {"data": {"step": 4}}
    assert restored["b"]["e"][1] is None and list(restored) == list(tree)
    for x, y in zip(_flat(tree), _flat(restored)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)
    with open(os.path.join(d, "step_00000004", "meta.json")) as f:
        assert "bfloat16" in f.read()
    with np.load(os.path.join(d, "step_00000004", "arrays.npz")) as z:
        assert z["a1"].dtype == np.uint16          # "b.c": bf16 kept as its bits


def test_checkpoint_crash_atomicity(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.ones(3)})
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert ckpt.latest_step(d) == 1
    assert ckpt.restore_latest(str(tmp_path / "none"), {"a": torch.ones(3)}) == (None, None,
                                                                                 None)


def test_checkpoint_refuses_another_tree(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.ones(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(d, 1, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 1, {"a": torch.ones(4), "b": torch.zeros(2)})


def test_checkpoint_of_a_model_and_its_optimizer(tmp_path):
    """The loop's tree: the model's ``state_dict`` and its AdamW state
    (a named tuple, bf16 moments, f32 masters) come back equal, and the
    restored leaves take the template's dtype."""
    from repro_torch.models import lm
    cfg = get_config("mamba2-780m", reduced=True)
    model = lm.init_params(cfg, 3, device="cpu")
    opt = adamw.init(adamw.AdamWConfig(moment_dtype="bfloat16", master_weights=True), model)
    opt.step.fill_(5)
    for t in opt.mu.values():
        t.normal_()
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, (model.state_dict(), opt), extra={"data": {"step": 5}})
    fresh = lm.init_params(cfg, 4, device="cpu")
    (sd, opt2), extra = ckpt.restore(d, 5, (fresh.state_dict(), adamw.init(
        adamw.AdamWConfig(moment_dtype="bfloat16", master_weights=True), fresh)))
    assert isinstance(opt2, adamw.AdamWState) and int(opt2.step) == 5
    for a, b in zip(_flat((model.state_dict(), opt)), _flat((sd, opt2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    fresh.load_state_dict(sd)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), fresh.parameters()))
