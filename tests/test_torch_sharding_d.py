"""PyTorch port, the sharded-training layer's sequence parallelism and
MLA's decode on DTensor caches, in a 4-process gloo world on the CPU
(``tests/torch_world.py``), on the (data=2, model=2) mesh:

- reduced phi3-mini-3.8b trained with ``ARCH_RUN``'s sequence
  parallelism (the residual stream split over the model axis between the
  blocks, gathered whole into each mixer and FFN, ``Shardings.whole_seq``),
  and reduced dbrx-132b, a MoE arch with expert parallelism (the experts
  over the model axis), with its fsdp and sequence parallelism: the loss
  and every gradient against ``jax.value_and_grad`` of the JAX package's
  loss, then one step of 2 microbatches against the JAX package's step,
  within ``tests/test_torch_sharding_b.py``'s budgets (loss 2e-4
  relative, gradients, step changes and moments 5e-2 relative L2, the
  learning rate 2 f32 ULPs; MoE routes forced as
  ``tests/test_torch_sharding_c.py``'s);
- reduced minicpm3-4b (MLA, 5 heads: not divisible by the model axis)
  and reduced phi3-mini-3.8b (GQA) served under sequence parallelism:
  the prefill of a [4, 16] prompt, the caches placed by ``cache_specs``
  (MLA's latent, the k/v heads over the model axis), then 4
  teacher-forced decode steps, each writing its row into the DTensor
  caches in place on each rank's shard (``sharding.put_rows_``).  The
  logits of the prefill and of every step against the port's unsharded
  decode on one process (held to the JAX package's by
  ``tests/test_torch_mla.py``), within ``SERVE_REL_TOL`` = 2e-2 of the
  largest logit (max |difference| / max |reference|: bf16 activations
  whose products sum in another order over the shards), and the final
  caches within the same bound;
- one MoE layer of reduced dbrx-132b in each dispatch form (the one-hot
  einsum, the local-capacity form, the sorted form with its capacity
  global over the batch), x split over the batch and the sequence: the
  output, aux loss and gradients against the same layer on one process.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import torch_world as W  # noqa: E402

TRAIN = ("phi3-mini-3.8b", "dbrx-132b")
SERVE = ("minicpm3-4b", "phi3-mini-3.8b")
STEPS = 4
SERVE_REL_TOL = 2e-2
MOE_FORMS = "dbrx-132b"


def _world(rank, d):
    mesh = W.init_rank(rank, d)
    try:
        res = {arch: W.train_case(d, mesh, arch) for arch in TRAIN}
        res["serve"] = {arch: W.serve_case(d, mesh, arch, STEPS) for arch in SERVE}
        res["moe_forms"] = W.moe_forms_case(d, mesh, MOE_FORMS)
        if rank == 0:
            torch.save(res, os.path.join(d, "results.pt"))
    finally:
        W.dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the JAX references by train arch, the port's unsharded results by
    serve arch and for the MoE forms, the world's results)."""
    d = str(tmp_path_factory.mktemp("world"))
    torch.set_num_threads(1)
    J = W.jax_side()
    for arch in SERVE:
        W.serve_inputs(J, arch, d, b=4, s=16, steps=STEPS)
    W.moe_forms_inputs(d, MOE_FORMS)
    refs = {arch: W.train_reference(J, arch) for arch in TRAIN}
    for arch, ref in refs.items():
        W.save_case(d, arch, ref)
        W.step_reference(J, ref)
    with torch.no_grad():
        served = {"serve": {arch: W.serve_unsharded(d, arch, STEPS) for arch in SERVE}}
    served["moe_forms"] = W.moe_forms_unsharded(d, MOE_FORMS)
    torch.multiprocessing.spawn(_world, args=(d,), nprocs=W.WORLD)
    return refs, served, torch.load(os.path.join(d, "results.pt"), weights_only=False)


def max_rel(want, got) -> float:
    want, got = want.float(), got.float()
    return float((want - got).abs().max() / want.abs().max())


@pytest.mark.parametrize("arch", TRAIN)
def test_sequence_parallel_loss_and_grads(world, arch):
    refs, _, got = world
    W.check_loss_and_grads(refs[arch], got[arch])
    if refs[arch]["cfg"].n_experts:
        W.check_moe(refs[arch], got[arch])


@pytest.mark.parametrize("arch", TRAIN)
def test_sequence_parallel_step_zero1(world, arch):
    refs, _, got = world
    W.check_step(refs[arch], got[arch])


@pytest.mark.parametrize("arch", SERVE)
def test_prefill_and_decode_on_dtensor_caches(world, arch):
    _, want, got = world
    want, res = want["serve"][arch], got["serve"][arch]
    assert len(res["logits"]) == STEPS + 1
    for i, (w, g) in enumerate(zip(want["logits"], res["logits"])):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), i
        assert max_rel(w, g) < SERVE_REL_TOL, (i, max_rel(w, g))
    # each layer's caches are split over the model axis (MLA's latent, the
    # k/v heads), and the new rows landed
    assert all(any(p.split(", ")[-1].startswith("Shard") for p in c.values())
               for c in res["placements"]), res["placements"]
    for wc, gc in zip(want["caches"], res["caches"]):
        for name, w in wc.items():
            assert max_rel(w, gc[name]) < SERVE_REL_TOL, name
            assert bool((gc[name][:, 16:16 + STEPS] != 0).flatten(2).any(-1).all()), name


@pytest.mark.parametrize("form", tuple(W.MOE_FORMS))
def test_moe_dispatch_forms_match_unsharded(world, form):
    """One MoE layer of dbrx-132b's reduced config (experts over the model
    axis) in each dispatch form, x split over the batch and the sequence:
    the output, the aux loss and the gradients by x, the router and the
    expert weights against the same layer on one process, within the
    rehearsal's budgets (5e-2 relative L2; the aux loss 1e-3)."""
    _, want, got = world
    w, g = want["moe_forms"][form], got["moe_forms"][form]
    assert g["y"].shape == w["y"].shape and g["y"].dtype == w["y"].dtype
    assert W.rel_l2(w["y"].float(), g["y"].float()) < W.GRAD_REL_L2
    assert W.rel(w["aux"], g["aux"]) < 1e-3
    for a, b in zip(w["grads"], g["grads"]):
        assert a.shape == b.shape and W.rel_l2(a.float(), b.float()) < W.GRAD_REL_L2
