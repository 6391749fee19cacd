"""PyTorch port, the sharded-training layer's MoE archs in a 4-process
gloo world on the CPU (``tests/torch_world.py``), against the JAX
package: reduced mixtral-8x22b (the one-hot einsum dispatch, experts
tensor-parallel on d_ff over the model axis; sliding-window attention)
and reduced jamba-1.5-large-398b (Mamba-2, attention and MoE layers; its
reduced config, as the JAX package's, has no expert parallelism:
``tests/test_torch_sharding_d.py`` trains dbrx-132b's, which has), each
on the (data=2, model=2) mesh with ``ARCH_RUN``'s fsdp and sequence
parallelism (both on).  The routing and dispatch run on each rank's
batch rows (``models/moe.py``), the expert buffers enter the experts by
``expert_spec``, the load-balance means come back as partial sums.

The loss, nll and aux and every gradient (``full_tensor()``) against
``jax.value_and_grad`` of the JAX package's loss on the same weights and
batch (B=4, S=32), then one step of 2 microbatches against the JAX
package's, from an AdamW state two updates in (``torch_world``'s checks).
The budgets are ``tests/test_torch_sharding_b.py``'s: the loss 2e-4
relative (the aux loss 1e-3, ``tests/test_torch_train.py``'s), each
gradient, step change and first moment 5e-2 relative L2, the learning
rate 2 f32 ULPs.  MoE routes are forced to the JAX package's choice; a
flip at a decided token fails (``torch_world.Forcing``).

jamba's reduced bf16 gradients are chaotic (the JAX package's own two
lowerings differ by up to 0.47 on a leaf, ``tests/test_torch_train.py``),
so it trains with f32 weights here, as ``tests/test_torch_train_c.py``
holds it; mixtral trains in bf16.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import torch_world as W  # noqa: E402

CASES = (("mixtral-8x22b", False), ("jamba-1.5-large-398b", True))


def _world(rank, d):
    mesh = W.init_rank(rank, d)
    try:
        res = {arch: W.train_case(d, mesh, arch) for arch, _ in CASES}
        if rank == 0:
            torch.save(res, os.path.join(d, "results.pt"))
    finally:
        W.dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the JAX references by arch, the world's results by arch)."""
    d = str(tmp_path_factory.mktemp("world"))
    torch.set_num_threads(1)
    J = W.jax_side()
    refs = {arch: W.train_reference(J, arch, f32=f32) for arch, f32 in CASES}
    for arch, ref in refs.items():
        W.save_case(d, arch, ref)
        W.step_reference(J, ref)
    torch.multiprocessing.spawn(_world, args=(d,), nprocs=W.WORLD)
    return refs, torch.load(os.path.join(d, "results.pt"), weights_only=False)


@pytest.mark.parametrize("arch", [a for a, _ in CASES])
def test_sharded_moe_loss_and_grads(world, arch):
    refs, got = world
    W.check_loss_and_grads(refs[arch], got[arch])
    W.check_moe(refs[arch], got[arch])


@pytest.mark.parametrize("arch", [a for a, _ in CASES])
def test_sharded_moe_step_zero1(world, arch):
    refs, got = world
    W.check_step(refs[arch], got[arch])
