"""Production meshes (the JAX package's ``launch/mesh.py``), as
``torch.distributed`` ``DeviceMesh``es.

Single pod: 16x16 = 256 devices, axes (data, model).
Multi-pod:  2x16x16 = 512 devices, axes (pod, data, model): the ``pod``
axis extends data parallelism across the inter-pod network, the fabric
the paper's transport runs on.

A mesh needs a process group of as many ranks as it has devices:
``torchrun``'s, one that the caller starts, or ``fake_world(n)``, a
single-process ``fake`` group of ``n`` ranks that moves no data (the dry
run's).  Importing this module touches no device and no process group.
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


# (axis names, axis sizes) of the production meshes, by multi_pod
PRODUCTION = {False: (("data", "model"), (16, 16)),
              True: (("pod", "data", "model"), (2, 16, 16))}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    axes, shape = PRODUCTION[multi_pod]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device="cuda"):
    """Degenerate 1x1 (data, model) mesh: one rank runs the sharded code
    path.  Needs a process group of one rank."""
    return init_device_mesh(str(device).split(":")[0], (1, 1),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A ``fake`` process group of ``n`` ranks in this process, as rank
    ``rank``, torn down on exit.  Its collectives move no data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
