"""Sharding rules for the production meshes (the JAX package's
``sharding.py``), on a ``torch.distributed`` ``DeviceMesh``.

Axes: the single-pod mesh is ``(data=16, model=16)``; the multi-pod mesh
adds a leading ``pod`` axis that extends data parallelism hierarchically.
Where the JAX package writes a ``PartitionSpec`` and lets GSPMD place
every tensor, the port writes the same spec (``P``) and places tensors as
DTensors: ``Shardings.placements`` turns a spec into one placement per
mesh dim, ``constrain`` redistributes (``with_sharding_constraint``).

Divisibility fallback: a tensor dim not divisible by its target axis size
is replicated instead (``maybe``), and logged, as in the JAX package.

``Shardings(None)`` (``NOSHARD``) and plain tensors disable every
constraint, so the unsharded port runs as it did.  A mesh may also be a
duck-typed object with ``axis_names`` and ``axis_sizes`` (the spec rules
need no process group); only ``placements`` and the ``constrain`` family
need a real ``DeviceMesh``.
"""

from __future__ import annotations

import logging
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

log = logging.getLogger(__name__)


class P(tuple):
    """The port's ``PartitionSpec``: one entry a tensor dim, each a mesh
    axis name, a tuple of names (that dim sharded over several mesh dims,
    in order) or ``None`` (replicated); dims past the end are replicated.
    A one-name tuple reads as the name, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def spec_axes(entry) -> tuple:
    """The mesh axis names of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mesh_axes(mesh) -> tuple[tuple, tuple]:
    """(axis names, axis sizes) of a ``DeviceMesh`` or a duck-typed mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    return tuple(mesh.axis_names), tuple(mesh.axis_sizes)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def replicate_like(ref, t):
    """``t``, a plain tensor that every rank holds whole, as a replicated
    DTensor on ``ref``'s mesh when ``ref`` is a DTensor (DTensor refuses
    to mix the two in one operation); else ``t``."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    return DTensor.from_local(t, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def local_apply(fn, x, shape):
    """``fn`` on each rank's shard of a DTensor ``x`` (``fn`` changes only
    dims that ``x`` is not split on), the result placed as ``x`` with the
    global shape ``shape``; ``fn(x)`` on a plain tensor."""
    if not is_dtensor(x):
        return fn(x)
    stride = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape), stride=tuple(stride))


def placed_like(x, like):
    """``x`` redistributed to ``like``'s placements where both are DTensors
    and they differ; else ``x``."""
    if is_dtensor(x) and is_dtensor(like) and tuple(x.placements) != tuple(like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def sharded_dim(x, dim: int) -> bool:
    """Whether ``x`` is a DTensor split along ``dim`` over more than one
    device."""
    if not is_dtensor(x):
        return False
    return any(isinstance(pl, Shard) and pl.dim % x.ndim == dim % x.ndim and size > 1
               for pl, size in zip(x.placements, x.device_mesh.shape))


def divisible_split(x, dim: int, n: int):
    """``x``, ready to split its dim ``dim`` into ``n`` parts and the rest:
    a DTensor sharded along it over more devices than ``n`` is a multiple
    of is gathered along it first (the divisibility fallback: the parts
    are replicated)."""
    if is_dtensor(x):
        over = [i for i, pl in enumerate(x.placements)
                if isinstance(pl, Shard) and pl.dim % x.ndim == dim % x.ndim]
        if n % math.prod(x.device_mesh.shape[i] for i in over):
            x = replicate_dim(x, dim)
    return x


def replicate_dim(x, dim: int):
    """A DTensor gathered along its dim ``dim``; else ``x``."""
    if not sharded_dim(x, dim):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(pl, Shard) and pl.dim % x.ndim == dim % x.ndim else pl
        for pl in x.placements])


def split_heads(x, n: int, d: int):
    """``x [..., n * d]`` viewed as ``[..., n, d]`` (``divisible_split``)."""
    return divisible_split(x, -1, n).reshape(*x.shape[:-1], n, d)


def put_rows_(cache, new, at):
    """``cache [B, S, ...]`` with row ``at[b]`` of sequence ``b`` set to
    ``new [B, ...]``, in place; returns ``cache``.  A DTensor cache takes
    the write on each rank's shard: ``new`` and ``at`` are placed as its
    batch and trailing dims first, and a rank whose shard of the sequence
    does not hold a row leaves it (no shard moves)."""
    if not is_dtensor(cache):
        cache[torch.arange(cache.shape[0], device=cache.device), at] = new.to(cache.dtype)
        return cache
    mesh, pls = cache.device_mesh, cache.placements
    lead = lambda pl: pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()  # noqa: E731
    new = replicate_like(cache, new).redistribute(mesh, [
        Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim >= 2 else lead(pl)
        for pl in pls]).to_local()
    at = replicate_like(cache, at).redistribute(mesh, [lead(pl) for pl in pls]).to_local()
    loc = cache.to_local()
    off, span = 0, cache.shape[1]           # this shard's first row of the sequence
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard) and pl.dim == 1:
            span //= mesh.size(i)
            off += mesh.get_coordinate()[i] * span
    pos = torch.arange(off, off + loc.shape[1], device=loc.device)
    hit = (pos[None, :] == at[:, None]).reshape(*at.shape, loc.shape[1],
                                                *([1] * (loc.dim() - 2)))
    loc.copy_(torch.where(hit, new.to(loc.dtype)[:, None], loc))
    return cache


class _Held(torch.autograd.Function):
    """The identity, whose backward places the gradient as the forward
    placed its input (a partial sum's gradient replicated)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if pl.is_partial() else pl for pl in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def held(x):
    """``x``, whose gradient comes back placed as ``x`` is (a DTensor; else
    ``x`` itself).  For a product's output whose gradient DTensor's own
    choices would place otherwise: after a norm over its sharded last dim
    (MLA's latents), or under a replicated microbatch with FSDP weights
    (the FFN), the gradient can land on the sequence, a strided shard once
    the product's backward flattens it."""
    return _Held.apply(x) if is_dtensor(x) and x.requires_grad else x


def merge_heads(x):
    """``x [..., H, D]`` viewed as ``[..., H * D]``.  A DTensor whose heads
    are not split (the divisibility fallback) merges on each rank's shard:
    its backward then gathers the gradient's ``H * D`` (split by a
    row-parallel weight) before it splits it into heads again, where a
    view would split an uneven shard."""
    shape = (*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if not is_dtensor(x) or sharded_dim(x, -2) or sharded_dim(x, -1):
        return x.reshape(shape)
    return local_apply(lambda t: t.reshape(*t.shape[:-2], shape[-1]), x, shape)


class Shardings:
    """Mesh-aware spec factory with divisibility fallback.

    ``mesh=None`` disables all constraints (the unsharded port)."""

    def __init__(self, mesh=None, *, seq_shard: bool = False,
                 decode_replicate: bool = False):
        self.mesh = mesh
        self.enabled = mesh is not None
        self.seq_shard = seq_shard
        # decode optimization: replicate the (tiny) per-token activations
        # over the data axes so matmuls contract against locally sharded 2D
        # weights instead of all-gathering FSDP weight shards
        self.decode_replicate = decode_replicate
        if self.enabled:
            names, sizes = mesh_axes(mesh)
            self.names = names
            self.batch_axes = tuple(a for a in ("pod", "data") if a in names)
            self.model_axis = "model" if "model" in names else None
            self.sizes = dict(zip(names, sizes))
        else:
            self.names = ()
            self.batch_axes = ()
            self.model_axis = None
            self.sizes = {}

    # ---------------- axis helpers ----------------

    def axis_size(self, axis) -> int:
        out = 1
        for a in spec_axes(axis):
            out *= self.sizes.get(a, 1)
        return out

    def maybe(self, axis, dim: int, what: str = ""):
        """``axis`` if ``dim`` divides evenly over it, else None (replicate)."""
        if not self.enabled or axis is None:
            return None
        n = self.axis_size(axis)
        if dim % n == 0:
            return axis
        log.info("sharding fallback: %s dim %d not divisible by %s=%d -> replicated",
                 what, dim, axis, n)
        return None

    @property
    def batch(self):
        return self.batch_axes if self.batch_axes else None

    @property
    def model(self):
        return self.model_axis

    @property
    def seq(self):
        """Sequence-parallel axis for inter-block activations."""
        return self.model_axis if (self.seq_shard and self.enabled) else None

    # ---------------- placements ----------------

    def placements(self, spec) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim
        ``d``'s entry names that mesh dim, else ``Replicate()``."""
        out = [Replicate() for _ in self.names]
        for d, entry in enumerate(spec):
            for a in spec_axes(entry):
                if not isinstance(out[self.names.index(a)], Replicate):
                    raise ValueError(f"{spec}: mesh axis {a!r} named twice")
                out[self.names.index(a)] = Shard(d)
        return tuple(out)

    def distribute(self, t: torch.Tensor, spec) -> torch.Tensor:
        """``t`` (the same full tensor on every rank) as a DTensor placed by
        ``spec`` (rank 0's values); ``t`` itself when disabled."""
        if not self.enabled:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, self.placements(spec))

    # ---------------- constraints ----------------

    def constrain(self, x, spec):
        """``with_sharding_constraint``: redistribute a DTensor to ``spec``;
        the identity on a plain tensor or when disabled."""
        if not self.enabled or not is_dtensor(x):
            return x
        pl = self.placements(spec)
        if tuple(x.placements) == pl:
            return x
        return x.redistribute(self.mesh, pl)

    def batch_of(self, x):
        """The batch axes for ``x``'s leading dim, or None where they do not
        divide it (a microbatch smaller than the data axes: replicated)."""
        return self.maybe(self.batch, x.shape[0], "batch")

    def constrain_act(self, x):
        """``[B, S, D]`` residual-stream activations."""
        if not self.enabled:
            return x
        s = self.seq if (self.seq and x.shape[1] % self.axis_size(self.seq) == 0) else None
        return self.constrain(x, P(self.batch_of(x), s, None))

    def whole_seq(self, x):
        """``[B, S, D]`` with its sequence whole under sequence parallelism:
        the normed residual entering a mixer or an FFN (GSPMD gathers it
        before a column-parallel weight) and the block's output before the
        residual add (reduced whole, so the backward hands the products a
        gradient whose sequence is whole too).  No product then flattens
        a sequence-sharded activation: a strided shard, which DTensor
        sizes on the host.  The identity without sequence parallelism."""
        if not self.seq or not is_dtensor(x):
            return x
        return self.constrain(x, P(self.batch_of(x), None, None))

    def constrain_dec(self, x):
        """Decode-path activation entering a weight matmul."""
        if not self.enabled:
            return x
        if self.decode_replicate:
            return self.constrain(x, P(*([None] * x.ndim)))
        return self.constrain(x, P(self.batch_of(x), *([None] * (x.ndim - 1))))

    def constrain_heads(self, x):
        """``[B, S, H, Dh]``."""
        if not self.enabled:
            return x
        if self.decode_replicate:
            # decode2d leaves the tiny per-token tensor free and reshards
            # at the cache instead
            return x
        h = self.maybe(self.model, x.shape[2], "attn heads")
        return self.constrain(x, P(self.batch_of(x), None, h, None))

    def constrain_ffn(self, h):
        """``[B, S, F]`` (or ``[..., F]``) ffn hidden."""
        if not self.enabled:
            return h
        if self.decode_replicate:
            comb = tuple([*(self.batch_axes or ()), self.model])
            f = self.maybe(comb, h.shape[-1], "ffn hidden (combined)")
            return self.constrain(h, P(*([None] * (h.ndim - 1)), f))
        f = self.maybe(self.model, h.shape[-1], "ffn hidden")
        spec = [self.batch_of(h)] + [None] * (h.ndim - 2) + [f]
        return self.constrain(h, P(*spec))

    def constrain_logits(self, x):
        if not self.enabled:
            return x
        if self.decode_replicate:
            comb = tuple([*(self.batch_axes or ()), self.model])
            v = self.maybe(comb, x.shape[-1], "vocab (combined)")
            return self.constrain(x, P(None, None, v))
        v = self.maybe(self.model, x.shape[-1], "vocab")
        return self.constrain(x, P(self.batch_of(x), None, v))

    # ---------------- local regions ----------------

    def local(self, fn, out_specs, in_specs, *args, summed=None, partial=None):
        """Run ``fn`` on each rank's shards (``local_map``): every DTensor
        argument is redistributed to its entry of ``in_specs`` (``None``
        for a non-tensor argument) and passed as its local tensor, and the
        outputs come back as DTensors placed by ``out_specs`` (one spec, or
        a tuple of specs for a tuple of outputs).  For the kernels, which
        take raw pointers, and for the ops DTensor has no sharding rule
        for.  ``summed`` maps an argument's index to the mesh axes it is
        replicated over while the others are sharded there: each rank then
        holds a part of its gradient (a weight's share of its batch shard,
        B/C's of its heads), summed over those axes.  ``partial`` maps an
        output's index to the mesh axes over which each rank's result is a
        share of a sum (``Partial``: the MoE load means of each rank's
        tokens).  With no DTensor argument, ``fn(*args)``."""
        if not self.enabled or not any(is_dtensor(a) for a in args):
            return fn(*args)
        def pl(s, axes=None):
            # one placement list a tensor (local_map reads a tuple as one
            # entry an output), Partial over ``axes``
            return None if s is None else [Partial() if n in spec_axes(axes) else q
                                           for n, q in zip(self.names, self.placements(s))]
        partial = partial or {}
        outs = (tuple(pl(s, partial.get(i)) for i, s in enumerate(out_specs))
                if isinstance(out_specs, tuple) and not isinstance(out_specs, P)
                else pl(out_specs, partial.get(0)))
        ins = tuple(pl(s) for s in in_specs)
        grads = tuple(pl(s, summed.get(i)) for i, s in enumerate(in_specs)) if summed else None
        return local_map(fn, out_placements=outs, in_placements=ins,
                         in_grad_placements=grads, device_mesh=self.mesh,
                         redistribute_inputs=True)(*args)


NOSHARD = Shardings(None)
