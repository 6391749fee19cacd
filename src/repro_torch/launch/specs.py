"""Partition specs for parameters, optimizer state and step inputs (the
JAX package's ``launch/specs.py``), keyed by the port's names.

Rules, all with divisibility fallback (``Shardings.maybe``):

* Megatron TP on the model axis: column-parallel in-projections
  (wq/wk/wv/wuq/gate/up/wz/wx/wdt), row-parallel out-projections
  (wo/down/out); vocab-sharded embedding + head.
* Optional FSDP: the *other* matrix dim additionally shards over
  (pod, data).
* MoE: expert-parallel over ``model`` when n_experts divides the axis
  (dbrx, jamba), else TP-in-expert on d_ff (mixtral).
* KV caches shard batch over data and kv-heads (or head_dim) over model.
* ZeRO-1 optimizer state via ``repro_torch.optim.adamw.zero1_state_specs``.

The JAX package stacks each pattern position's parameters ``[G, ...]``
(a leading ``None`` in its specs); the port holds one ``layers.{l}``
module a layer, so that ``None`` drops out and layer ``l`` takes the rule
of pattern position ``l % len(pattern)`` (the same leaf names and
shapes).  Parameter names are the ``state_dict``'s: ``embed``,
``layers.{l}.{ln,ln2,mixer.*,ffn.*}``, ``final_norm``, ``lm_head``.

``distribute_model`` and ``distribute_opt_state`` place a model's
parameters and an AdamW state as DTensors by these specs.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding import P, Shardings

# leaves sharded on their LAST dim over `model`
_COL = {"wq", "wk", "wv", "wuq", "wukv", "wdq", "wdkv", "wz", "wx", "wdt",
        "gate", "up", "bq", "bk", "bv", "conv_x"}
# leaves sharded on their FIRST (matrix) dim over `model`
_ROW = {"wo", "down", "out"}
# 1-D mamba per-head/inner vectors
_VEC = {"A_log", "Dskip", "dt_bias", "norm"}
# always replicated
_REP = {"ln", "ln2", "q_ln", "kv_ln", "q_norm", "k_norm", "final_norm",
        "router", "wkr", "wB", "wC", "conv_B", "conv_C"}


def shapes_of(tree) -> dict:
    """``{name: shape}`` of a module's parameters or a dict of tensors or
    shapes."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    return {k: tuple(v.shape) if hasattr(v, "shape") else tuple(v) for k, v in tree.items()}


def param_specs(cfg, sh: Shardings, model, *, fsdp: bool = False,
                decode2d: bool = False) -> dict:
    """``{parameter name: P}`` for ``model`` (an ``LM``, or ``{name: tensor
    or shape}``).

    ``decode2d``: weights fully output-sharded over the combined (pod,
    data, model) axes with the contracting dim replicated — at decode the
    activations are tiny, so gathering them beats gathering FSDP weight
    shards."""
    shapes = shapes_of(model)
    if not sh.enabled:
        return {k: P() for k in shapes}

    combined = tuple([*(sh.batch_axes or ()), sh.model]) if decode2d else None

    def out_axis(dim, name):
        if decode2d and combined is not None:
            ax = sh.maybe(combined, dim, name)
            if ax is not None:
                return ax
        return sh.maybe(sh.model, dim, name)

    def fs(dim):
        """FSDP axis for the non-TP matrix dim."""
        if not fsdp or decode2d:
            return None
        return sh.maybe(sh.batch_axes, dim, "fsdp")

    def rule(path, shp):
        names = path.split(".")
        name = names[-1]
        in_moe = "ffn" in names and cfg.n_experts > 0

        if name == "embed":
            if decode2d:
                return P(None, out_axis(shp[1], name))
            return P(sh.maybe(sh.model, shp[0], name), fs(shp[1]))
        if name == "lm_head":
            return P(fs(shp[0]), out_axis(shp[1], name))

        # MoE expert tensors are [E, d_in, d_out]; dense swiglu shares the
        # leaf names but is rank-2 — jamba mixes both in one pattern
        if in_moe and name in ("gate", "up", "down") and len(shp) == 3:
            if cfg.moe_ep and shp[0] % sh.axis_size(sh.model) == 0:
                if decode2d:
                    if name in ("gate", "up"):
                        return P(sh.model, None, sh.maybe(sh.batch_axes, shp[2], name))
                    return P(sh.model, sh.maybe(sh.batch_axes, shp[1], name), None)
                return P(sh.model, fs(shp[1]), None)
            if name in ("gate", "up"):
                return P(None, fs(shp[1]), out_axis(shp[2], name))
            if decode2d:
                return P(None, out_axis(shp[1], name), None)
            return P(None, sh.maybe(sh.model, shp[1], name), fs(shp[2]))

        if name in _REP:
            return P(*([None] * len(shp)))
        if name in _VEC:
            return P(sh.maybe(sh.model, shp[0], name))
        if name in _COL:
            if len(shp) == 1:   # bias
                return P(out_axis(shp[0], name))
            return P(fs(shp[0]), out_axis(shp[1], name))
        if name in _ROW:
            if decode2d:
                return P(out_axis(shp[0], name), None)
            return P(sh.maybe(sh.model, shp[0], name), fs(shp[1]))
        return P(*([None] * len(shp)))

    return {k: rule(k, shp) for k, shp in shapes.items()}


def batch_specs(cfg, sh: Shardings, batch) -> dict:
    """Specs for a step's ``batch`` dict: the batch dim over the data axes."""
    shapes = shapes_of(batch)
    if not sh.enabled:
        return {k: P() for k in shapes}
    return {k: P(sh.maybe(sh.batch_axes, shp[0], "batch"), *([None] * (len(shp) - 1)))
            for k, shp in shapes.items()}


def cache_specs(cfg, sh: Shardings, caches) -> list:
    """Decode caches (``lm.init_cache``: one dict a layer, ``[B, ...]``
    leaves): a list of ``{name: P}``."""
    if not sh.enabled:
        return [{k: P() for k in c} for c in caches]

    def rule(name, shp):
        ba = sh.maybe(sh.batch_axes, shp[0], "cache batch")
        if name in ("k", "v"):
            # [B, S, Hkv, Dh]
            if sh.decode_replicate:
                # decode2d: shard the sequence — contractions against the
                # cache partial-sum, and no tensor larger than the per-token
                # activations moves
                return P(ba, sh.maybe(sh.model, shp[1], "cache seq"), None, None)
            h = sh.maybe(sh.model, shp[2], "cache kv heads")
            d = None if h else sh.maybe(sh.model, shp[3], "cache head_dim")
            return P(ba, None, h, d)
        if name == "ckv":
            if sh.decode_replicate:
                return P(ba, sh.maybe(sh.model, shp[1], "latent seq"), None)
            return P(ba, None, sh.maybe(sh.model, shp[2], "latent"))
        if name == "kr":
            if sh.decode_replicate:
                return P(ba, sh.maybe(sh.model, shp[1], "rope seq"), None)
            return P(ba, None, None)
        if name == "ssm":
            # [B, H, Pdim, N]
            return P(ba, sh.maybe(sh.model, shp[1], "ssm heads"), None, None)
        if name.startswith("conv"):
            return P(ba, None, sh.maybe(sh.model, shp[2], "conv"))
        return P(*([None] * len(shp)))

    return [{k: rule(k, tuple(v.shape)) for k, v in c.items()} for c in caches]


def distribute_model(model: nn.Module, sh: Shardings, specs: dict) -> nn.Module:
    """Place every parameter of ``model`` as a DTensor by ``specs``, in
    place (each from rank 0's full tensor: ``distribute_tensor``).
    Returns ``model``; unchanged when ``sh`` is disabled."""
    if not sh.enabled:
        return model
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            mod.register_parameter(leaf, nn.Parameter(
                sh.distribute(p.detach(), specs[name]), requires_grad=p.requires_grad))
    return model


def distribute_tree(tree: dict, sh: Shardings, specs: dict) -> dict:
    """``{name: tensor}`` placed as DTensors by ``{name: P}``."""
    return {k: sh.distribute(v, specs[k]) for k, v in tree.items()}


def distribute_opt_state(state, sh: Shardings, specs):
    """An ``AdamWState`` placed by a ``zero1_state_specs`` tree (the step
    count stays a plain tensor on every rank)."""
    return type(state)(
        step=state.step,
        mu=distribute_tree(state.mu, sh, specs.mu),
        nu=distribute_tree(state.nu, sh, specs.nu),
        master=None if state.master is None else distribute_tree(state.master, sh,
                                                                 specs.master))
