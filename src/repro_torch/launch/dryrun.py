"""Multi-pod dry run (the JAX package's ``launch/dryrun.py``): place every
(arch x shape x mesh) cell on the production meshes and run its step once
on fake tensors, for the per-device state bytes, FLOPs and collective
traffic.

Run (one cell; ``--reduced`` for the reduced configs):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod] [--set micro=8] [--out out.json]
Run everything:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Where the JAX package lowers and compiles against 512 placeholder XLA
devices, the port opens a ``fake`` process group of 256 or 512 ranks in
one process (``launch.mesh.fake_world``), builds the production mesh, and
runs the step as rank 0 under ``FakeTensorMode``: parameters, ZeRO-1
state, batch and caches are placed by ``launch.specs`` as DTensors of
fake tensors (shapes, no data), and the step's DTensor operations run
with their local shapes and emit their collectives, which move nothing.
Fake tensors carry no data, so the model runs with ``backend="dense"``
(the plain versions, attention as one product a head): the dry run
measures shapes and traffic, not kernels.  ``device`` is where the fake
tensors say they live; nothing is allocated there.

Reported per device (rank 0): ``state_bytes_per_device`` (analytic, from
the specs, as the JAX package's), ``flops`` (``torch.utils.flop_counter``'s
formulas on the local operations), ``bytes_accessed`` (each local
operation's operand and result bytes, XLA's "bytes accessed") and
``collectives`` (each collective's output bytes and count, by the JAX
package's five kinds).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, applicable_shapes, input_specs
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import PRODUCTION, fake_world, make_production_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.sharding import P, Shardings, mesh_axes, spec_axes
from repro_torch.train.step import TrainConfig, make_train_step

# Per-arch execution knobs (microbatching + FSDP + sequence sharding + bf16
# moments for the >=90B models so everything fits 16 GB a device)
ARCH_RUN = {
    "llama-3.2-vision-90b": dict(micro=16, fsdp=True, sp=True, adam="bfloat16"),
    "qwen2-0.5b": dict(micro=1, fsdp=False, sp=False, adam="float32"),
    "qwen3-0.6b": dict(micro=1, fsdp=False, sp=False, adam="float32"),
    "minicpm3-4b": dict(micro=8, fsdp=False, sp=True, adam="float32"),
    "phi3-mini-3.8b": dict(micro=4, fsdp=False, sp=True, adam="float32"),
    "musicgen-large": dict(micro=4, fsdp=False, sp=True, adam="float32"),
    "mamba2-780m": dict(micro=4, fsdp=False, sp=False, adam="float32"),
    "dbrx-132b": dict(micro=16, fsdp=True, sp=True, adam="bfloat16"),
    "mixtral-8x22b": dict(micro=16, fsdp=True, sp=True, adam="bfloat16"),
    "jamba-1.5-large-398b": dict(micro=16, fsdp=True, sp=True, adam="bfloat16"),
}

@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes without devices: what the spec rules and the state
    bytes read."""
    axis_names: tuple
    axis_sizes: tuple


# the production meshes' axes, by multi_pod
PRODUCTION_MESHES = {mp: MeshShape(*axes) for mp, axes in PRODUCTION.items()}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# the functional collectives DTensor emits, by the JAX package's kinds
_KINDS = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_out": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all"}


def _leaves(tree, path=""):
    """(path, leaf) of a nested dict / list / NamedTuple, ``None`` skipped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}/{k}")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def per_device_bytes(tree, spec_tree, mesh) -> int:
    """Analytic bytes a device for a sharded tree (``mesh``: a
    ``DeviceMesh`` or anything with ``axis_names``/``axis_sizes``)."""
    sizes = dict(zip(*mesh_axes(mesh)))
    specs = dict(_leaves(spec_tree))
    total = 0
    for path, leaf in _leaves(tree):
        n = math.prod(leaf.shape) * leaf.element_size()
        denom = 1
        for entry in specs[path]:
            for ax in spec_axes(entry):
                denom *= sizes.get(ax, 1)
        total += n // max(denom, 1)
    return total


class StepCounter(TorchDispatchMode):
    """Counts what each rank runs: the FLOPs (``flop_counter``'s formulas)
    and operand + result bytes of every local operation, and the output
    bytes and count of every collective.  A DTensor operation is passed
    on (``NotImplemented``) to DTensor, which runs it as local operations
    and collectives that come back through this mode.  The operations
    DTensor runs on global shapes to propagate their metadata (inside its
    ``ShardingPropagator._propagate_tensor_meta*``) are left out."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _propagating():
            return out      # DTensor's shape propagation, on global shapes
        packet = func._overloadpacket
        name = packet.__name__
        if name in _KINDS and func.namespace == "_c10d_functional":
            kind = _KINDS[name]
            self.coll[kind] += _nbytes(out)
            self.counts[kind] += 1
            return out
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
        if func.namespace == "aten" and not name.startswith(("view", "_unsafe_view",
                                                               "detach", "alias")):
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


def _propagating(depth: int = 40) -> bool:
    """Whether DTensor's metadata propagation is on the call stack."""
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f, depth = f.f_back, depth - 1
    return False


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    return 0


def _run_opts(arch, run_overrides):
    run = dict(ARCH_RUN[arch])
    if run_overrides:
        run.update(run_overrides)
    return run


def _cfg_for(cfg, run):
    for knob, field, value in (("moe_sorted", "moe_sorted", True),
                               ("moe_bf16", "moe_bf16", True),
                               ("attn_bf16", "attn_bf16", True),
                               ("moe_local", "moe_local_chunks", 16)):
        if run.get(knob):
            cfg = dataclasses.replace(cfg, **{field: value})
    return cfg


def _cell_state(cfg, shape, sh, run, device):
    """(the model on ``device``, unplaced, its parameter specs, the AdamW
    config) of a cell."""
    dec2d = bool(run.get("dec2d")) and shape.kind == "decode"
    model = lm.LM(cfg, device=device, backend="dense")
    pspecs = S.param_specs(cfg, sh, model, fsdp=run["fsdp"], decode2d=dec2d)
    return model, pspecs, adamw.AdamWConfig(moment_dtype=run["adam"])


def _shardings(mesh, run):
    return Shardings(mesh, seq_shard=run["sp"], decode_replicate=bool(run.get("dec2d", False)))


def state_bytes(arch: str, shape_name: str, mesh, *, reduced: bool = False,
                run_overrides: dict | None = None) -> int:
    """The analytic state bytes a device of a cell (the JAX package's
    ``state_bytes_per_device``: parameters, plus the ZeRO-1 AdamW state for
    a train step or the caches for a decode step), on ``meta`` tensors;
    ``mesh`` may be anything with ``axis_names`` and ``axis_sizes``."""
    run = _run_opts(arch, run_overrides)
    cfg = _cfg_for(get_config(arch, reduced=reduced), run)
    shape = SHAPES[shape_name]
    sh = _shardings(mesh, run)
    model, pspecs, acfg = _cell_state(cfg, shape, sh, run, "meta")
    params = dict(model.named_parameters())
    total = per_device_bytes(params, pspecs, mesh)
    if shape.kind == "train":
        total += per_device_bytes(adamw.init(acfg, params),
                                  adamw.zero1_state_specs(acfg, pspecs, params, sh), mesh)
    elif shape.kind == "decode":
        caches = input_specs(cfg, shape, device="meta")["caches"]
        total += per_device_bytes(caches, S.cache_specs(cfg, sh, caches), mesh)
    return total


def _build_with_cfg(cfg, arch, shape_name, mesh, run, *, device="cpu"):
    """Place a cell on ``mesh``: returns (fn, args, meta).  Call inside
    ``FakeTensorMode`` (a real mesh's process group would move real data
    of full size).  ``fn(*args)`` runs the cell's step once."""
    shape = SHAPES[shape_name]
    sh = _shardings(mesh, run)
    cfg = _cfg_for(cfg, run)
    model, pspecs, acfg = _cell_state(cfg, shape, sh, run, device)
    shapes = {k: p.detach() for k, p in model.named_parameters()}
    S.distribute_model(model, sh, pspecs)
    cell = input_specs(cfg, shape, device=device)
    batch = {k: torch.zeros_like(v) for k, v in cell["batch"].items()}
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind}

    if shape.kind == "train":
        tcfg = TrainConfig(adam=acfg, microbatches=run["micro"])
        opt = S.distribute_opt_state(adamw.init(acfg, shapes), sh,
                                     adamw.zero1_state_specs(acfg, pspecs, shapes, sh))
        step = make_train_step(cfg, tcfg, sh, device=device)   # places the batch
        return step, (model, opt, batch), meta
    batch = S.distribute_tree(batch, sh, S.batch_specs(cfg, sh, batch))
    if shape.kind == "prefill":
        def fn(model, batch):
            return lm.prefill(model, batch, cell["max_len"], sh)
        return fn, (model, batch), meta
    caches = [S.distribute_tree({k: torch.zeros_like(v) for k, v in c.items()}, sh, cs)
              for c, cs in zip(cell["caches"], S.cache_specs(cfg, sh, cell["caches"]))]
    cl = cell["cache_len"]
    cache_len = sh.distribute(torch.full_like(cl, shape.seq),
                              P(sh.maybe(sh.batch_axes, cl.shape[0], "cache_len")))

    def fn(model, batch, caches, cache_len):
        return lm.decode_step(model, batch, caches, cache_len, sh)
    return fn, (model, batch, caches, cache_len), meta


def _fake_cell(cfg, arch, shape_name, *, multi_pod, run, device):
    """(meta, the StepCounter of one run of the cell's step, wall s)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=str(device))
        with FakeTensorMode():
            fn, args, meta = _build_with_cfg(cfg, arch, shape_name, mesh, run,
                                             device=device)
            t0 = time.perf_counter()
            with StepCounter() as count:
                fn(*args)
            wall = time.perf_counter() - t0
    return meta, count, wall


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             reduced: bool = False, verbose: bool = True,
             run_overrides: dict | None = None, device="cuda") -> dict:
    """One cell: ``fake_world(256 or 512)``, the production mesh, the
    state placed by the specs under ``FakeTensorMode``, the step once."""
    cfg = get_config(arch, reduced=reduced)
    meta, count, wall = _fake_cell(cfg, arch, shape_name, multi_pod=multi_pod,
                                   run=_run_opts(arch, run_overrides), device=device)
    meta["state_bytes_per_device"] = state_bytes(
        arch, shape_name, PRODUCTION_MESHES[multi_pod], reduced=reduced,
        run_overrides=run_overrides)
    res = dict(meta, mesh="2x16x16" if multi_pod else "16x16", ok=True,
               step_s=wall, flops=float(count.flops), bytes_accessed=float(count.bytes),
               collectives=dict(count.coll, counts=dict(count.counts)))
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {res['mesh']}: OK (fake step "
              f"{wall:.1f}s, flops {res['flops']:.3e}, "
              f"state/device {meta['state_bytes_per_device'] / 2**30:.2f} GiB)")
        print("  collectives: " + ", ".join(
            f"{k} {v / 2**20:.1f}MiB x{count.counts[k]}" for k, v in count.coll.items()))
    return res


def param_counts(cfg) -> tuple[int, int]:
    """(parameters, parameters touched a token: top_k of n_experts)."""
    model = lm.LM(cfg, device="meta")
    total = active = 0
    for name, p in model.named_parameters():
        n = p.numel()
        total += n
        if (name.split(".")[-1] in ("gate", "up", "down") and ".ffn." in name
                and p.dim() >= 3 and cfg.n_experts in p.shape):
            n = n * cfg.top_k // cfg.n_experts
        active += n
    return total, active


def roofline_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                  verbose: bool = True, run_overrides: dict | None = None,
                  device="cuda") -> dict:
    """Per-step cost of a cell at full depth and ``micro=1``, with the JAX
    package's keys.  XLA's cost analysis counts a loop body once, so the
    JAX package lowers one and two repetitions and extrapolates; a
    fake-tensor run executes every layer, so one full-depth run counts the
    whole step and needs no depth differencing."""
    cfg = get_config(arch)
    run = _run_opts(arch, dict(run_overrides or {}, micro=1))
    _, count, _ = _fake_cell(cfg, arch, shape_name, multi_pod=multi_pod, run=run,
                             device=device)
    shape = SHAPES[shape_name]
    n_all, n_act = param_counts(cfg)
    res = dict(
        arch=arch, shape=shape_name, kind=shape.kind,
        mesh="2x16x16" if multi_pod else "16x16",
        chips=512 if multi_pod else 256,
        flops_per_device=float(count.flops),
        bytes_per_device=float(count.bytes),
        collectives_per_device=dict(count.coll),
        params=n_all, params_active=n_act,
        tokens=shape.global_batch * (shape.seq if shape.kind != "decode" else 1),
        ok=True,
    )
    if verbose:
        print(f"[roofline] {arch} x {shape_name} x {res['mesh']}: "
              f"flops/dev {res['flops_per_device']:.3e} "
              f"bytes/dev {res['bytes_per_device']:.3e}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="use reduced configs (CI smoke)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="the per-step cost at full depth and micro=1")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    metavar="K=V", help="run-knob overrides, e.g. "
                    "--set dec2d=1 --set micro=8")
    ap.add_argument("--device", default="cuda",
                    help="where the fake tensors say they live (nothing is allocated)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.sets:
        k, v = kv.split("=", 1)
        if k == "micro":
            overrides[k] = int(v)
        elif k == "adam":
            overrides[k] = v
        else:
            overrides[k] = v.lower() in ("1", "true", "yes")

    runner = roofline_cell if args.roofline else run_cell
    kw = {"run_overrides": overrides, "device": args.device}
    if not args.roofline:
        kw["reduced"] = args.reduced
    results = []
    if args.all:
        meshes = (False,) if args.roofline else (False, True)
        for arch in ARCH_IDS:
            cfg = get_config(arch, reduced=args.reduced)
            for shape in applicable_shapes(cfg):
                for mp in meshes:
                    try:
                        results.append(runner(arch, shape.name, multi_pod=mp, **kw))
                    except Exception as e:  # noqa: BLE001 -- a sweep reports every cell
                        print(f"[dryrun] {arch} x {shape.name} mp={mp}: FAIL "
                              f"{type(e).__name__}: {e}")
                        results.append({"arch": arch, "shape": shape.name,
                                        "mesh": "2x16x16" if mp else "16x16",
                                        "ok": False, "error": str(e)[:500]})
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --all)")
        results.append(runner(args.arch, args.shape, multi_pod=args.multi_pod, **kw))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    sys.exit(0 if all(r.get("ok") for r in results) else 1)


if __name__ == "__main__":
    main()
