"""Fault-tolerant checkpointing (the JAX package's
``checkpoint/checkpointer.py``): atomic, keep-k, auto-resume.

Layout:  <dir>/step_<N>/{arrays.npz, meta.json}   (+ step_<N>.tmp during
write, renamed atomically on completion so a crash mid-save never corrupts
the restore path).  ``latest_step`` scans for the newest *complete*
checkpoint, so training loops restart from the last good state after a
node failure.

A tree is nested dicts (taken in sorted key order, as ``jax.tree``
does), lists, tuples and named tuples (``AdamWState``) over tensors or
numpy arrays, ``None`` holding no leaf: the training loop saves
``(model.state_dict(), optimizer state)``.  Leaf ``i`` is ``a{i}`` of the
npz; bf16, which numpy cannot store, is kept as its 16-bit integer view,
and its name in ``meta.json``.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

BF16 = "bfloat16"           # stored as uint16 (the reference's layout), viewed as int16


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken, in order, from ``it``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(t, it) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return next(it)


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _to_numpy(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def save(directory: str, step: int, tree, *, extra: dict | None = None, keep: int = 3):
    """Atomically persist a tree of tensors (copied to the host first)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = list(_leaves(tree))
    arrays = {f"a{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    dtypes = [_dtype_name(x) if isinstance(x, torch.Tensor) else str(np.asarray(x).dtype)
              for x in leaves]

    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(leaves),
                   "dtypes": dtypes, "extra": extra or {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)


def _gc(directory: str, keep: int):
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "meta.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str):
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _from_numpy(arr: np.ndarray, dtype_name: str, ref):
    """The stored array as ``ref``'s kind: a tensor on ``ref``'s device in
    its dtype, or a numpy array of its dtype."""
    if isinstance(ref, torch.Tensor):
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if dtype_name == BF16 else torch.from_numpy(arr))
        return t.to(device=ref.device, dtype=ref.dtype)
    return np.asarray(arr, dtype=np.asarray(ref).dtype)


def restore(directory: str, step: int, template):
    """Restore into the structure of ``template`` (shapes must match); each
    tensor leaf comes back on the template leaf's device, in its dtype."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    refs = list(_leaves(template))
    if meta["n_leaves"] != len(refs):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, template {len(refs)}")
    new = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, ref in enumerate(refs):
            arr = data[f"a{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != {tuple(ref.shape)}")
            new.append(_from_numpy(arr, meta["dtypes"][i], ref))
    return _rebuild(template, iter(new)), meta["extra"]


def restore_latest(directory: str, template):
    step = latest_step(directory)
    if step is None:
        return None, None, None
    tree, extra = restore(directory, step, template)
    return step, tree, extra
