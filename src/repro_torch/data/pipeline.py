"""Deterministic synthetic LM data pipeline.

Produces a reproducible token stream (a seeded Markov-ish mixture with
enough structure that a model's loss visibly falls) sharded by host:
host h of H draws disjoint index ranges, so multi-host training reads
disjoint data with no coordination.  The iterator state is one integer —
checkpointable, so restarts resume mid-epoch exactly.

The port's own copy of the JAX package's ``data/pipeline.py``, which is
numpy only: batches are numpy arrays, moved to the model's device by the
train step, and equal to the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    structure: int = 64     # markov states — lower = easier to learn


class SyntheticLM:
    """Deterministic, restartable synthetic token stream."""

    def __init__(self, cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.step = step
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.host_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        k = cfg.structure
        # sparse-ish markov transition over k states, each state emitting a
        # biased distribution over a vocab slice
        self.trans = rng.dirichlet(np.ones(k) * 0.1, size=k).astype(np.float32)
        self.emit_base = rng.integers(0, max(cfg.vocab - 16, 1), size=k)

    def __iter__(self):
        return self

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])

    def __next__(self):
        cfg = self.cfg
        # unique, deterministic seed per (host, step)
        seq_rng = np.random.default_rng(
            (cfg.seed, cfg.host_id, self.step, 0xDA7A))
        b, s = self.host_batch, cfg.seq_len
        k = self.trans.shape[0]
        states = np.zeros((b, s), np.int64)
        st = seq_rng.integers(0, k, size=b)
        u = seq_rng.random((b, s))
        cum = np.cumsum(self.trans, axis=1)
        for t in range(s):
            states[:, t] = st
            st = (cum[st] < u[:, t:t + 1]).sum(axis=1)
            st = np.minimum(st, k - 1)
        offs = seq_rng.integers(0, 16, size=(b, s))
        tokens = (self.emit_base[states] + offs) % cfg.vocab
        self.step += 1
        x = tokens.astype(np.int32)
        labels = np.concatenate([x[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": x, "labels": labels}
