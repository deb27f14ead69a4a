"""Deterministic synthetic LM data stream: a copy of
``repro/data/synthetic.py``, batch for batch the same numpy arrays.

Requirements for a training substrate: (a) stateless — any batch is a pure
function of (step, host), so restarts/elastic rescales resume exactly by
step counter, (b) learnable — a noisy affine bigram process gives the model
structure to fit, so e2e examples show loss actually decreasing, (c) fast —
pure numpy, no disk.

``batch_at(step)`` returns {"tokens": (B, T+0), "labels": (B, T)} with
labels = next-token targets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["SyntheticLM"]


def _hash64(x: np.ndarray) -> np.ndarray:
    """splitmix64 — deterministic per-element hashing."""
    x = x.astype(np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    host_id: int = 0
    num_hosts: int = 1
    noise: float = 0.05          # fraction of random tokens
    seed: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b, t, v = self.host_batch, self.seq_len, self.vocab
        rows = (np.arange(b, dtype=np.uint64)
                + np.uint64(self.host_id * b)
                + np.uint64(step) * np.uint64(self.global_batch)
                + np.uint64(self.seed) * np.uint64(0x10001))
        # noisy affine bigram chain: x_{i+1} = (a*x_i + c) mod v, occasionally
        # replaced by hash noise -> learnable transition structure
        a = 31 if v > 31 else 3
        c = 7
        seq = np.empty((b, t + 1), dtype=np.int64)
        seq[:, 0] = (_hash64(rows) % np.uint64(v)).astype(np.int64)
        h = _hash64(rows[:, None] * np.uint64(t + 1)
                    + np.arange(t + 1, dtype=np.uint64)[None, :])
        is_noise = (h % np.uint64(1000)).astype(np.float64) \
            < self.noise * 1000
        noise_tok = (_hash64(h) % np.uint64(v)).astype(np.int64)
        for i in range(1, t + 1):
            nxt = (a * seq[:, i - 1] + c) % v
            seq[:, i] = np.where(is_noise[:, i], noise_tok[:, i], nxt)
        return {"tokens": seq[:, :t].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}
