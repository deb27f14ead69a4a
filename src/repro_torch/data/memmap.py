"""Memmap-backed token dataset with a checkpointable cursor: a copy of
``repro/data/memmap.py``.

Binary format: little-endian uint32 token ids, one flat stream.  Each host
reads a disjoint strided slice (host h takes sequence windows h, h+H,
h+2H, ...), so adding hosts only re-strides — elastic-friendly.  The
cursor (sequence index) round-trips through checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["TokenFileDataset", "write_token_file"]


def write_token_file(path, tokens: np.ndarray) -> None:
    np.asarray(tokens, dtype=np.uint32).tofile(str(path))


@dataclasses.dataclass
class TokenFileDataset:
    path: str
    seq_len: int
    global_batch: int
    host_id: int = 0
    num_hosts: int = 1
    cursor: int = 0              # global sequence index (checkpointable)

    def __post_init__(self):
        self._mm = np.memmap(self.path, dtype=np.uint32, mode="r")
        self.num_windows = (len(self._mm) - 1) // self.seq_len
        if self.num_windows < self.global_batch:
            raise ValueError("token file too small for one global batch")

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts

    def next_batch(self) -> Dict[str, np.ndarray]:
        b, t = self.host_batch, self.seq_len
        idx = (self.cursor + self.host_id * b
               + np.arange(b)) % self.num_windows
        toks = np.stack([self._mm[i * t:(i + 1) * t + 1] for i in idx])
        self.cursor = (self.cursor + self.global_batch) % self.num_windows
        return {"tokens": toks[:, :t].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    # -- checkpoint integration ----------------------------------------
    def state_dict(self) -> dict:
        return {"cursor": int(self.cursor)}

    def load_state_dict(self, d: dict) -> None:
        self.cursor = int(d["cursor"])
