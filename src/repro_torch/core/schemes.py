"""The deployable PPA table artifact and its numpy golden evaluation.

A ``PPATable`` is what the FQA compiler produces: segment starts, the
integer coefficient ROM and the word lengths.  The port reads the JSON the
compiler writes (the ``PPATable.to_json`` field set of the JAX package) and
does not compile tables itself.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

from .datapath import DatapathPlan, FWLConfig, horner_body

__all__ = ["PPAScheme", "PPATable", "eval_table_int"]


@dataclasses.dataclass(frozen=True)
class PPAScheme:
    """FQA-On (m_shifters=None) or FQA-Sm-On (m_shifters=m) + quantizer."""

    order: int = 1
    m_shifters: Optional[int] = None
    quantizer: str = "fqa"
    weight: str = "hamming"
    segmenter: str = "tbw"

    @property
    def tag(self) -> str:
        base = (f"S{self.m_shifters}-O{self.order}" if self.m_shifters
                else f"O{self.order}")
        tag = f"{self.quantizer.upper()}-{base}"
        if self.segmenter == "nonuniform":
            tag += "-NU"
        return tag


@dataclasses.dataclass
class PPATable:
    """Compiled piecewise-polynomial table."""

    naf: str
    interval: Tuple[float, float]
    cfg: FWLConfig
    scheme: PPAScheme
    starts_int: np.ndarray      # (S,) segment start x (int, FWL w_in)
    a_int: np.ndarray           # (S, n) stage coefficients, FWL cfg.w_a[i]
    b_int: np.ndarray           # (S,)
    mae_hard: float
    mae_t: float

    @property
    def num_segments(self) -> int:
        return int(self.starts_int.shape[0])

    @property
    def order(self) -> int:
        return int(self.a_int.shape[1])

    def validate(self) -> "PPATable":
        """One coefficient row per segment and strictly increasing starts:
        the segment select of every executor assumes both."""
        s = self.num_segments
        if s == 0:
            raise ValueError(f"table {self.naf}: no segments")
        if self.a_int.shape[0] != s or self.b_int.shape[0] != s:
            raise ValueError(
                f"table {self.naf}: coefficient rows ({self.a_int.shape[0]}"
                f"/{self.b_int.shape[0]}) do not match {s} segments")
        if s > 1 and not bool(np.all(np.diff(self.starts_int) > 0)):
            raise ValueError(
                f"table {self.naf}: starts_int must be strictly increasing")
        return self

    @staticmethod
    def from_json(s: str) -> "PPATable":
        d = json.loads(s)
        cfg = dict(d["cfg"])
        cfg["w_a"] = tuple(cfg["w_a"])
        cfg["w_o"] = tuple(cfg["w_o"])
        return PPATable(
            naf=d["naf"], interval=tuple(d["interval"]),
            cfg=FWLConfig(**cfg), scheme=PPAScheme(**d["scheme"]),
            starts_int=np.asarray(d["starts_int"], dtype=np.int64),
            a_int=np.asarray(d["a_int"], dtype=np.int64).reshape(
                len(d["starts_int"]), -1),
            b_int=np.asarray(d["b_int"], dtype=np.int64),
            mae_hard=d["mae_hard"], mae_t=d["mae_t"]).validate()


def eval_table_int(table: PPATable, x_int: np.ndarray) -> np.ndarray:
    """Golden numpy evaluation of a table on integer inputs (int64)."""
    x = np.asarray(x_int, dtype=np.int64)
    idx = np.searchsorted(table.starts_int, x, side="right") - 1
    idx = np.clip(idx, 0, table.num_segments - 1)
    sel = [table.a_int[idx, i] for i in range(table.order)]
    sel.append(table.b_int[idx])
    return horner_body(DatapathPlan.from_config(table.cfg), sel, x)
