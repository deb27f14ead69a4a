"""PPA schemes and the deployable table artifact: FQA-On / FQA-Sm-On ->
``PPATable``, its JSON, and its numpy golden evaluation.

A ``PPATable`` is what the FQA compiler (:mod:`repro_torch.compiler`)
produces: segment starts, the integer coefficient ROM and the word
lengths.  Its JSON is the JAX package's ``PPATable.to_json``, byte for
byte, so either package reads the other's artifacts; the shipped tables
(:mod:`repro_torch.tables`) are that JSON without ``stats``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .datapath import DatapathPlan, FWLConfig, horner_body
from .fixed_point import (grid_for_interval, hamming_weight,
                          min_signed_digits, round_half_away)
from .functions import NAFSpec, get_naf
from .quantize import Quantizer, make_quantizer

__all__ = ["PPAScheme", "PPATable", "compile_ppa_table", "eval_table_int",
           "table_mae_report"]


@dataclasses.dataclass(frozen=True)
class PPAScheme:
    """FQA-On (m_shifters=None) or FQA-Sm-On (m_shifters=m) + quantizer."""

    order: int = 1
    m_shifters: Optional[int] = None
    quantizer: str = "fqa"           # fqa | fqa_fast | qpa | plac | mlplac
    weight: str = "hamming"          # hamming | csd (Sm constraint metric)
    segmenter: str = "tbw"           # tbw | nonuniform | bisection | sequential

    @property
    def tag(self) -> str:
        base = (f"S{self.m_shifters}-O{self.order}" if self.m_shifters
                else f"O{self.order}")
        tag = f"{self.quantizer.upper()}-{base}"
        if self.segmenter == "nonuniform":
            tag += "-NU"
        return tag

    def build_quantizer(self, backend=None, lookahead: int = 0) -> Quantizer:
        """``backend`` picks the search backend (name or instance) and
        ``lookahead`` the fused speculative-scan depth; both are execution
        details, never part of the scheme's identity or serialization."""
        kw = {"lookahead": lookahead}
        if self.quantizer in ("fqa", "fqa_fast") and self.m_shifters:
            kw["weight_limit"] = self.m_shifters
            kw["weight_fn"] = (hamming_weight if self.weight == "hamming"
                               else min_signed_digits)
        if self.quantizer == "mlplac" and self.m_shifters:
            kw["m"] = self.m_shifters
        return make_quantizer(self.quantizer, backend=backend, **kw)


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
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)

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

    def unique_lut_rows(self) -> int:
        """LUT entries after coefficient sharing across segments."""
        rows = {tuple(r) for r in
                np.concatenate([self.a_int, self.b_int[:, None]], axis=1)}
        return len(rows)

    def to_json(self) -> str:
        d = {
            "naf": self.naf, "interval": list(self.interval),
            "cfg": self.cfg.as_dict(),
            "scheme": dataclasses.asdict(self.scheme),
            "starts_int": self.starts_int.tolist(),
            "a_int": self.a_int.tolist(),
            "b_int": self.b_int.tolist(),
            "mae_hard": self.mae_hard, "mae_t": self.mae_t,
            "stats": self.stats,
        }
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "PPATable":
        """Reads the compiler's JSON, and the shipped tables' (no
        ``stats``)."""
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
            mae_hard=d["mae_hard"], mae_t=d["mae_t"],
            stats=d.get("stats", {})).validate()

    def save(self, path: "str | Path") -> None:
        Path(path).write_text(self.to_json())

    @staticmethod
    def load(path: "str | Path") -> "PPATable":
        return PPATable.from_json(Path(path).read_text())


def compile_ppa_table(
    naf: "str | NAFSpec",
    cfg: FWLConfig,
    scheme: PPAScheme = PPAScheme(),
    *,
    mae_t: Optional[float] = None,
    interval: Optional[Tuple[float, float]] = None,
    tseg: Optional[int] = None,
    final_mode: str = "best",
    session=None,
    search_backend=None,
) -> PPATable:
    """Run fit -> quantize -> segment for one NAF and pack the table: a
    thin wrapper over :func:`repro_torch.compiler.compile_table`.
    ``session`` optionally shares a ``CompilerSession`` so repeated
    compiles reuse memoized window fits; ``search_backend`` (a name or a
    backend instance) is where the candidate scan runs."""
    from ..compiler import compile_table
    return compile_table(naf, cfg, scheme, mae_t=mae_t, interval=interval,
                         tseg=tseg, final_mode=final_mode, session=session,
                         search_backend=search_backend)


def eval_table_int(table: PPATable, x_int: np.ndarray) -> np.ndarray:
    """Golden numpy evaluation of a table on integer inputs (int64)."""
    x = np.asarray(x_int, dtype=np.int64)
    idx = np.searchsorted(table.starts_int, x, side="right") - 1
    idx = np.clip(idx, 0, table.num_segments - 1)
    sel = [table.a_int[idx, i] for i in range(table.order)]
    sel.append(table.b_int[idx])
    return horner_body(DatapathPlan.from_config(table.cfg), sel, x)


def table_mae_report(table: PPATable) -> Dict[str, float]:
    """Recompute MAE_hard / MAE_0 / MAE_q, the segment count and the
    shared LUT rows of a table over its input grid."""
    spec = get_naf(table.naf)
    cfg = table.cfg
    x_int = grid_for_interval(table.interval[0], table.interval[1], cfg.w_in)
    f = spec(x_int.astype(np.float64) / (1 << cfg.w_in))
    y = eval_table_int(table, x_int) / (1 << cfg.w_out)
    f_q = round_half_away(f * (1 << cfg.w_out)) / (1 << cfg.w_out)
    return {
        "mae_hard": float(np.abs(f - y).max()),
        "mae0": float(np.abs(f_q - y).max()),
        "mae_q": float(np.abs(f_q - f).max()),
        "segments": table.num_segments,
        "lut_rows": table.unique_lut_rows(),
    }
