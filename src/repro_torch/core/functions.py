"""The deployment NAFs: range-reduction metadata and exact torch functions.

``NAFSpec`` carries what the float conditioning around the datapath needs
(interval, symmetry, saturation), for the six NAFs a served model's tables
cover.  :func:`exact` is the float32 function itself: the ``exact``
activation bundle runs it, and the straight-through backward of the PPA ops
differentiates it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["NAFSpec", "NAF_SPECS", "get_naf", "exact"]


@dataclasses.dataclass(frozen=True)
class NAFSpec:
    """Metadata for one scalar nonlinearity.

    symmetry: None | "odd" | "sigmoid" | "minus_x" — how f(-x) maps to f(x):
      odd:      f(-x) = -f(x)
      sigmoid:  f(-x) = 1 - f(x)
      minus_x:  f(-x) = f(x) - x
    sat_hi: constant the float path returns at and above the interval end.
    sat_identity: return x itself at and above the interval end.
    """

    name: str
    interval: Tuple[float, float]
    symmetry: Optional[str] = None
    sat_hi: Optional[float] = None
    sat_identity: bool = False


NAF_SPECS: Dict[str, NAFSpec] = {s.name: s for s in (
    NAFSpec("sigmoid_wide", (0.0, 8.0), symmetry="sigmoid", sat_hi=1.0),
    NAFSpec("tanh_wide", (0.0, 4.0), symmetry="odd", sat_hi=1.0),
    NAFSpec("gelu_inner", (0.0, 4.0), symmetry="sigmoid", sat_hi=1.0),
    NAFSpec("softplus", (0.0, 8.0), symmetry="minus_x", sat_identity=True),
    NAFSpec("exp_neg", (0.0, 16.0), sat_hi=0.0),
    NAFSpec("exp2_frac", (0.0, 1.0)),
)}


def get_naf(name: str) -> NAFSpec:
    try:
        return NAF_SPECS[name]
    except KeyError as e:
        raise KeyError(
            f"unknown NAF {name!r}; available: {sorted(NAF_SPECS)}") from e


#: sqrt(2) rounded to float32 first, as the reference divides by it
_SQRT2 = float(np.float32(math.sqrt(2.0)))


def exact(naf: str, x: torch.Tensor) -> torch.Tensor:
    """float32 exact evaluation of a deployment NAF."""
    if naf == "sigmoid_wide":
        return torch.sigmoid(x)
    if naf == "tanh_wide":
        return torch.tanh(x)
    if naf == "exp2_frac":
        return torch.exp2(x)
    if naf == "exp_neg":
        return torch.exp(-x)
    if naf == "gelu_inner":
        return 0.5 * (1.0 + torch.erf(x / _SQRT2))
    if naf == "softplus":
        return torch.logaddexp(x, torch.zeros_like(x))
    raise KeyError(naf)
