"""The NAF zoo: float64 numpy targets for the compiler, range-reduction
metadata, and exact torch functions for the deployment NAFs.

A copy of the JAX package's ``core/functions.py``.  Every ``NAFSpec``
carries its float64 numpy callable (``spec(x)``), the function the
compiler fits and scores against: the targets stay numpy on the host, so
they are the same bits in both packages (CUDA's and torch's ``exp`` and
``erf`` are not glibc's bit for bit).  The metadata (interval, symmetry,
saturation) drives the float conditioning around the datapath.

:func:`exact` is the float32 torch function of the six deployment NAFs:
the ``exact`` activation bundle runs it, and the straight-through
backward of the PPA ops differentiates it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["NAFSpec", "NAF_REGISTRY", "get_naf", "exact"]


@dataclasses.dataclass(frozen=True)
class NAFSpec:
    """Metadata for one scalar nonlinearity.

    fn: float64 elementwise numpy callable.
    interval: canonical (xs, xe) fitting interval (end-exclusive).
    symmetry: None | "odd" | "sigmoid" | "minus_x" — how f(-x) maps to f(x):
      odd:      f(-x) = -f(x)
      sigmoid:  f(-x) = 1 - f(x)
      minus_x:  f(-x) = f(x) - x
    sat_hi: constant the float path returns at and above the interval end.
    sat_identity: return x itself at and above the interval end.
    out_range: (min, max) of f over the interval.
    """

    name: str
    fn: Callable[[np.ndarray], np.ndarray]
    interval: Tuple[float, float]
    symmetry: Optional[str] = None
    sat_hi: Optional[float] = None
    sat_identity: bool = False
    out_range: Tuple[float, float] = (0.0, 1.0)
    doc: str = ""

    def __call__(self, x):
        return self.fn(np.asarray(x, dtype=np.float64))


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _tanh(x):
    return np.tanh(x)


def _exp2(x):
    return np.exp2(x)


def _exp_neg(x):
    return np.exp(-x)


def _gelu_inner(x):
    # Phi(x) = 0.5*(1+erf(x/sqrt2)); gelu(x) = x * Phi(x)
    return 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))


def _softplus(x):
    return np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0.0)


def _silu(x):
    return x * _sigmoid(x)


def _recip(x):
    return 1.0 / x


def _rsqrt(x):
    return 1.0 / np.sqrt(x)


def _log2(x):
    return np.log2(x)


NAF_REGISTRY: Dict[str, NAFSpec] = {s.name: s for s in (
    # the paper's targets
    NAFSpec("sigmoid", _sigmoid, (0.0, 1.0), symmetry="sigmoid",
            out_range=(0.5, 0.7311), doc="paper Table I/II target, [0,1)"),
    NAFSpec("tanh", _tanh, (0.0, 1.0), symmetry="odd",
            out_range=(0.0, 0.7616), doc="paper Table II target, [0,1)"),
    # the wide-domain variants the models deploy
    NAFSpec("sigmoid_wide", _sigmoid, (0.0, 8.0), symmetry="sigmoid",
            sat_hi=1.0, out_range=(0.5, 1.0),
            doc="sigmoid on [0,8) + symmetry + saturation: SiLU gates"),
    NAFSpec("tanh_wide", _tanh, (0.0, 4.0), symmetry="odd",
            sat_hi=1.0, out_range=(0.0, 1.0), doc="tanh on [0,4)"),
    NAFSpec("exp2_frac", _exp2, (0.0, 1.0), out_range=(1.0, 2.0),
            doc="2**x on [0,1): softmax exp via 2^(x log2 e) = 2^k * 2^frac"),
    NAFSpec("exp_neg", _exp_neg, (0.0, 16.0), sat_hi=0.0,
            out_range=(0.0, 1.0), doc="e^-x on [0,16): SSM/RWKV decays"),
    NAFSpec("gelu_inner", _gelu_inner, (0.0, 4.0), symmetry="sigmoid",
            sat_hi=1.0, out_range=(0.5, 1.0),
            doc="Phi(x); gelu(x) = x * Phi(x), whisper/ViT MLPs"),
    NAFSpec("softplus", _softplus, (0.0, 8.0), symmetry="minus_x",
            sat_identity=True, out_range=(0.0, 8.01),
            doc="softplus on [0,8): mamba delta"),
    NAFSpec("silu", _silu, (0.0, 8.0), symmetry="minus_x",
            sat_identity=True, out_range=(-0.28, 8.0),
            doc="direct silu fit (ablation vs x*sigmoid)"),
    NAFSpec("recip", _recip, (1.0, 2.0), out_range=(0.5, 1.0),
            doc="1/x on [1,2): softmax denominator"),
    NAFSpec("rsqrt", _rsqrt, (1.0, 4.0), out_range=(0.5, 1.0),
            doc="1/sqrt(x) on [1,4): rmsnorm (optional)"),
    NAFSpec("log2", _log2, (1.0, 2.0), out_range=(0.0, 1.0),
            doc="log2 mantissa on [1,2)"),
)}


def get_naf(name: str) -> NAFSpec:
    try:
        return NAF_REGISTRY[name]
    except KeyError as e:
        raise KeyError(
            f"unknown NAF {name!r}; available: {sorted(NAF_REGISTRY)}") from e


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
