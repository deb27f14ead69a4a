"""Fixed-point algebra used by every FQA component.

A copy of the JAX package's ``core/fixed_point.py``.  Conventions (kept
bit-identical across the numpy golden model, the torch plain versions and
the CUDA kernels):

* A fixed-point value with fractional word length (FWL) ``w`` is stored as a
  plain integer ``X`` representing ``X / 2**w``.  Integer bits are implicit
  (python/np.int64 carries them losslessly for every configuration in the
  paper: |values| < 2**40).
* ``truncate`` (dropping low fractional bits) is an arithmetic right shift,
  i.e. floor division by a power of two — the two's-complement hardware
  behaviour for negative numbers as well.
* ``round`` is round-half-away-from-zero (the usual hardware rounder built
  from add-half-then-truncate on the magnitude path).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "to_fixed",
    "from_fixed",
    "round_half_away",
    "trunc_shift",
    "rescale",
    "grid_for_interval",
    "hamming_weight",
    "min_signed_digits",
    "signed_bits",
]


def round_half_away(x):
    """Round-half-away-from-zero, elementwise, returns int64."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)


def to_fixed(x, fwl: int) -> np.ndarray:
    """Quantize real ``x`` to fixed point with ``fwl`` fractional bits (round)."""
    return round_half_away(np.asarray(x, dtype=np.float64) * (1 << fwl))


def from_fixed(ix, fwl: int) -> np.ndarray:
    """Dequantize integer representation back to float64."""
    return np.asarray(ix, dtype=np.float64) / (1 << fwl)


def trunc_shift(ix, shift: int):
    """Arithmetic right shift by ``shift`` (floor). ``shift`` may be <= 0."""
    ix = np.asarray(ix)
    if shift > 0:
        return ix >> shift
    if shift < 0:
        return ix << (-shift)
    return ix


def rescale(ix, fwl_from: int, fwl_to: int):
    """Change FWL by truncation (down) or exact shift-up."""
    return trunc_shift(ix, fwl_from - fwl_to)


def grid_for_interval(xs: float, xe: float, w_in: int) -> np.ndarray:
    """Integer input grid covering [xs, xe) with step 2**-w_in.

    Returns int64 array of the integer representations (FWL ``w_in``).
    The end point is exclusive, matching the paper's [0, 1) intervals.
    """
    lo = int(np.ceil(xs * (1 << w_in) - 1e-12))
    hi = int(np.ceil(xe * (1 << w_in) - 1e-12))
    return np.arange(lo, hi, dtype=np.int64)


def signed_bits(lo: int, hi: int) -> int:
    """Minimal two's-complement width holding every integer in [lo, hi].

    The width the analysis layer certifies each datapath intermediate
    against: a b-bit signed register holds [-2**(b-1), 2**(b-1) - 1].
    """
    if lo > hi:
        raise ValueError(f"empty interval [{lo}, {hi}]")
    bits = 1
    if hi > 0:
        bits = max(bits, int(hi).bit_length() + 1)
    if lo < 0:
        bits = max(bits, int(-lo - 1).bit_length() + 1)
    return bits


def hamming_weight(ix) -> np.ndarray:
    """Hamming weight of |ix| (number of set bits of the magnitude).

    The paper's FQA-Sm-On constrains ``w_H(a_1,q) <= m`` so the coefficient
    multiply can be realised with m shifters + (m-1) adders.  We use the
    magnitude's popcount; a sign is free (subtract instead of add).
    """
    v = np.abs(np.asarray(ix, dtype=np.int64))
    out = np.zeros(v.shape, dtype=np.int64)
    while np.any(v):
        out += v & 1
        v >>= 1
    return out


def min_signed_digits(ix) -> np.ndarray:
    """Minimal number of non-zero digits in canonical signed-digit (CSD) form.

    A shift-add network with m shifters realises any coefficient whose CSD
    weight is <= m (add/sub per digit).  This is the generous reading of the
    paper's hamming-weight constraint; ``hamming_weight`` is the strict one.
    We expose both — the quantizer takes a pluggable weight function.
    """
    v = np.abs(np.asarray(ix, dtype=np.int64)).ravel()
    out = np.zeros(v.shape, dtype=np.int64)
    for i, x in enumerate(v):
        n = 0
        x = int(x)
        while x:
            if x & 1:
                # choose +1 or -1 digit to maximise trailing zeros
                if (x & 3) == 3:
                    x += 1  # digit -1
                else:
                    x -= 1  # digit +1
                n += 1
            x >>= 1
        out[i] = n
    return out.reshape(np.abs(np.asarray(ix)).shape)
