"""The FQA-On fixed-point Horner datapath: word lengths, the shift plan and
the one integer Horner chain.

A copy of the JAX package's ``core/datapath.py`` (``FWLConfig``,
``DatapathPlan``, ``apply_shift``, ``horner_body``, ``horner_fixed``,
``concat_add``).  The chain uses only ``* + >> <<``, so the same code runs
on numpy int64 (the golden model, the compiler's candidate scan and the
pack-time overflow guard), on torch int32 tensors (the plain version of
the kernels), on torch int64 tensors (the search backend on the card) and
on the certifier's intervals; ``>>`` on signed integers is the arithmetic
shift in all of them.
``ppa_body.cuh`` is the CUDA transcription; parity tests hold them equal.

    h1 = trunc(a1 * x)                      -> FWL w_o[0]
    g1 = h1 (+) a2        concat adder      -> FWL max(w_o[0], w_a[1])
    h2 = trunc(g1 * x)                      -> FWL w_o[1]
    ...
    out = hn (+) b                          -> FWL max(w_o[n-1], w_b) -> w_out
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from .fixed_point import trunc_shift

__all__ = ["FWLConfig", "DatapathPlan", "apply_shift", "horner_body",
           "horner_fixed", "concat_add"]


@dataclasses.dataclass(frozen=True)
class FWLConfig:
    """Fractional word lengths for an order-n datapath.

    w_in:  FWL of the (integer) input x_q.
    w_out: FWL of the final output.
    w_a:   FWLs of the Horner coefficients a_1..a_n.
    w_o:   FWLs of multiplier outputs 1..n.
    w_b:   FWL of the intercept b.
    round_mults: add a half ULP before every multiplier-output truncation
      (the final ``down_out`` shift stays a plain floor).
    """

    w_in: int
    w_out: int
    w_a: Tuple[int, ...]
    w_o: Tuple[int, ...]
    w_b: int
    round_mults: bool = False

    def __post_init__(self):
        if len(self.w_a) != len(self.w_o):
            raise ValueError("w_a and w_o must have the same length (order n)")
        if not self.w_a:
            raise ValueError("order-0 datapath is just the intercept; n >= 1")

    @property
    def order(self) -> int:
        return len(self.w_a)

    def d_bits(self, i: int) -> int:
        """FQA offset-space width k_i for stage i (0-based): the low k_i
        fractional bits of a_i act on the output only through the
        truncation at multiplier i (paper Eq. 4/5)."""
        return max(0, self.w_a[i] + self.w_in - self.w_o[i])

    def replace(self, **kw) -> "FWLConfig":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DatapathPlan:
    """Every shift/alignment constant of the decoupled-FWL Horner datapath,
    derived once from an :class:`FWLConfig`.

    Shift sign convention matches :func:`apply_shift`: positive = arithmetic
    right shift (truncation), negative = exact left shift.  ``up_*`` are
    the non-negative left-shift amounts of the concat-adder alignments.

      mult_shifts[i] : truncation at multiplier i output  (-> FWL w_o[i])
      up_g[i-1]      : align h_i before the concat add with a_{i+1}
      up_a[i-1]      : align a_{i+1} at the same adder
      up_h / up_b    : align h_n and b at the final intercept add
      down_out       : final rescale to w_out (plain truncation)
      w_pre_b        : FWL of h_n
    """

    order: int
    w_in: int
    w_out: int
    round_mults: bool
    mult_shifts: Tuple[int, ...]
    up_g: Tuple[int, ...]
    up_a: Tuple[int, ...]
    up_h: int
    up_b: int
    down_out: int
    w_pre_b: int

    @classmethod
    def from_config(cls, cfg: FWLConfig) -> "DatapathPlan":
        n = cfg.order
        mult_shifts = [cfg.w_a[0] + cfg.w_in - cfg.w_o[0]]
        up_g, up_a = [], []
        cur = cfg.w_o[0]
        for i in range(1, n):
            wg = max(cur, cfg.w_a[i])
            up_g.append(wg - cur)
            up_a.append(wg - cfg.w_a[i])
            mult_shifts.append(wg + cfg.w_in - cfg.w_o[i])
            cur = cfg.w_o[i]
        w_sum = max(cur, cfg.w_b)
        return cls(order=n, w_in=cfg.w_in, w_out=cfg.w_out,
                   round_mults=cfg.round_mults,
                   mult_shifts=tuple(mult_shifts), up_g=tuple(up_g),
                   up_a=tuple(up_a), up_h=w_sum - cur, up_b=w_sum - cfg.w_b,
                   down_out=w_sum - cfg.w_out, w_pre_b=cur)


def apply_shift(v, sh: int):
    """``sh > 0`` truncates (arithmetic right shift, two's-complement
    floor), ``sh < 0`` is an exact left shift."""
    if sh > 0:
        return v >> sh
    if sh < 0:
        return v << (-sh)
    return v


def horner_body(plan: DatapathPlan, sel: Sequence, x, *,
                return_pre_b: bool = False, tap=None):
    """The fixed-point Horner chain.

    Args:
      plan: the precomputed shift constants.
      sel: ``order + 1`` coefficient arrays (a_1..a_n then b), already
        selected per element of ``x``.
      x: integer input array at FWL ``plan.w_in``.
      return_pre_b: also return ``(h_n, plan.w_pre_b)``, the value before
        the intercept add, which the quantizer's error flattening reads.
      tap: optional ``tap(name, value)`` callback observing every named
        intermediate: ``p{i}`` (multiplier output entering its truncation
        shift, rounder addend included), ``h{i}``, ``g{i}``, ``sum`` and
        ``out``.  The pack-time int32 guard runs the chain in int64 through
        this hook, and the certifier runs it on intervals.
    """
    if len(sel) != plan.order + 1:
        raise ValueError(
            f"expected {plan.order + 1} coefficient arrays, got {len(sel)}")

    def trunc_mult(v, sh, name):
        if plan.round_mults and sh > 0:
            v = v + (1 << (sh - 1))
        if tap is not None:
            tap(name, v)
        return apply_shift(v, sh)

    h = trunc_mult(sel[0] * x, plan.mult_shifts[0], "p1")
    if tap is not None:
        tap("h1", h)
    for i in range(1, plan.order):
        g = apply_shift(h, -plan.up_g[i - 1]) \
            + apply_shift(sel[i], -plan.up_a[i - 1])
        if tap is not None:
            tap(f"g{i}", g)
        h = trunc_mult(g * x, plan.mult_shifts[i], f"p{i + 1}")
        if tap is not None:
            tap(f"h{i + 1}", h)
    out = apply_shift(h, -plan.up_h) + apply_shift(sel[plan.order],
                                                   -plan.up_b)
    if tap is not None:
        tap("sum", out)
    out = apply_shift(out, plan.down_out)
    if tap is not None:
        tap("out", out)
    if return_pre_b:
        return out, (h, plan.w_pre_b)
    return out


def concat_add(u, w_u: int, v, w_v: int):
    """Concatenation adder: exact add of fixed(u, w_u) + fixed(v, w_v).

    Returns (sum_int, w_sum) with w_sum = max(w_u, w_v); the narrow adder
    plus bit stitch of paper Fig. 3 computes exactly this value.
    """
    w = max(w_u, w_v)
    return trunc_shift(u, w_u - w) + trunc_shift(v, w_v - w), w


def horner_fixed(a_int: Sequence[np.ndarray], b_int: np.ndarray,
                 x_int: np.ndarray, cfg: FWLConfig, *,
                 return_pre_b: bool = False, tap=None):
    """Evaluate the order-n fixed-point Horner datapath on numpy arrays.

    ``a_int[i]`` (FWL ``cfg.w_a[i]``) and ``b_int`` (FWL ``cfg.w_b``)
    broadcast against each other and against the trailing grid axis of
    ``x_int`` (FWL ``cfg.w_in``, shape (..., G)).  Returns the output at
    FWL ``cfg.w_out`` (plus the pre-intercept tuple with
    ``return_pre_b``).
    """
    n = cfg.order
    if len(a_int) != n:
        raise ValueError(f"expected {n} coefficient arrays, got {len(a_int)}")
    x = np.asarray(x_int)
    sel = [np.asarray(a)[..., None] for a in a_int]
    sel.append(np.asarray(b_int)[..., None])
    return horner_body(DatapathPlan.from_config(cfg), sel, x,
                       return_pre_b=return_pre_b, tap=tap)
