"""The FQA-On fixed-point Horner datapath: word lengths, the shift plan and
the one integer Horner chain.

A copy of ``repro.core.datapath`` (``FWLConfig``, ``DatapathPlan``,
``apply_shift``, ``horner_body``).  The chain uses only ``* + >> <<``, so
the same code runs on numpy int64 (the golden model and the pack-time
overflow guard) and on torch int32 tensors (the plain version of the
kernels); ``>>`` on signed integers is the arithmetic shift in both.
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

__all__ = ["FWLConfig", "DatapathPlan", "apply_shift", "horner_body"]


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


def horner_body(plan: DatapathPlan, sel: Sequence, x, *, tap=None):
    """The fixed-point Horner chain.

    Args:
      plan: the precomputed shift constants.
      sel: ``order + 1`` coefficient arrays (a_1..a_n then b), already
        selected per element of ``x``.
      x: integer input array at FWL ``plan.w_in``.
      tap: optional ``tap(name, value)`` callback observing every named
        intermediate: ``p{i}`` (multiplier output entering its truncation
        shift, rounder addend included), ``h{i}``, ``g{i}``, ``sum`` and
        ``out``.  The pack-time int32 guard runs the chain in int64 through
        this hook.
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
    return out
