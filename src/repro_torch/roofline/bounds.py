"""The PPA kernels' work and bounds on one NVIDIA H100 SXM.

A bound is the least time the card could take for a kernel's work: the
larger of the bytes it must move (each input read once, each output
written once) over the memory rate, and its operations over the rate of
their type.  The ``*_work`` functions give (bytes, int32 operations,
float32 operations) of one launch; the ``*_bound`` functions that work's
bound.  The kernel wrappers report their work to an active ``OpCosts``
counter with these formulas (a ``ctypes`` launch is invisible to the
dispatcher), and ``chip_smoke.py`` times each kernel beside its bound;
``tests/test_torch_bounds.py`` pins them to the hand counts.

Published H100 SXM peaks at 700 W: device memory bandwidth, and the
float32 rate outside the tensor cores, 67 TFLOP/s with an FMA counted as
two.  These kernels issue no FMA, so one float32 operation is one lane
instruction: 128 float32 lanes per SM per clock give 33.5 T op/s, which
is also the rate at which the four schedulers of an SM issue lane
instructions of any kind.  An SM has 64 int32 lanes, half the float32
ones: 16.75 T op/s.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["HBM_BYTES_PER_S", "FP32_OPS_PER_S", "INT32_OPS_PER_S",
           "ISSUE_OPS_PER_S", "FUSED_INT_OPS", "FUSED_FP_OPS",
           "SOFTMAX_INT_OPS", "SOFTMAX_FP_OPS", "SOFTMAX_BWD_FP_OPS",
           "bound", "datapath_ops", "table_bytes", "int_work", "int_bound",
           "fused_work", "fused_bound", "softmax_work", "softmax_bound",
           "softmax_bwd_work", "softmax_bwd_bound"]

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
ISSUE_OPS_PER_S = FP32_OPS_PER_S

Work = Tuple[float, float, float]


def datapath_ops(order: int, round_mults: bool) -> int:
    """int32 operations of select + Horner for one element: the least any
    select needs (one index computation and one load), then the Horner
    chain (multiply and shift per stage, two aligning shifts and an add per
    concat adder and at the intercept, the final shift, a rounder add per
    stage).  The segment count and the select algorithm do not enter: a
    shorter search must not lower its own bound."""
    return (2 + 2 * order + 3 * (order - 1) + 4
            + (order if round_mults else 0))


# Per element, around select + Horner.  fused: int32 sign fix (2), the
# out-of-interval compare (1), clamp (2), saturation and symmetry selects
# (2); float32 widen, abs, scale, +0.5, floor, to-int, to-float, /2^w_out,
# sign compare, symmetry restore, gate product, narrow (12).  softmax:
# int32 mask test (1) and clamp (2); float32 max, -m, *log2e, clamp, floor,
# -k, scale, +0.5, floor, to-int, to-float, /2^w_out, ldexp, sum, /sum (15).
FUSED_INT_OPS, FUSED_FP_OPS = 7, 12
SOFTMAX_INT_OPS, SOFTMAX_FP_OPS = 3, 15
# The softmax backward does the forward's work, then per score: g y, its
# sum, the live test, g - c, / D, exp2, the product, the sum of d, the tie
# test and the share's subtraction (10 float32).
SOFTMAX_BWD_FP_OPS = SOFTMAX_FP_OPS + 10


def bound(nbytes: float, int_ops: float, fp_ops: float = 0.0):
    """Least time (ms) for the work, and whether bytes or operations set
    it: the int32 lanes, the float32 lanes and the issue rate each bound
    the operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(int_ops / INT32_OPS_PER_S, fp_ops / FP32_OPS_PER_S,
                (int_ops + fp_ops) / ISSUE_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def table_bytes(num_segments: int, order: int) -> int:
    """The table's starts and coefficient rows, int32."""
    return 4 * num_segments * (order + 2)


def int_work(n: int, num_segments: int, order: int,
             round_mults: bool) -> Work:
    """ppa_int on n int32 elements: 4 B in and 4 B out each."""
    return (8 * n + table_bytes(num_segments, order),
            n * datapath_ops(order, round_mults), 0)


def int_bound(n: int, num_segments: int, order: int, round_mults: bool):
    return bound(*int_work(n, num_segments, order, round_mults))


def fused_work(n: int, itemsize: int, num_segments: int, order: int,
               round_mults: bool, gate: bool = True) -> Work:
    """ppa_fused on n elements of ``itemsize`` bytes, read and written.
    Without the gate there is no gate product, and a float32 input needs
    no widening or narrowing: 12, 11, 10 or 9 float32 operations."""
    fp_ops = FUSED_FP_OPS - (not gate) - 2 * (itemsize == 4)
    return (2 * itemsize * n + table_bytes(num_segments, order),
            n * (datapath_ops(order, round_mults) + FUSED_INT_OPS),
            n * fp_ops)


def fused_bound(n: int, itemsize: int, num_segments: int, order: int,
                round_mults: bool, gate: bool = True):
    return bound(*fused_work(n, itemsize, num_segments, order, round_mults,
                             gate))


def softmax_work(n: int, mask_bytes: int, num_segments: int, order: int,
                 round_mults: bool) -> Work:
    """softmax_ppa on n float32 scores, read and written, and the mask at
    its unexpanded size."""
    return (8 * n + mask_bytes + table_bytes(num_segments, order),
            n * (datapath_ops(order, round_mults) + SOFTMAX_INT_OPS),
            n * SOFTMAX_FP_OPS)


def softmax_bound(n: int, mask_bytes: int, num_segments: int, order: int,
                  round_mults: bool):
    return bound(*softmax_work(n, mask_bytes, num_segments, order,
                               round_mults))


def softmax_bwd_work(n: int, mask_bytes: int, num_segments: int,
                     order: int, round_mults: bool) -> Work:
    """The softmax backward on n float32 scores: x and g read and dx
    written, the mask at its unexpanded size."""
    return (12 * n + mask_bytes + table_bytes(num_segments, order),
            n * (datapath_ops(order, round_mults) + SOFTMAX_INT_OPS),
            n * SOFTMAX_BWD_FP_OPS)


def softmax_bwd_bound(n: int, mask_bytes: int, num_segments: int,
                      order: int, round_mults: bool):
    return bound(*softmax_bwd_work(n, mask_bytes, num_segments, order,
                                   round_mults))
