"""The kernels' bounds (``repro_torch.roofline.bounds``, which
``chip_smoke.py`` times the kernels against and the kernel wrappers report
their work to an ``OpCosts`` counter with) count what the function needs.

A bound is the least time the card could take for a kernel's work: the
larger of its bytes over the memory rate and its operations over the rate
of their type.  The select is charged the least any select needs (one
index computation and one load), so a bound does not move with the table's
segment count or with the select a kernel implements; only the table's own
bytes grow with it.  The hand counts below are those PERF.md states for the
shapes the served model launches the kernels at.
"""

import pytest

pytest.importorskip("torch")

from repro_torch.roofline import bounds  # noqa: E402
from repro_torch.tables import load_table  # noqa: E402


@pytest.fixture(scope="module")
def cs():
    return bounds


def _bounds(cs):
    """kernel -> bound(n, num_segments, order, round_mults) at the main
    path's element sizes: int32, bf16, float32 scores with a mask of 1/16
    of their count (Hk * G = 16)."""
    return {
        "ppa_int": lambda n, s, o, r: cs.int_bound(n, s, o, r),
        "ppa_fused": lambda n, s, o, r: cs.fused_bound(n, 2, s, o, r),
        "softmax_ppa": lambda n, s, o, r: cs.softmax_bound(n, n // 16, s, o,
                                                           r),
        "softmax_ppa_bwd": lambda n, s, o, r: cs.softmax_bwd_bound(
            n, n // 16, s, o, r),
    }


def test_datapath_ops_is_the_hand_count(cs):
    # select 2 (index, load) + 2 per stage (multiply, shift) + 3 per concat
    # adder (two aligning shifts, add) + 4 at the intercept (two shifts, add,
    # final shift) + 1 per stage with round_mults
    assert cs.datapath_ops(1, False) == 2 + 2 + 0 + 4
    assert cs.datapath_ops(2, False) == 2 + 4 + 3 + 4 == 13
    assert cs.datapath_ops(2, True) == 15
    assert cs.datapath_ops(4, False) == 2 + 8 + 9 + 4


@pytest.mark.parametrize("kernel", ["ppa_int", "ppa_fused", "softmax_ppa",
                                    "softmax_ppa_bwd"])
@pytest.mark.parametrize("n", [32_768, 1_048_576, 4_194_304])
@pytest.mark.parametrize("order", [1, 2])
def test_bound_does_not_move_with_the_segment_count(cs, kernel, n, order):
    """Only the table's bytes grow with the segment count: 14 and 461
    segments differ by at most those bytes over the memory rate, and the
    operations' time is the same."""
    fn = _bounds(cs)[kernel]
    few_ms, few_by = fn(n, 14, order, False)
    many_ms, many_by = fn(n, 461, order, False)
    table_ms = ((cs.table_bytes(461, order) - cs.table_bytes(14, order))
                / cs.HBM_BYTES_PER_S * 1e3)
    assert 0.0 <= many_ms - few_ms <= table_ms * (1 + 1e-12)
    if few_by == many_by == "operations":
        assert many_ms == few_ms


def test_fused_bound_by_hand_for_sigmoid_wide_16(cs):
    tab = load_table("sigmoid_wide", 16)
    assert (tab.num_segments, tab.order) == (461, 2)
    table = 461 * 4 * 4           # starts + 3 coefficients, int32
    for n in (512 * 8192, 4 * 1 * 8192):
        nbytes = 4 * n + table    # 2 B in, 2 B out (bf16)
        int_ops = (13 + 7) * n    # datapath + conditioning
        t_bytes = nbytes / 3.35e12 * 1e3
        t_ops = max(int_ops / 16.75e12, (int_ops + 12 * n) / 33.5e12) * 1e3
        got = cs.fused_bound(n, 2, tab.num_segments, tab.order, False)
        assert got == (pytest.approx(max(t_bytes, t_ops), rel=1e-12),
                       "bytes" if t_bytes >= t_ops else "operations")
    # the PERF.md figures: bytes set both, by a hair at prefill
    assert cs.fused_bound(512 * 8192, 2, 461, 2, False) == (
        pytest.approx(16_784_592 / 3.35e9), "bytes")
    assert cs.fused_bound(32_768, 2, 461, 2, False) == (
        pytest.approx(138_448 / 3.35e9), "bytes")


def test_int_bound_by_hand_for_sigmoid_wide_16(cs):
    for n in (512 * 8192, 4 * 1 * 8192):
        assert cs.int_bound(n, 461, 2, False) == (
            pytest.approx((8 * n + 461 * 16) / 3.35e9), "bytes")
    # the PERF.md figures, prefill and decode
    assert cs.int_bound(512 * 8192, 461, 2, False)[0] == pytest.approx(
        33_561_808 / 3.35e9)
    assert cs.int_bound(32_768, 461, 2, False)[0] == pytest.approx(
        269_520 / 3.35e9)


def test_softmax_bound_by_hand_for_exp2_frac_16(cs):
    tab = load_table("exp2_frac", 16)
    assert (tab.num_segments, tab.order) == (14, 2)
    table = 14 * 4 * 4
    for shape in ((4, 8, 2, 128, 128), (4, 8, 2, 1, 512)):
        b, hk, g, t, s = shape
        n = b * hk * g * t * s
        mask = b * t * s          # (B, 1, 1, T, S) bool, unexpanded
        t_bytes = (8 * n + mask + table) / 3.35e12 * 1e3
        t_ops = max((13 + 3) * n / 16.75e12, 15 * n / 33.5e12,
                    (16 + 15) * n / 33.5e12) * 1e3
        assert t_bytes > t_ops
        got = cs.softmax_bound(n, mask, tab.num_segments, tab.order, False)
        assert got == (pytest.approx(t_bytes, rel=1e-12), "bytes")
    assert cs.softmax_bound(1_048_576, 65_536, 14, 2, False) == (
        pytest.approx(8_454_368 / 3.35e9), "bytes")
    assert cs.softmax_bound(32_768, 2_048, 14, 2, False) == (
        pytest.approx(264_416 / 3.35e9), "bytes")


def test_softmax_bwd_bound_by_hand_for_exp2_frac_16(cs):
    """x and g read, dx written (12 B a score), the unexpanded mask and the
    table; the forward's operations plus 10 float32 a score: bytes bound
    it at the training shape and at decode."""
    table = 14 * 4 * 4
    for shape in ((4, 8, 2, 512, 512), (4, 8, 2, 1, 512)):
        b, hk, g, t, s = shape
        n = b * hk * g * t * s
        mask = b * t * s
        t_bytes = (12 * n + mask + table) / 3.35e12 * 1e3
        t_ops = max((13 + 3) * n / 16.75e12, 25 * n / 33.5e12,
                    (16 + 25) * n / 33.5e12) * 1e3
        assert t_bytes > t_ops
        got = cs.softmax_bwd_bound(n, mask, 14, 2, False)
        assert got == (pytest.approx(t_bytes, rel=1e-12), "bytes")
    # the PERF.md figures, training and decode
    assert cs.softmax_bwd_bound(16_777_216, 1_048_576, 14, 2, False) == (
        pytest.approx(202_375_392 / 3.35e9), "bytes")
    assert cs.softmax_bwd_bound(32_768, 2_048, 14, 2, False) == (
        pytest.approx(395_488 / 3.35e9), "bytes")


def test_fused_bound_float32_without_gate_for_exp_neg_16(cs):
    """Flash attention's exponentials: float32 in and out (4 B each way),
    no gate product and no widening or narrowing, so 9 float32 operations
    an element beside the 13 + 7 int32 ones; the bytes bound both of its
    shapes (the PERF.md figures)."""
    tab = load_table("exp_neg", 16)
    assert (tab.num_segments, tab.order) == (468, 2)
    table = 468 * 4 * 4
    for shape in ((1, 8, 2, 16384, 1024), (1, 8, 2, 16384)):
        n = 1
        for d in shape:
            n *= d
        t_bytes = (8 * n + table) / 3.35e12 * 1e3
        t_ops = max(20 * n / 16.75e12, (20 + 9) * n / 33.5e12) * 1e3
        assert t_bytes > t_ops
        got = cs.fused_bound(n, 4, 468, 2, False, gate=False)
        assert got == (pytest.approx(t_bytes, rel=1e-12), "bytes")
    assert cs.fused_bound(268_435_456, 4, 468, 2, False, gate=False) == (
        pytest.approx(2_147_491_136 / 3.35e9), "bytes")
    assert cs.fused_bound(262_144, 4, 468, 2, False, gate=False) == (
        pytest.approx(2_104_640 / 3.35e9), "bytes")


@pytest.mark.parametrize("itemsize,gate,fp_ops", [
    (2, True, 12), (2, False, 11), (4, True, 10), (4, False, 9)])
def test_fused_bound_counts_the_gate_and_the_casts(cs, itemsize, gate,
                                                   fp_ops, monkeypatch):
    """The float32 operations ``fused_bound`` hands ``bound``: 12 a bf16
    gated element, one fewer without the gate product, two fewer for a
    float32 input (no widening or narrowing)."""
    seen = []
    monkeypatch.setattr(cs, "bound", lambda *a: seen.append(a) or (0, ""))
    n = 1000
    cs.fused_bound(n, itemsize, 14, 2, False, gate=gate)
    assert seen == [(2 * itemsize * n + cs.table_bytes(14, 2),
                     n * (cs.datapath_ops(2, False) + cs.FUSED_INT_OPS),
                     n * fp_ops)]
