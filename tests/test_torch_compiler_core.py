"""The compiler's numeric core in the PyTorch port against the JAX
package's, on the CPU: the fixed-point helpers on seeded random integers,
every NAF's float64 target over its grid, the Horner chain with its
pre-intercept value (numpy int64 and torch int64), and the Remez fits,
serial and batched, all bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import datapath as ref_dp  # noqa: E402
from repro.core import fixed_point as ref_fx  # noqa: E402
from repro.core import remez as ref_remez  # noqa: E402
from repro.core.functions import NAF_REGISTRY as REF_NAFS  # noqa: E402
from repro_torch.core import datapath as dp  # noqa: E402
from repro_torch.core import fixed_point as fx  # noqa: E402
from repro_torch.core import remez  # noqa: E402
from repro_torch.core.functions import NAF_REGISTRY  # noqa: E402

CFGS = [(8, 16, (8, 16), (16, 16), 16, False), (8, 8, (8,), (8,), 8, False),
        (7, 9, (8, 6, 9), (11, 7, 10), 12, True), (5, 9, (8,), (11,), 11,
                                                  True)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b) and a.tobytes() == b.tobytes()


def test_fixed_point_matches_reference():
    rng = np.random.default_rng(0)
    ints = np.concatenate([rng.integers(-(1 << 40), 1 << 40, 500),
                           rng.integers(-300, 300, 500), [0, 1, -1]])
    reals = np.concatenate([rng.normal(0, 3, 500), [0.5, -0.5, 1.5, -2.5,
                                                     0.0, -0.0]])
    _same(fx.round_half_away(reals * 64), ref_fx.round_half_away(reals * 64))
    for w in (0, 5, 16):
        _same(fx.to_fixed(reals, w), ref_fx.to_fixed(reals, w))
        _same(fx.from_fixed(ints, w), ref_fx.from_fixed(ints, w))
    for sh in (-3, 0, 1, 7, 20):
        _same(fx.trunc_shift(ints, sh), ref_fx.trunc_shift(ints, sh))
        _same(fx.rescale(ints, 10, 10 - sh), ref_fx.rescale(ints, 10, 10 - sh))
    small = rng.integers(-(1 << 20), 1 << 20, 300)
    _same(fx.hamming_weight(small), ref_fx.hamming_weight(small))
    _same(fx.min_signed_digits(small), ref_fx.min_signed_digits(small))
    for lo, hi in rng.integers(-(1 << 33), 1 << 33, (50, 2)):
        lo, hi = int(min(lo, hi)), int(max(lo, hi))
        assert fx.signed_bits(lo, hi) == ref_fx.signed_bits(lo, hi)
    for xs, xe, w in ((0.0, 8.0, 8), (1.0, 2.0, 7), (-0.3, 0.71, 10)):
        _same(fx.grid_for_interval(xs, xe, w),
              ref_fx.grid_for_interval(xs, xe, w))


@pytest.mark.parametrize("name", sorted(REF_NAFS))
def test_naf_zoo_matches_reference(name):
    """Same metadata, and the float64 target bit-equal over the grid at
    two input word lengths."""
    ours, ref = NAF_REGISTRY[name], REF_NAFS[name]
    for k in ("name", "interval", "symmetry", "sat_hi", "sat_identity",
              "out_range"):
        assert getattr(ours, k) == getattr(ref, k), k
    for w in (8, 11):
        x = ref_fx.grid_for_interval(*ref.interval, w).astype(np.float64) \
            / (1 << w)
        _same(ours(x), ref(x))
    assert sorted(NAF_REGISTRY) == sorted(REF_NAFS)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: f"o{len(c[2])}")
def test_horner_body_pre_b_matches_reference(cfg):
    """``horner_body(..., return_pre_b=True)`` on numpy int64 and torch
    int64 operands, and ``horner_fixed``, equal the reference's chain."""
    ours_cfg, ref_cfg = dp.FWLConfig(*cfg), ref_dp.FWLConfig(*cfg)
    plan, ref_plan = (dp.DatapathPlan.from_config(ours_cfg),
                      ref_dp.DatapathPlan.from_config(ref_cfg))
    assert [ours_cfg.d_bits(i) for i in range(ours_cfg.order)] == \
        [ref_cfg.d_bits(i) for i in range(ref_cfg.order)]
    rng = np.random.default_rng(len(cfg[2]))
    n = ours_cfg.order
    sel = [rng.integers(-(1 << 12), 1 << 12, (64, 1)) for _ in range(n + 1)]
    x = rng.integers(-(1 << cfg[0]), 1 << (cfg[0] + 2), 97)
    want, (h, w) = ref_dp.horner_body(ref_plan, sel, x, return_pre_b=True)
    got, (gh, gw) = dp.horner_body(plan, sel, x, return_pre_b=True)
    _same(got, want)
    _same(gh, h)
    assert gw == w
    tout, (th, tw) = dp.horner_body(
        plan, [torch.from_numpy(s) for s in sel], torch.from_numpy(x),
        return_pre_b=True)
    assert tout.dtype == torch.int64
    _same(tout.numpy(), want)
    _same(th.numpy(), h)
    a = [s[:, 0] for s in sel[:n]]
    _same(dp.horner_fixed(a, sel[n][:, 0], x, ours_cfg),
          ref_dp.horner_fixed(a, sel[n][:, 0], x, ref_cfg))
    _same(dp.concat_add(x, 5, x[::-1], 9)[0],
          ref_dp.concat_add(x, 5, x[::-1], 9)[0])


def _windows(name, w_in, rng, n):
    spec = REF_NAFS[name]
    x_int = ref_fx.grid_for_interval(*spec.interval, w_in)
    x = x_int.astype(np.float64) / (1 << w_in)
    f = spec(x)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, x.size - 1))
        e = int(rng.integers(s, min(x.size, s + 90)))
        out.append((x[s:e + 1], f[s:e + 1]))
    return out


@pytest.mark.parametrize("name", sorted(REF_NAFS))
def test_fit_minimax_matches_reference(name):
    """``fit_minimax`` and ``fit_minimax_batch`` bit-equal to the
    reference's, degenerate windows (1-3 points) included."""
    rng = np.random.default_rng(sum(map(ord, name)))
    wins = _windows(name, 8, rng, 12)
    wins += [(x[:1], f[:1]) for x, f in wins[:1]]
    wins += [(x[:3], f[:3]) for x, f in wins[1:2]]
    for degree in (1, 2):
        got = remez.fit_minimax_batch(wins, degree)
        want = ref_remez.fit_minimax_batch(wins, degree)
        for (gc, gb), (wc, wb), (x, f) in zip(got, want, wins):
            _same(gc, wc)
            assert gb == wb
            sc, sb = remez.fit_minimax(x, f, degree)
            rc, rb = ref_remez.fit_minimax(x, f, degree)
            _same(sc, rc)
            assert sb == rb
