"""The port's cost model and FWL shrink flow against the JAX package's, on
the CPU.

* ``cost_features``, ``calibrate`` and ``estimate_cost`` equal the
  reference's exactly: on every shipped table (with and without its
  bit-width certificate) and on the paper's Table VI/VII rows;
* ``optimize_fwls`` gives the reference's winning config, segment count,
  history and final table, on the numpy backend and on the torch backend
  on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.analysis.certify as ref_certify  # noqa: E402
import repro.core as RK  # noqa: E402
import repro.core.hwcost as ref_hwcost  # noqa: E402
from repro.compiler import CompilerSession as RefSession  # noqa: E402
from repro_torch.analysis import certify  # noqa: E402
from repro_torch.compiler import CompilerSession  # noqa: E402
from repro_torch.core import (PPAScheme, TorchSearchBackend,  # noqa: E402
                              hwcost, optimize_fwls)
from repro_torch.tables import load_table, table_path  # noqa: E402

SHIPPED = [(naf, bits) for bits in (16, 8)
           for naf in ("exp2_frac", "exp_neg", "gelu_inner", "sigmoid_wide",
                       "softplus", "tanh_wide")]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _ref_table(naf, bits):
    d = json.loads(table_path(naf, bits).read_text())
    return RK.PPATable.from_json(json.dumps({**d, "stats": {}}))


def test_paper_rows_are_the_reference_rows():
    assert hwcost.PAPER_TABLE6 == ref_hwcost.PAPER_TABLE6
    assert hwcost.PAPER_TABLE7 == ref_hwcost.PAPER_TABLE7
    for row in hwcost.PAPER_TABLE6 + hwcost.PAPER_TABLE7:
        np.testing.assert_array_equal(hwcost._features_from_row(row),
                                      ref_hwcost._features_from_row(row))


def test_calibrate_equals_reference():
    ours, ref = hwcost.calibrate(), ref_hwcost.calibrate()
    assert sorted(ours) == sorted(ref) == ["area", "delay", "power"]
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], k)


@pytest.mark.parametrize("with_cert", [False, True])
@pytest.mark.parametrize("naf,bits", SHIPPED)
def test_cost_equals_reference_on_shipped_tables(naf, bits, with_cert):
    tab, rtab = load_table(naf, bits), _ref_table(naf, bits)
    cert = certify.certify_table(tab) if with_cert else None
    rcert = ref_certify.certify_table(rtab) if with_cert else None
    np.testing.assert_array_equal(hwcost.cost_features(tab, cert),
                                  ref_hwcost.cost_features(rtab, rcert))
    assert hwcost.breakpoint_rom_bits(tab) == \
        ref_hwcost.breakpoint_rom_bits(rtab)
    got = dataclasses.asdict(hwcost.estimate_cost(tab, cert))
    want = dataclasses.asdict(ref_hwcost.estimate_cost(rtab, rcert))
    assert got == want


def test_cost_prices_the_nonuniform_breakpoint_rom():
    """A non-uniform table pays (s-1) stored thresholds of w_in+1 bits, as
    in the reference; the uniform one pays none."""
    tab = load_table("sigmoid_wide", 8)
    nu = dataclasses.replace(tab, scheme=dataclasses.replace(
        tab.scheme, segmenter="nonuniform"))
    rnu = dataclasses.replace(_ref_table("sigmoid_wide", 8),
                              scheme=dataclasses.replace(
                                  _ref_table("sigmoid_wide", 8).scheme,
                                  segmenter="nonuniform"))
    assert hwcost.breakpoint_rom_bits(tab) == 0
    assert hwcost.breakpoint_rom_bits(nu) == \
        (tab.num_segments - 1) * (tab.cfg.w_in + 1) == \
        ref_hwcost.breakpoint_rom_bits(rnu)
    assert dataclasses.asdict(hwcost.estimate_cost(nu)) == \
        dataclasses.asdict(ref_hwcost.estimate_cost(rnu))


def _history(res):
    return [(step, cfg.as_dict(), segs, m) for step, cfg, segs, m in
            res.history]


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_optimize_fwls_equals_reference(backend):
    """Run as the reference's own test runs it (sigmoid, 6-bit, FQA
    order 1, one memoizing session): the same config, segment count,
    history and final table, on either search backend."""
    ref_sess = RefSession()
    want = RK.optimize_fwls("sigmoid", w_in=6, w_out=6,
                            scheme=RK.PPAScheme(1, None, "fqa"),
                            session=ref_sess)
    sess = CompilerSession()
    be = TorchSearchBackend("cpu") if backend == "torch" else "numpy"
    got = optimize_fwls("sigmoid", w_in=6, w_out=6,
                        scheme=PPAScheme(1, None, "fqa"), session=sess,
                        search_backend=be)
    assert got.cfg.as_dict() == want.cfg.as_dict()
    assert got.table.num_segments == want.table.num_segments
    assert _history(got) == _history(want)
    assert len(got.history) >= 3
    if backend == "numpy":
        assert got.table.to_json() == want.table.to_json()
        assert sess.counters() == ref_sess.counters()
    else:
        assert be.counts["dispatches"] > 0
        blob, rblob = (json.loads(t.to_json()) for t in (got.table,
                                                         want.table))
        for k in ("starts_int", "a_int", "b_int", "mae_hard", "mae_t",
                  "cfg", "scheme", "interval"):
            assert blob[k] == rblob[k], k


def test_optimize_fwls_order2_equals_reference():
    """Order 2 walks both stages' FWLs (w_o[1], w_o[0], w_a[0], w_a[1],
    w_b): the same shrink path as the reference."""
    want = RK.optimize_fwls("tanh", w_in=5, w_out=5,
                            scheme=RK.PPAScheme(2, None, "fqa"))
    got = optimize_fwls("tanh", w_in=5, w_out=5,
                        scheme=PPAScheme(2, None, "fqa"),
                        search_backend="numpy")
    assert got.cfg.as_dict() == want.cfg.as_dict()
    assert _history(got) == _history(want)
    assert got.table.to_json() == want.table.to_json()
