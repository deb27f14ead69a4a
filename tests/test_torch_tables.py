"""The PPA tables the PyTorch port ships stay true to the FQA compiler.

* every committed ``src/repro_torch/tables/<naf>-<bits>.json`` equals the
  reference compiler's output: the 12 jobs go through one
  ``repro.compiler.compile_batch`` call over a few processes into an empty
  store of the test's own (a module fixture), so they are compiled fresh
  and never read from the committed ``artifacts/ppa_tables/``;
* the port's numpy golden model and ``pack_table`` (starts, coefs, lo, hi,
  idx_lut, val_lut) equal the reference's over the whole input grid;
* the port's exhaustive int32 guard agrees with the reference certifier
  (``repro.analysis.certify.certify_table``) and rejects an overflowing
  table.

The eval, pack and guard tests read the shipped JSON into the reference's
``PPATable`` through its own loader (``PPATable.from_json``), so both
packages see the same table data and need no compile.

Run as a script, this file rewrites the JSONs from the reference compiler:

  PYTHONPATH=src python tests/test_torch_tables.py
"""

import dataclasses
import json
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference side runs on the CPU)

from repro.analysis.certify import certify_table  # noqa: E402
from repro.compiler import CompileJob, TableStore, compile_batch  # noqa: E402
from repro.core import PPATable as RefPPATable  # noqa: E402
from repro.core import eval_table_int as ref_eval_table_int  # noqa: E402
from repro.kernels import pack_table as ref_pack_table  # noqa: E402
from repro.models.activations import \
    ppa_table_jobs as ref_table_jobs  # noqa: E402
from repro_torch.core import eval_table_int  # noqa: E402
from repro_torch.kernels import check_int32, pack_table  # noqa: E402
from repro_torch.models import ppa_table_jobs  # noqa: E402
from repro_torch.tables import load_table, table_path  # noqa: E402

#: the JSON field set the port reads (PPATable.to_json minus stats)
FIELDS = ("naf", "interval", "cfg", "scheme", "starts_int", "a_int",
          "b_int", "mae_hard", "mae_t")
JOBS = [(naf, cfg.w_out) for impl in ("ppa", "ppa8")
        for naf, cfg, _ in ref_table_jobs(impl)]
#: worker processes of the one batch compile
COMPILE_PROCESSES = 3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _ref_job(naf, bits):
    impl = "ppa" if bits == 16 else "ppa8"
    return next(j for j in ref_table_jobs(impl) if j[0] == naf)


def _compile_all(root):
    """{(naf, bits): PPATable} from the reference compiler, one batch on
    an empty store at ``root``.  The widest input intervals go first:
    their compiles take longest, so the batch ends soon after them."""
    order = sorted(JOBS, key=lambda j: -np.diff(load_table(*j).interval)[0])
    jobs = [CompileJob(*_ref_job(naf, bits)) for naf, bits in order]
    return dict(zip(order, compile_batch(jobs, store=TableStore(root),
                                         processes=COMPILE_PROCESSES)))


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    return _compile_all(tmp_path_factory.mktemp("ref_store"))


def _ref_table(naf, bits):
    """The shipped JSON as the reference's PPATable, through its loader."""
    d = json.loads(table_path(naf, bits).read_text())
    return RefPPATable.from_json(json.dumps({**d, "stats": {}}))


def _as_json(table) -> dict:
    return {"naf": table.naf, "interval": list(table.interval),
            "cfg": table.cfg.as_dict(),
            "scheme": dataclasses.asdict(table.scheme),
            "starts_int": table.starts_int.tolist(),
            "a_int": table.a_int.tolist(), "b_int": table.b_int.tolist(),
            "mae_hard": table.mae_hard, "mae_t": table.mae_t}


def _grid(table):
    lo = int(np.ceil(table.interval[0] * (1 << table.cfg.w_in) - 1e-12))
    hi = int(np.ceil(table.interval[1] * (1 << table.cfg.w_in) - 1e-12))
    return np.arange(lo, hi, dtype=np.int64)


def test_port_jobs_are_the_reference_jobs():
    for impl in ("ppa", "ppa8"):
        ours = [(n, c.as_dict(), dataclasses.asdict(s))
                for n, c, s in ppa_table_jobs(impl)]
        ref = [(n, c.as_dict(), dataclasses.asdict(s))
               for n, c, s in ref_table_jobs(impl)]
        assert ours == ref


@pytest.mark.parametrize("naf,bits", JOBS)
def test_shipped_table_equals_reference_compile(compiled, naf, bits):
    ref = json.loads(json.dumps(_as_json(compiled[naf, bits])))
    shipped = json.loads(table_path(naf, bits).read_text())
    assert sorted(shipped) == sorted(FIELDS)
    for k in FIELDS:
        assert shipped[k] == ref[k], k


@pytest.mark.parametrize("naf,bits", JOBS)
def test_eval_table_int_matches_reference(naf, bits):
    tab = load_table(naf, bits)
    rng = np.random.default_rng(bits)
    grid = _grid(tab)
    x = np.concatenate([grid, grid + len(grid), -grid - 1,
                        rng.integers(-4096, 8192, 999)])
    ref_tab = _ref_table(naf, bits)
    np.testing.assert_array_equal(eval_table_int(tab, x),
                                  ref_eval_table_int(ref_tab, x))


@pytest.mark.parametrize("naf,bits", JOBS)
def test_pack_table_matches_reference(naf, bits):
    tc = pack_table(load_table(naf, bits), "cpu")
    rtc = ref_pack_table(_ref_table(naf, bits))
    assert (tc.lo, tc.hi, tc.num_segments) == (rtc.lo, rtc.hi,
                                               rtc.num_segments)
    assert (tc.symmetry, tc.sat_hi, tc.sat_identity) == (
        rtc.symmetry, rtc.sat_hi, rtc.sat_identity)
    assert dataclasses.asdict(tc.plan) == dataclasses.asdict(rtc.plan)
    for name in ("starts", "coefs", "idx_lut", "val_lut"):
        got = getattr(tc, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(rtc, name)), name)


@pytest.mark.parametrize("naf,bits", JOBS)
def test_int32_guard_agrees_with_certifier(naf, bits):
    ref_tab = _ref_table(naf, bits)
    tab = load_table(naf, bits)
    try:
        check_int32(tab, _grid(tab))
        port_ok = True
    except ValueError:
        port_ok = False
    assert port_ok == certify_table(ref_tab).ok
    assert port_ok


def test_int32_guard_rejects_overflowing_table():
    """A hand-built table whose second Horner stage leaves int32: both the
    certifier and the port's guard reject it."""
    ref_tab = _ref_table("exp2_frac", 16)
    big = dataclasses.replace(ref_tab, a_int=ref_tab.a_int.copy())
    big.a_int[3, 1] = 1 << 30
    assert not certify_table(big).ok
    with pytest.raises(ValueError, match="overflows the int32 datapath"):
        ref_pack_table(big)
    ours = dataclasses.replace(load_table("exp2_frac", 16),
                               a_int=big.a_int.copy())
    with pytest.raises(ValueError, match="overflows the int32 datapath"):
        pack_table(ours, "cpu")


def main():
    """Rewrite the shipped JSONs from the reference compiler."""
    with tempfile.TemporaryDirectory() as root:
        for (naf, bits), table in _compile_all(root).items():
            path = table_path(naf, bits)
            path.write_text(json.dumps(_as_json(table)))
            print(f"wrote {path}")


if __name__ == "__main__":
    main()
