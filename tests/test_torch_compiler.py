"""The port's compiler against the JAX package's, on the CPU: whole
``compile_table`` artifacts under the four segmenters (numpy backends:
the JSON, stats included; the port's torch backend: ``table_identity``),
store keys and artifact bytes (each package loading the other's), the
failpoints, certificates, the hardware-constrained workflow, one
deployment table compiled through a store, and ``make_acts(store=)``.
Stores are written only under ``tmp_path``."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.analysis.certify as ref_certify  # noqa: E402
import repro.compiler as RC  # noqa: E402
import repro.core as RK  # noqa: E402
import repro.faults as ref_faults  # noqa: E402
from repro.analysis.intervals import Interval as RefInterval  # noqa: E402
from repro.analysis.intervals import \
    abstract_horner as ref_abstract_horner  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.analysis import certify  # noqa: E402
from repro_torch.analysis.intervals import (Interval,  # noqa: E402
                                            abstract_horner)
from repro_torch.compiler import (EFFORT_STAT_KEYS, CompileJob,  # noqa: E402
                                  CompilerSession, TableStore, compile_batch,
                                  compile_table, table_identity)
from repro_torch.core import (FWLConfig, PPAScheme, PPATable,  # noqa: E402
                              TorchSearchBackend, hardware_constrained_ppa,
                              table_mae_report)
from repro_torch.models import make_acts, ppa_table_jobs  # noqa: E402
from repro_torch.tables import load_table, table_path  # noqa: E402

W6 = (6, 6, (6,), (6,), 6)
W5_O2 = (5, 5, (5, 5), (5, 5), 5)
SEGMENTERS = ("tbw", "nonuniform", "bisection", "sequential")
#: the shipped JSON's field set (tests/test_torch_tables.py::FIELDS)
FIELDS = ("naf", "interval", "cfg", "scheme", "starts_int", "a_int",
          "b_int", "mae_hard", "mae_t")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.reset()
    yield
    faults.reset()


def _pair(cfg, **scheme):
    return ((FWLConfig(*cfg), PPAScheme(**scheme)),
            (RK.FWLConfig(*cfg), RK.PPAScheme(**scheme)))


@pytest.mark.parametrize("speculate", [0, 2])
@pytest.mark.parametrize("segmenter", SEGMENTERS)
def test_compile_table_matches_reference(segmenter, speculate):
    """The port's numpy compile gives the reference's JSON, effort stats
    included; its torch backend (on the CPU) the same table_identity."""
    jobs = [("sigmoid", W6, dict(order=1, segmenter=segmenter)),
            ("tanh", W6, dict(order=1, quantizer="qpa",
                              segmenter=segmenter))]
    if segmenter == "tbw":
        jobs += [("exp2_frac", W5_O2, dict(order=2)),
                 ("sigmoid", W6, dict(order=1, m_shifters=2,
                                      weight="csd"))]
    for naf, cfg, scheme in jobs:
        (c, s), (rc, rs) = _pair(cfg, **scheme)
        want = RC.compile_table(naf, rc, rs, speculate=speculate)
        got = compile_table(naf, c, s, speculate=speculate)
        assert got.to_json() == want.to_json()
        card = compile_table(naf, c, s, speculate=speculate,
                             search_backend=TorchSearchBackend("cpu"))
        assert table_identity(card) == RC.table_identity(want)
        assert EFFORT_STAT_KEYS == RC.EFFORT_STAT_KEYS
        assert table_mae_report(got) == RK.table_mae_report(want)
        assert got.unique_lut_rows() == want.unique_lut_rows()


def test_session_reuse_matches_reference():
    """Compiles at several MAE_t on one session (retargeted evaluators,
    cross-NAF warm seeds) give the reference's artifacts and counters."""
    (c, s), (rc, rs) = _pair(W6, order=1)
    ours, ref = CompilerSession(), RC.CompilerSession()
    for naf, mae_t in (("sigmoid", 2e-2), ("sigmoid", 1.2e-2),
                       ("sigmoid_wide", 1.2e-2), ("sigmoid", 2e-2)):
        got = compile_table(naf, c, s, mae_t=mae_t, session=ours)
        want = RC.compile_table(naf, rc, rs, mae_t=mae_t, session=ref)
        assert got.to_json() == want.to_json()
    assert ours.counters() == ref.counters()


def test_keys_and_artifact_bytes_match_reference(tmp_path):
    """Same key and file name; the port's artifact bytes are the
    reference's; each package loads the other's artifact as a disk hit."""
    (c, s), (rc, rs) = _pair(W6, order=1)
    job = CompileJob("sigmoid", c, s, tseg=4)
    rjob = RC.CompileJob("sigmoid", rc, rs, tseg=4)
    assert job.key() == rjob.key()
    assert CompileJob.VERSION == RC.CompileJob.VERSION
    ours, ref = TableStore(tmp_path / "port"), RC.TableStore(tmp_path / "ref")
    got = ours.compile_or_load("sigmoid", c, s, tseg=4)
    want = ref.compile_or_load("sigmoid", rc, rs, tseg=4)
    (p,), (r,) = (list((tmp_path / d).glob("*.json")) for d in ("port",
                                                                  "ref"))
    assert p.name == r.name and p.read_bytes() == r.read_bytes()
    assert got.to_json() == want.to_json()
    # cross-load: each package's fresh store over the other's directory
    other = TableStore(tmp_path / "ref").compile_or_load("sigmoid", c, s,
                                                          tseg=4)
    rother = RC.TableStore(tmp_path / "port").compile_or_load(
        "sigmoid", rc, rs, tseg=4)
    assert other.to_json() == want.to_json()
    assert rother.to_json() == got.to_json()
    # the port's store and batch: hits, misses, merge and the version sweep
    st = TableStore(tmp_path / "port")
    tabs = compile_batch([job, CompileJob("tanh", c, s)], store=st,
                         processes=1)
    assert tabs[0].to_json() == got.to_json()
    assert st.stats()["hits_disk"] == 1 and st.stats()["compiles"] == 1
    merged = TableStore(tmp_path / "merged")
    assert merged.merge(tmp_path / "port")["imported"] == 2
    assert merged.version_sweep() == []


def test_failpoints_by_name(tmp_path):
    """The store fires the reference's failpoint names: a fault before the
    rename publishes no artifact; one at compile start compiles nothing;
    the two registries are armed apart."""
    (c, s), _ = _pair(W6, order=1)
    store = TableStore(tmp_path)
    faults.arm("store.put.before_rename")
    with pytest.raises(faults.InjectedFault):
        store.compile_or_load("sigmoid", c, s, tseg=4)
    assert faults.fired("store.put.before_rename") == 1
    assert ref_faults.fired("store.put.before_rename") == 0
    assert not list(tmp_path.glob("*.json"))
    faults.arm("compile.job")
    with pytest.raises(faults.InjectedFault):
        TableStore(tmp_path).compile_or_load("tanh", c, s)
    assert not list(tmp_path.glob("*.json"))
    faults.reset()
    faults.arm("store.load.read", "once", action="raise=oserror")
    faults.arm("compile.job.done", "always", action="count")
    tab = TableStore(tmp_path).compile_or_load("sigmoid", c, s, tseg=4)
    again = TableStore(tmp_path)
    assert again.compile_or_load("sigmoid", c, s,
                                 tseg=4).to_json() == tab.to_json()
    assert again.io_retries == 1 and faults.fired("compile.job.done") == 1
    assert faults.snapshot()["store.load.read"][0]["fires"] == 1


def test_certificates_match_reference(tmp_path, monkeypatch):
    """``certify_table`` equal to the reference's on every shipped table and
    a compiled one, the envelope mode too, and the store's stamped
    certificate; the compile-time check refuses an overflowing table."""
    for path in sorted(table_path("exp2_frac", 8).parent.glob("*.json")):
        d = json.loads(path.read_text())
        ours = certify.certify_table(PPATable.from_json(path.read_text()))
        ref = ref_certify.certify_table(RK.PPATable.from_json(
            json.dumps({**d, "stats": {}})))
        assert ours.to_json() == ref.to_json() and ours.ok
    (c, s), (rc, rs) = _pair(W5_O2, order=2)
    assert certify.certify_config("exp2_frac", c, s, max_depth=3).to_json() \
        == ref_certify.certify_config("exp2_frac", rc, rs,
                                      max_depth=3).to_json()
    iv = [Interval(-7, 9), Interval(3, 40)]
    riv = [RefInterval(-7, 9), RefInterval(3, 40)]
    got = abstract_horner(c, iv, Interval(-2, 2), Interval(0, 31))
    want = ref_abstract_horner(rc, riv, RefInterval(-2, 2),
                               RefInterval(0, 31))
    assert {k: v.as_dict() for k, v in got.items()} == {
        k: v.as_dict() for k, v in want.items()}
    store = TableStore(tmp_path)
    job = CompileJob("exp2_frac", c, s)
    cert = store.certify(job)
    rcert = RC.TableStore(tmp_path / "ref").certify(
        RC.CompileJob("exp2_frac", rc, rs))
    assert cert.to_json() == rcert.to_json()
    assert store.load_certificate(job).to_json() == cert.to_json()
    monkeypatch.setenv("REPRO_TORCH_CERTIFY", "1")
    compile_table("exp2_frac", c, s)
    big = dataclasses.replace(load_table("exp2_frac", 16),
                              a_int=load_table("exp2_frac", 16).a_int.copy())
    big.a_int[3, 1] = 1 << 30
    assert not certify.certify_table(big).ok


def test_hardware_constrained_workflow_matches_reference():
    """Paper Fig. 7 at SEG_t 8: the port's winner, its MAE_t path and the
    session's counters are the reference's, on both of its backends."""
    (c, s), (rc, rs) = _pair((8, 8, (8,), (8,), 8), order=1)
    want = RK.hardware_constrained_ppa("sigmoid", rc, rs, seg_t=8)
    for backend in ("numpy", TorchSearchBackend("cpu")):
        session = CompilerSession()
        got = hardware_constrained_ppa("sigmoid", c, s, seg_t=8,
                                       session=session,
                                       search_backend=backend)
        assert (got.iterations, got.mae_t_path) == (want.iterations,
                                                     want.mae_t_path)
        assert table_identity(got.table) == RC.table_identity(want.table)
        if backend == "numpy":
            assert got.table.to_json() == want.table.to_json()


def test_deployment_table_compiles_to_shipped_json(tmp_path):
    """exp2_frac-8 compiled through a fresh store equals the shipped JSON
    and the reference's artifact bytes."""
    naf, cfg, scheme = next(j for j in ppa_table_jobs("ppa8")
                            if j[0] == "exp2_frac")
    tab = TableStore(tmp_path / "port").compile_or_load(naf, cfg, scheme)
    shipped = json.loads(table_path(naf, 8).read_text())
    got = json.loads(tab.to_json())
    assert {k: got[k] for k in FIELDS} == shipped
    RC.TableStore(tmp_path / "ref").put(
        RC.CompileJob(naf, RK.FWLConfig(**{**cfg.as_dict(), "w_a": cfg.w_a,
                                           "w_o": cfg.w_o}),
                      RK.PPAScheme(**dataclasses.asdict(scheme))),
        RK.PPATable.from_json(tab.to_json()))
    (p,), (r,) = (list((tmp_path / d).glob("*.json")) for d in ("port",
                                                                  "ref"))
    assert p.name == r.name and p.read_bytes() == r.read_bytes()


@pytest.mark.parametrize("impl", ["ppa", "ppa8"])
def test_make_acts_from_store_equals_default_bundle(tmp_path, impl):
    """A store seeded with the shipped tables serves the default bundle's
    outputs, with hits only."""
    store = TableStore(tmp_path)
    bits = 16 if impl == "ppa" else 8
    for naf, cfg, scheme in ppa_table_jobs(impl):
        store.put(CompileJob(naf, cfg, scheme), load_table(naf, bits))
    got = make_acts(impl, device="cpu", store=TableStore(tmp_path))
    want = make_acts(impl, device="cpu")
    assert got is not want
    x = torch.from_numpy(np.random.default_rng(bits).normal(
        0, 4, (3, 257)).astype(np.float32))
    for name in ("sigmoid", "tanh", "gelu", "silu", "softplus",
                 "exp_decay"):
        assert torch.equal(getattr(got, name)(x.abs() if name == "exp_decay"
                                              else x),
                           getattr(want, name)(x.abs() if name == "exp_decay"
                                               else x)), name
    assert torch.equal(got.softmax(x), want.softmax(x))
    assert make_acts(impl, device="cpu", store=None) is want


def test_make_acts_cold_store_searches_on_the_bundle_device(tmp_path,
                                                            monkeypatch):
    """A table missing from the store compiles on a torch backend on the
    bundle's own device, never on the host's numpy default, and lands in
    the store equal to the shipped JSON."""
    import repro_torch.models.activations as acts

    made = []

    class Recording(TorchSearchBackend):
        def __init__(self, device=None):
            super().__init__(device)
            made.append(self)

    monkeypatch.delenv("REPRO_TORCH_SEARCH_BACKEND", raising=False)
    monkeypatch.setattr(acts, "TorchSearchBackend", Recording)
    store = TableStore(tmp_path)
    for naf, cfg, scheme in ppa_table_jobs("ppa8"):
        if naf != "exp2_frac":
            store.put(CompileJob(naf, cfg, scheme), load_table(naf, 8))
    bundle = make_acts("ppa8", device="cpu", store=store)
    assert store.stats()["compiles"] == 1
    ran = [b for b in made if b.counts["dispatches"]]
    assert len(ran) == 1 and ran[0].device == torch.device("cpu")
    naf, cfg, scheme = next(j for j in ppa_table_jobs("ppa8")
                            if j[0] == "exp2_frac")
    got = json.loads(store.compile_or_load(naf, cfg, scheme).to_json())
    assert {k: got[k] for k in FIELDS} == json.loads(
        table_path(naf, 8).read_text())
    x = torch.linspace(-6, 6, 97)
    assert torch.equal(bundle.softmax(x),
                       make_acts("ppa8", device="cpu").softmax(x))
