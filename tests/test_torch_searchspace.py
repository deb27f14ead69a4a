"""The port's search backends against the JAX package's numpy golden
backend, on the CPU: candidate blocks (single, multi-window and batched),
``fit_segment`` over CFG1/CFG2 x the five quantizers x the modes, the
lockstep multi-window fits, lookahead and warm starts, and a small
hypothesis property.  The port's torch backend runs with
``device="cpu"``; on the card it is held to the numpy backend by
``tests/test_torch_gpu.py::test_torch_search_backend_on_card``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import FWLConfig as RefFWL  # noqa: E402
from repro.core import make_quantizer as ref_make_quantizer  # noqa: E402
from repro.core.functions import get_naf as ref_get_naf  # noqa: E402
from repro.core.searchspace import \
    NumpySearchBackend as RefNumpy  # noqa: E402
from repro_torch.core import (FWLConfig, get_naf, grid_for_interval,  # noqa
                              make_quantizer, resolve_backend)
from repro_torch.core.searchspace import (SEARCH_BACKENDS,  # noqa: E402
                                          NumpySearchBackend,
                                          TorchSearchBackend)

CFG1 = (7, 7, (7,), (7,), 7)
CFG2 = (7, 7, (7, 7), (7, 7), 7)
QUANTIZERS = ("fqa", "fqa_fast", "qpa", "plac", "mlplac")
FIT_FIELDS = ("ok", "mae", "a_int", "b_int", "mae0", "n_satisfying", "evals",
              "warm_hit", "truncated")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _backends():
    """The port's two backends, the torch one on the CPU."""
    return {"numpy": NumpySearchBackend(),
            "torch": TorchSearchBackend(device="cpu")}


def _grid(naf="sigmoid", cfg=CFG1):
    spec = ref_get_naf(naf)
    x = grid_for_interval(*spec.interval, cfg[0])
    return x, spec(x.astype(np.float64) / (1 << cfg[0]))


def assert_fits_identical(a, b, full=False):
    for k in FIT_FIELDS:
        assert getattr(a, k) == getattr(b, k), k
    if full:
        if a.a_candidates is None:
            assert b.a_candidates is None
        else:
            assert np.array_equal(a.a_candidates, b.a_candidates)
            assert np.array_equal(a.b_candidates, b.b_candidates)


def _assert_block(got, want):
    """mae and b_int on every row, mae0 at the first argmin row (the
    backend contract)."""
    (m, b, m0), (wm, wb, wm0) = got, want
    assert m.dtype == np.float64 and b.dtype == np.int64
    assert np.array_equal(m, wm) and np.array_equal(b, wb)
    k = int(np.argmin(wm))
    assert m0[k] == wm0[k]


def _contexts(backend, cfg):
    x, f = _grid(cfg=cfg)
    c = FWLConfig(*cfg)
    return [backend.context(x[s:e], f[s:e], c, flatten_b=fb, b_fixed=-5)
            for s, e, fb in ((0, 24, True), (7, 80, True), (30, 31, True),
                             (50, 90, False))]


@pytest.mark.parametrize("cfg", [CFG1, CFG2], ids=["cfg1", "cfg2"])
@pytest.mark.parametrize("name", ["numpy", "torch"])
def test_eval_blocks_match_reference(name, cfg):
    ours = _backends()[name]
    ref = RefNumpy()
    rng = np.random.default_rng(len(cfg[2]))
    blocks = [[rng.integers(-400, 400, k) for _ in cfg[2]]
              for k in (1, 64, 65, 700)]
    octx = _contexts(ours, cfg)
    rctx = [ref.context(c.x_int, c.f_vals, RefFWL(*cfg),
                        flatten_b=c.flatten_b, b_fixed=c.b_fixed)
            for c in octx]
    want = [ref.eval_block(c, b) for c, b in zip(rctx, blocks)]
    for got, w in zip([ours.eval_block(c, b) for c, b in zip(octx, blocks)],
                      want):
        _assert_block(got, w)
    # one multi-window dispatch shares a datapath plan and intercept mode
    multi = ours.eval_block_multi(list(zip(octx[:3], blocks[:3])))
    for got, w in zip(multi, want[:3]):
        _assert_block(got, w)
    for i in (1, 3):        # flattened and fixed intercepts
        for got, blk in zip(ours.eval_block_batch(octx[i], blocks), blocks):
            _assert_block(got, ref.eval_block(rctx[i], blk))


@pytest.mark.parametrize("mode", ["feasible", "best", "full"])
@pytest.mark.parametrize("qname", QUANTIZERS)
@pytest.mark.parametrize("cfg", [CFG1, CFG2], ids=["cfg1", "cfg2"])
def test_fit_segment_identity(cfg, qname, mode):
    """``assert_fits_identical`` of tests/test_searchspace.py: the port's
    numpy and torch backends against the reference's numpy backend."""
    x, f = _grid(cfg=cfg)
    lo, hi = (3, 40) if cfg is CFG1 else (0, 24)
    mae_t = 0.5 ** 8
    want = ref_make_quantizer(qname, backend="numpy").fit_segment(
        x[lo:hi], f[lo:hi], RefFWL(*cfg), mae_t, mode=mode)
    if cfg is CFG2 and qname == "fqa":
        assert want.evals == (3 * 2 ** 7 + 1) ** 2      # the o2 full space
    for backend in _backends().values():
        got = make_quantizer(qname, backend=backend).fit_segment(
            x[lo:hi], f[lo:hi], FWLConfig(*cfg), mae_t, mode=mode)
        assert_fits_identical(got, want, full=(mode == "full"))
        assert np.array_equal(got.a_real, want.a_real)


def test_fit_segments_lockstep_and_lookahead():
    """``fit_segments`` (one multi-window dispatch a round, budgets, the
    batched Remez) and lookahead scans equal the reference's."""
    x, f = _grid(cfg=CFG2)
    wins = [(x[s:e], f[s:e]) for s, e in ((0, 20), (10, 44), (60, 61),
                                          (70, 100))]
    mae_t = 0.5 ** 7
    kw = dict(mode="feasible", max_chunks=[None, 1, None, 2])
    want = ref_make_quantizer("fqa", backend="numpy").fit_segments(
        wins, RefFWL(*CFG2), mae_t, **kw)
    for backend in _backends().values():
        got = make_quantizer("fqa", backend=backend).fit_segments(
            wins, FWLConfig(*CFG2), mae_t, **kw)
        for g, w in zip(got, want):
            assert_fits_identical(g, w)
        for look in (1, 3):
            q = make_quantizer("fqa", backend=backend, lookahead=look)
            rq = ref_make_quantizer("fqa", backend="numpy", lookahead=look)
            for xs, fs in wins:
                assert_fits_identical(
                    q.fit_segment(xs, fs, FWLConfig(*CFG2), mae_t),
                    rq.fit_segment(xs, fs, RefFWL(*CFG2), mae_t))


@pytest.mark.parametrize("name", ["numpy", "torch"])
def test_warm_start_single_eval(name):
    x, f = _grid()
    mae_t = 0.5 ** 5                          # loose: warm start satisfies
    seed = ref_make_quantizer("fqa", backend="numpy").fit_segment(
        x[0:12], f[0:12], RefFWL(*CFG1), mae_t, mode="feasible")
    assert seed.ok
    want = ref_make_quantizer("fqa", backend="numpy").fit_segment(
        x[0:14], f[0:14], RefFWL(*CFG1), mae_t, a_warm=seed.a_int)
    got = make_quantizer("fqa", backend=_backends()[name]).fit_segment(
        x[0:14], f[0:14], FWLConfig(*CFG1), mae_t, a_warm=seed.a_int)
    assert got.warm_hit and got.evals == 1 and got.ok
    assert_fits_identical(got, want)
    # a warm candidate outside this window's space falls back to the scan
    far = tuple(v + 10_000 for v in seed.a_int)
    got = make_quantizer("fqa", backend=_backends()[name]).fit_segment(
        x[0:14], f[0:14], FWLConfig(*CFG1), mae_t, a_warm=far)
    assert not got.warm_hit


@settings(max_examples=20, deadline=None)
@given(naf=st.sampled_from(["sigmoid", "tanh", "exp2_frac", "log2"]),
       start=st.integers(0, 100), width=st.integers(1, 27),
       qname=st.sampled_from(QUANTIZERS),
       mode=st.sampled_from(["feasible", "best"]),
       bits=st.integers(5, 9))
def test_fit_identity_property(naf, start, width, qname, mode, bits):
    """Any window, target and quantizer: the torch backend's fit is the
    reference's."""
    x, f = _grid(naf)
    s = min(start, x.size - 1)
    xs, fs = x[s:s + width], f[s:s + width]
    want = ref_make_quantizer(qname, backend="numpy").fit_segment(
        xs, fs, RefFWL(*CFG1), 0.5 ** bits, mode=mode)
    got = make_quantizer(qname, backend=_backends()["torch"]).fit_segment(
        xs, fs, FWLConfig(*CFG1), 0.5 ** bits, mode=mode)
    assert_fits_identical(got, want)


def test_resolve_backend(monkeypatch):
    """numpy by default; the port reads its own variable, so the
    reference's ``REPRO_SEARCH_BACKEND`` never reaches it; the torch
    backend is the card unless the CPU is asked for."""
    monkeypatch.delenv("REPRO_TORCH_SEARCH_BACKEND", raising=False)
    monkeypatch.setenv("REPRO_SEARCH_BACKEND", "jax")
    assert resolve_backend(None).name == "numpy"
    inst = TorchSearchBackend(device="cpu")
    assert resolve_backend(inst) is inst
    assert set(SEARCH_BACKENDS) == {"numpy", "torch"}
    with pytest.raises(KeyError):
        resolve_backend("jax")
    monkeypatch.setenv("REPRO_TORCH_SEARCH_BACKEND", "numpy")
    assert resolve_backend(None).name == "numpy"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchSearchBackend()
        monkeypatch.setenv("REPRO_TORCH_SEARCH_BACKEND", "torch")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_backend(None)


def test_torch_counts_one_sync_per_dispatch():
    """A full scan of several chunks runs as one dispatch group, a
    multi-window round as one."""
    x, f = _grid()
    backend = TorchSearchBackend(device="cpu")
    q = make_quantizer("fqa", backend=backend)
    fit = q.fit_segment(x[:30], f[:30], FWLConfig(*CFG1), 0.5 ** 8,
                        mode="best")
    assert fit.evals == 3 * 2 ** 7 + 1
    c = backend.counts
    assert c["blocks"] == -(-fit.evals // q.chunk) and c["dispatches"] == 1
    assert get_naf("sigmoid").interval == (0.0, 1.0)


def test_torch_compile_runs_no_numpy_scan(monkeypatch):
    """A compile asked onto the torch backend scans there only, its tSEG
    reference run included: no block goes to the numpy backend."""
    from repro_torch.compiler import compile_table
    from repro_torch.core import PPAScheme

    def refuse(*a, **k):
        raise AssertionError("a block ran on the numpy backend")
    monkeypatch.setattr(NumpySearchBackend, "eval_block", refuse)
    for segmenter in ("tbw", "nonuniform"):
        tab = compile_table("sigmoid", FWLConfig(5, 5, (5,), (5,), 5),
                            PPAScheme(order=1, segmenter=segmenter),
                            search_backend=TorchSearchBackend("cpu"))
        assert tab.stats["tseg"] > 0
