"""The canonical fit -> quantize -> segment -> pack compile path.

``compile_table`` is what everything in the repo now funnels through:
``repro_torch.core.schemes.compile_ppa_table`` is a thin wrapper around it, the
FWL shrink flow and the hardware-constrained workflow drive it through a
shared :class:`CompilerSession`, and :mod:`repro_torch.compiler.store` wraps it
with the content-addressed artifact cache.

A :class:`CompilerSession` owns the memoized evaluators (one per
(naf, interval, cfg, quantizer) compile context) and the tSEG estimates, so
search loops that compile the same context at many MAE_t values — the
Fig. 7 binary search, the Sec. III-C FWL shrink flow — reuse every window
fit instead of restarting from scratch.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..core.datapath import FWLConfig
from ..core.fixed_point import grid_for_interval, round_half_away
from ..core.functions import NAFSpec, get_naf
from ..core.quantize import Quantizer, make_quantizer
from ..core.schemes import PPAScheme, PPATable, eval_table_int
from ..core.searchspace import SearchBackend, resolve_backend
from ..core.segmentation import (bisection_segment, estimate_tseg,
                                     nonuniform_segment, sequential_segment,
                                     tbw_segment)

from .memo import MemoizedSegmentEvaluator

__all__ = ["CompilerSession", "compile_table", "resolve_defaults",
           "EFFORT_STAT_KEYS", "table_identity"]

#: env var making every compile end with an exact bit-width certification
#: (repro_torch.analysis.certify): a table any intermediate of which can exceed
#: the kernel carrier is refused with the violating interval instead of
#: being returned.  Off by default — the CI ``analyze`` tier and the
#: ``--certify-grid`` CLI run certification explicitly and persist the
#: certificates through the store.
CERTIFY_ENV = "REPRO_TORCH_CERTIFY"


def resolve_defaults(naf: "str | NAFSpec",
                     cfg: FWLConfig,
                     mae_t: Optional[float],
                     interval: Optional[Tuple[float, float]],
                     ) -> Tuple[NAFSpec, Tuple[float, float], float]:
    """The one place compile-request defaults are filled in — shared by the
    compiler and the store's content addressing (CompileJob.resolved), so
    a key always describes exactly what the compile would do.

    mae_t defaults to the half-ULP quantization floor 2^-(w_out+1) — the
    paper's "minimum achievable value for the current precision".
    """
    spec = get_naf(naf) if isinstance(naf, str) else naf
    interval = tuple(interval or spec.interval)
    if mae_t is None:
        mae_t = 0.5 ** (cfg.w_out + 1)
    return spec, interval, float(mae_t)

_COUNTER_KEYS = ("calls", "hits", "misses", "pruned", "warm_hits",
                 "spec_windows", "cand_evals", "points_touched",
                 "cross_warm_hits", "remez_batches", "remez_batch_windows")


def _naf_family(name: str) -> str:
    """Related-NAF grouping for cross-NAF warm seeding: a ``_wide``
    variant shares its base function with the narrow NAF, so satisfying
    coefficient sets transfer (after grid-value translation)."""
    return name[:-5] if name.endswith("_wide") else name

#: ``PPATable.stats`` keys that record search *effort*, not the compiled
#: artifact: they move with the search backend's dispatch pattern, the memo
#: cache and speculative probe batching while the table itself stays
#: bit-identical.  ``table_identity`` excludes exactly these.
EFFORT_STAT_KEYS = frozenset({
    "segment_evals", "candidate_evals", "points_touched",
    "memo_hits", "memo_misses", "memo_pruned", "warm_hits", "spec_windows",
})


def table_identity(table: PPATable) -> dict:
    """The artifact with effort counters stripped — what must be equal
    across search backends, speculation settings and memoization levels
    (the benchmarks' and tests' bit-identity oracle)."""
    blob = json.loads(table.to_json())
    blob["stats"] = {k: v for k, v in blob["stats"].items()
                     if k not in EFFORT_STAT_KEYS}
    return blob


class CompilerSession:
    """Shared compile state: memoized evaluators + tSEG estimates.

    One session per search loop (or one per process via the store); compiles
    issued against the same session share every cached window fit.
    ``memoize=False`` reproduces the seed evaluator behaviour exactly — the
    benchmarks use it as the baseline.
    """

    def __init__(self, *, memoize: bool = True):
        self.memoize = memoize
        self._evaluators: Dict[tuple, MemoizedSegmentEvaluator] = {}
        self._tseg: Dict[tuple, int] = {}
        #: warm candidates copied between related-NAF evaluators (the
        #: matching hit counter lives on each evaluator: cross_warm_hits)
        self.cross_warm_seeds = 0

    def evaluator(self, spec: NAFSpec, interval: Tuple[float, float],
                  cfg: FWLConfig, quantizer_key: tuple,
                  make_q: Callable[[], Quantizer], mae_t: float
                  ) -> MemoizedSegmentEvaluator:
        key = (spec.name, tuple(interval), cfg, quantizer_key)
        ev = self._evaluators.get(key)
        if ev is None:
            x_int = grid_for_interval(interval[0], interval[1], cfg.w_in)
            f_vals = spec(x_int.astype(np.float64) / (1 << cfg.w_in))
            ev = MemoizedSegmentEvaluator(x_int, f_vals, cfg, make_q(),
                                          mae_t, enabled=self.memoize)
            if self.memoize:
                self._cross_seed(key, ev)
            self._evaluators[key] = ev
        else:
            ev.retarget(mae_t)
        return ev

    def _cross_seed(self, key: tuple,
                    ev: MemoizedSegmentEvaluator) -> None:
        """Seed a fresh evaluator's warm candidates from *related* NAF
        contexts already in the session — same NAF family (sigmoid ↔
        sigmoid_wide, or the same NAF on a specialized interval), same
        FWL cfg, same quantizer context.  Starts are matched by grid
        value, and a seeded candidate is still verified inside the new
        window's own candidate space, so verdicts (and artifacts) are
        unchanged — only scans that would succeed anyway get cheaper."""
        name, _, cfg, quantizer_key = key
        fam = _naf_family(name)
        for (dname, _, dcfg, dqkey), donor in self._evaluators.items():
            if dcfg != cfg or dqkey != quantizer_key:
                continue
            if _naf_family(dname) != fam:
                continue
            if not donor._warm:
                continue
            self.cross_warm_seeds += ev.seed_warm(donor.x_int, donor._warm)

    def tseg_for(self, spec: NAFSpec, interval: Tuple[float, float],
                 cfg: FWLConfig, mae_t: float,
                 backend: "str | SearchBackend | None" = None) -> int:
        """Paper Step 1 with the reference (d=0) quantizer, cached per
        compile context so repeated compiles skip the reference run.  The
        reference run scans on ``backend``, the compile's own, so a compile
        asked onto the card runs no scan on the host."""
        key = (spec.name, tuple(interval), cfg, float(mae_t))
        tseg = self._tseg.get(key)
        if tseg is None:
            backend = resolve_backend(backend)
            ev_ref = self.evaluator(
                spec, interval, cfg, ("ref", "plac", backend.name),
                lambda: make_quantizer("plac", backend=backend), mae_t)
            tseg, _ = estimate_tseg(ev_ref, final_mode="feasible")
            self._tseg[key] = tseg
        return tseg

    def counters(self) -> Dict[str, int]:
        agg = {k: 0 for k in _COUNTER_KEYS}
        for ev in self._evaluators.values():
            for k in _COUNTER_KEYS:
                agg[k] += int(getattr(ev, k))
        agg["cross_warm_seeds"] = int(self.cross_warm_seeds)
        return agg


def _snapshot(ev: MemoizedSegmentEvaluator) -> Dict[str, int]:
    return {k: int(getattr(ev, k)) for k in _COUNTER_KEYS}


def compile_table(
    naf: "str | NAFSpec",
    cfg: FWLConfig,
    scheme: PPAScheme = PPAScheme(),
    *,
    mae_t: Optional[float] = None,
    interval: Optional[Tuple[float, float]] = None,
    tseg: Optional[int] = None,
    final_mode: str = "best",
    session: Optional[CompilerSession] = None,
    search_backend: "str | SearchBackend | None" = None,
    speculate: int = 0,
) -> PPATable:
    """Run fit -> quantize -> segment for one NAF and pack the table.

    mae_t defaults via :func:`resolve_defaults` to the half-ULP
    quantization floor 2^-(w_out+1).  Passing a ``session`` shares
    memoized window fits with every other compile on that session; without
    one an ephemeral session is used (warm starts and finalize hits still
    apply within the single compile).

    ``search_backend`` / ``speculate`` are *execution* knobs — the search
    backend the candidate blocks run on (numpy golden / torch on the card;
    ``$REPRO_TORCH_SEARCH_BACKEND``) and the TBW speculative-probe depth
    (0 = off).  Neither changes the compiled table
    (:func:`table_identity` asserted in tests and benchmarks), so neither
    is part of the store address.
    """
    spec, interval, mae_t = resolve_defaults(naf, cfg, mae_t, interval)
    session = session or CompilerSession()
    backend = resolve_backend(search_backend)

    # the backend is part of the *evaluator* key (clean per-backend
    # counters; results are backend-independent) but never of a store key.
    scheme_qkey = ("scheme", scheme.quantizer, scheme.m_shifters,
                   scheme.weight, backend.name, speculate)
    ev = session.evaluator(spec, interval, cfg, scheme_qkey,
                           lambda: scheme.build_quantizer(
                               backend=backend, lookahead=speculate),
                           mae_t)
    before = _snapshot(ev)

    seg_report: Dict[str, int] = {}
    if scheme.segmenter == "tbw":
        if tseg is None:
            tseg = session.tseg_for(spec, interval, cfg, mae_t, backend)
        segments = tbw_segment(ev, tseg, final_mode=final_mode,
                               speculate=speculate)
    elif scheme.segmenter == "nonuniform":
        if tseg is None:
            tseg = session.tseg_for(spec, interval, cfg, mae_t, backend)
        segments = nonuniform_segment(ev, tseg, final_mode=final_mode,
                                      speculate=speculate, report=seg_report)
    elif scheme.segmenter == "bisection":
        segments = bisection_segment(ev, final_mode=final_mode)
    elif scheme.segmenter == "sequential":
        segments = sequential_segment(ev, final_mode=final_mode)
    else:
        raise ValueError(f"unknown segmenter {scheme.segmenter!r}")

    x_int = ev.x_int
    f_vals = ev.f_vals
    starts = np.array([x_int[s.start] for s in segments], dtype=np.int64)
    a = np.array([s.fit.a_int for s in segments], dtype=np.int64)
    b = np.array([s.fit.b_int for s in segments], dtype=np.int64)
    mae_hard = max(s.fit.mae for s in segments)

    after = _snapshot(ev)
    delta = {k: after[k] - before[k] for k in _COUNTER_KEYS}

    f_q = round_half_away(f_vals * (1 << cfg.w_out)) / (1 << cfg.w_out)
    table = PPATable(
        naf=spec.name, interval=tuple(interval), cfg=cfg, scheme=scheme,
        starts_int=starts, a_int=a, b_int=b,
        mae_hard=float(mae_hard), mae_t=float(mae_t),
        stats={
            "mae_q": float(np.abs(f_q - f_vals).max()),
            "mae0": float(max(s.fit.mae0 for s in segments)),
            "segment_evals": delta["calls"],
            "candidate_evals": delta["cand_evals"],
            "points_touched": delta["points_touched"],
            "memo_hits": delta["hits"],
            "memo_misses": delta["misses"],
            "memo_pruned": delta["pruned"],
            "warm_hits": delta["warm_hits"],
            "spec_windows": delta["spec_windows"],
            "tseg": float(tseg or 0),
            # non-uniform search outcome (empty for the other segmenters):
            # deterministic facts about the artifact, identical across
            # search backends / memoization / speculation settings.
            **{k: float(v) for k, v in seg_report.items()},
        })
    table.validate()
    # cross-check: golden re-evaluation of the packed table
    y = eval_table_int(table, x_int)
    re_mae = float(np.abs(f_vals - y / (1 << cfg.w_out)).max())
    table.stats["mae_recheck"] = re_mae
    if re_mae > mae_hard + 1e-12:
        raise AssertionError(
            f"packed-table MAE {re_mae} exceeds per-segment MAE {mae_hard}")
    if os.environ.get(CERTIFY_ENV, "") not in ("", "0"):
        from ..analysis.certify import certify_table
        cert = certify_table(table)
        if not cert.ok:
            raise OverflowError(
                f"{spec.name} {scheme.tag}: datapath overflows its carrier: "
                + "; ".join(v.describe() for v in cert.violations))
        # deliberately not recorded in table.stats: an env knob must never
        # change the artifact bytes (the bit-identity contract)
    return table
