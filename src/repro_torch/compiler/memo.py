"""Memoized segment evaluation: the compiler's interval cache.

The whole software cost of the FQA flow is repeated ``SegmentEvaluator``
calls: TBW probes overlapping windows, the FWL shrink flow recompiles the
full table once per candidate FWL, and the hardware-constrained workflow
binary-searches MAE_t with a full recompile per iteration.  The seed
evaluator forgot every fit the moment it returned; this one remembers.

Cache semantics per ``(start, end)`` window:

  * **complete** entries hold the quantizer's minimum achievable MAE for
    the window (a full candidate-space scan: any "best"/"full" fit, or a
    *failed* feasible scan — which is exhaustive by construction).  A
    complete entry answers feasibility at *any* MAE_t with one float
    comparison, so retargeting the evaluator (``retarget``) between binary-
    search iterations keeps all knowledge valid.
  * **partial** entries hold an upper bound (an early-exited feasible scan).
    They answer "feasible?" whenever their bound already satisfies the
    current MAE_t; anything tighter falls through to a real scan.

Monotone pruning, from two lower bounds on a window's achievable MAE:

  * the per-point quantization floor max|f - f_q| over the window (the
    paper's Eq. 7 MAE_0 bound) — unconditionally sound, since any
    datapath output lives on the w_out grid;
  * a *same-start* contained window's known minimum: extending a window
    rightward can only grow its best achievable MAE.  This is exactly the
    monotonicity the seed's TBW/bisection already assume when a failed
    probe at ``ep`` excludes every end beyond it (rp = ep-1), so pruning
    on it is no stronger an assumption than the uncached algorithm makes.
    Windows with *different* starts are never used: FQA candidate spaces
    are centered on each window's own Remez fit, so cross-start
    containment would not be a sound bound.

Warm starts: the last satisfying coefficient set per segment start is
offered to the quantizer, which verifies it *inside the window's own
candidate space* — probes that would succeed anyway succeed after one
candidate evaluation instead of a chunk scan, and decisions are bit-
identical to the uncached evaluator either way.

Speculative probe batching (``prefetch``): TBW with ``speculate > 0``
announces the windows its inner loop can visit next; the ones the cache
cannot already answer are fitted as ONE batched multi-window quantizer
dispatch (``Quantizer.fit_segments`` lockstep over the search backend) and
recorded exactly like sequential misses, so the probes that follow are
cache hits.  Each speculative fit is a real feasible-mode scan of its window,
so every verdict it caches is the verdict a sequential scan would have
produced — segment choices are bit-identical with speculation on or off
(warm-candidate *content* may differ; warm hits never change verdicts, and
final per-segment fits are full "best"-mode scans either way).

Counters distinguish logical requests from work done: ``calls`` counts
every request (as in the seed), ``hits``/``pruned`` the requests answered
from the cache, ``misses`` the real quantizer scans (speculative ones
included), ``warm_hits`` the misses resolved by the warm candidate,
``spec_windows`` the windows fitted speculatively.
``cand_evals``/``points_touched`` only ever grow on misses.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.datapath import FWLConfig
from ..core.fixed_point import round_half_away
from ..core.quantize import Quantizer, SegmentFit, _EPS
from ..core.remez import fit_minimax_batch
from ..core.segmentation import SegmentEvaluator

__all__ = ["MemoizedSegmentEvaluator"]


def _quant_mode(mode: str) -> str:
    """The quantizer-facing mode for an evaluator request: ``probe`` is a
    feasibility question asked *without* the monotone-containment prior
    (see :meth:`MemoizedSegmentEvaluator.lower_bound`), but the scan it
    triggers is an ordinary feasible scan."""
    return "feasible" if mode == "probe" else mode


@dataclasses.dataclass
class _Entry:
    fit: SegmentFit
    complete: bool    # fit.mae is the minimum over the full candidate space


class MemoizedSegmentEvaluator(SegmentEvaluator):
    """Drop-in :class:`SegmentEvaluator` with an interval cache.

    ``enabled=False`` degrades to the exact seed behaviour (no cache, no
    warm starts, no pruning) — used as the baseline in benchmarks.
    """

    def __init__(self, x_int: np.ndarray, f_vals: np.ndarray,
                 cfg: FWLConfig, quantizer: Quantizer, mae_t: float,
                 *, enabled: bool = True):
        super().__init__(x_int, f_vals, cfg, quantizer, mae_t)
        self.enabled = enabled
        self.hits = 0
        self.misses = 0
        self.pruned = 0
        self.warm_hits = 0
        self.spec_windows = 0   # windows fitted by speculative prefetch
        self.cross_warm_hits = 0  # warm hits on cross-NAF seeded candidates
        self.remez_batches = 0  # prefetch phase-0 batched exchange calls
        self.remez_batch_windows = 0  # fresh windows solved by those calls
        self._cache: Dict[Tuple[int, int], _Entry] = {}
        # per-start frontier of complete fits: (ends sorted asc, running-max
        # achievable MAE per end) — the containment lower bound.
        self._frontier: Dict[int, Tuple[List[int], List[float]]] = {}
        self._warm: Dict[int, Tuple[int, ...]] = {}
        self._cross_seeded: set = set()  # starts whose warm came from a peer
        # per-window Remez fit (coeffs, intercept): a window scanned once
        # (hint, probe, finalize, any MAE_t) never re-solves the exchange —
        # the candidate space it regenerates is identical by construction.
        self._areal: Dict[Tuple[int, int],
                          Tuple[np.ndarray, Optional[float]]] = {}
        # windows whose _areal came from a phase-0 speculative batch solve
        # and that no real scan has touched yet — excluded from phase-2
        # hints (the measured cheapest hint budget; the batch solve's
        # value is that the window's eventual *lead* scan skips the serial
        # exchange, not that it buys more speculation)
        self._phase0_only: set = set()
        f_q = round_half_away(self.f_vals * (1 << cfg.w_out)) \
            / (1 << cfg.w_out)
        self._qerr = np.abs(self.f_vals - f_q)

    # -- retargeting -----------------------------------------------------------
    def retarget(self, mae_t: float) -> None:
        """Change MAE_t without dropping cached fits (they are MAE_t-free
        facts about windows; only the ``ok`` verdict moves)."""
        self.mae_t = float(mae_t)

    # -- cross-NAF warm seeding ------------------------------------------------
    def seed_warm(self, donor_x_int: np.ndarray,
                  donor_warm: Dict[int, Tuple[int, ...]]) -> int:
        """Seed this evaluator's warm candidates from a *related* NAF's.

        ``donor_warm`` maps the donor's segment-start grid indices to its
        last satisfying coefficient sets; starts are translated by grid
        *value* (the intervals may differ — sigmoid vs sigmoid_wide), and
        only starts with no warm candidate of their own are seeded.  Safe
        by the same argument as ordinary warm starts: a seeded candidate
        is verified inside this window's own candidate space and can only
        short-circuit a scan that would have succeeded anyway — verdicts,
        and therefore segments, are unchanged.  Returns the number of
        starts seeded; hits are counted in ``cross_warm_hits``.
        """
        seeded = 0
        for ds, cand in donor_warm.items():
            if ds >= donor_x_int.size:
                continue
            x_val = donor_x_int[ds]
            pos = int(np.searchsorted(self.x_int, x_val))
            if pos >= self.x_int.size or self.x_int[pos] != x_val:
                continue
            if pos in self._warm:
                continue
            self._warm[pos] = cand
            self._cross_seeded.add(pos)
            seeded += 1
        return seeded

    # -- cache bookkeeping -----------------------------------------------------
    def _at_target(self, fit: SegmentFit) -> SegmentFit:
        return dataclasses.replace(
            fit, ok=bool(fit.mae <= self.mae_t + _EPS), evals=0,
            warm_hit=False)

    def _frontier_add(self, start: int, end: int, mae: float) -> None:
        ends, maes = self._frontier.setdefault(start, ([], []))
        i = bisect.bisect_left(ends, end)
        if i < len(ends) and ends[i] == end:
            maes[i] = max(maes[i], mae)
        else:
            ends.insert(i, end)
            maes.insert(i, mae)
        for j in range(max(i, 1), len(ends)):   # keep the running max
            if maes[j] < maes[j - 1]:
                maes[j] = maes[j - 1]

    def lower_bound(self, start: int, end: int,
                    frontier: bool = True) -> float:
        """Lower bound on the best achievable MAE of [start, end]: the
        window's quantization floor, and — when ``frontier`` — the best MAE
        of any *same-start* prefix window already scanned completely (see
        module docstring for why other starts are excluded).

        The frontier term assumes extending a window rightward can only
        grow its best achievable MAE.  That holds only approximately for
        quantized candidate spaces (each window's space is re-centered on
        its own Remez fit), which is exactly the slack the non-uniform
        segmenter's jump probes exploit — ``mode="probe"`` requests
        therefore ask for this bound with ``frontier=False``, keeping only
        the unconditionally sound quantization floor."""
        lb = float(self._qerr[start: end + 1].max())
        if not frontier:
            return lb
        fr = self._frontier.get(start)
        if fr is not None:
            ends, maes = fr
            i = bisect.bisect_right(ends, end) - 1
            if i >= 0 and maes[i] > lb:
                lb = maes[i]
        return lb

    def _cached_answer(self, start: int, end: int, mode: str):
        """What the cache can answer this request with — ``("hit", fit)``,
        ``("pruned", fit)`` or None (a real scan is needed).  The ONE
        predicate behind both ``evaluate``'s fast paths and ``prefetch``'s
        filter, so speculation can never drift from the cache policy."""
        ent = self._cache.get((start, end))
        if ent is not None and mode != "full":
            if ent.complete or (mode in ("feasible", "probe")
                                and ent.fit.mae <= self.mae_t + _EPS):
                return "hit", self._at_target(ent.fit)
        if mode in ("feasible", "probe"):
            lb = self.lower_bound(start, end,
                                  frontier=(mode == "feasible"))
            if lb > self.mae_t + _EPS:
                return "pruned", SegmentFit(
                    ok=False, mae=float(lb),
                    a_int=tuple(0 for _ in range(self.cfg.order)), b_int=0)
        return None

    # -- the evaluator entrypoint ----------------------------------------------
    def evaluate(self, start: int, end: int, mode: str = "feasible"
                 ) -> SegmentFit:
        if not self.enabled:
            return super().evaluate(start, end, mode)
        self.calls += 1
        answer = self._cached_answer(start, end, mode)
        if answer is not None:
            kind, fit = answer
            if kind == "hit":
                self.hits += 1
            else:
                self.pruned += 1
            return fit

        key = (start, end)
        warm = self._warm.get(start) if mode in ("feasible", "probe") \
            else None
        a_real, b_real = self._areal.get(key, (None, None))
        fit = self.quantizer.fit_segment(
            self.x_int[start: end + 1], self.f_vals[start: end + 1],
            self.cfg, self.mae_t, mode=_quant_mode(mode), a_warm=warm,
            a_real=a_real, b_real=b_real)
        self._record(start, end, fit, mode)
        return fit

    def _record(self, start: int, end: int, fit: SegmentFit,
                mode: str) -> None:
        """Book a real quantizer scan of [start, end] — the one miss path,
        shared by sequential evaluation and speculative prefetch so both
        feed the cache/frontier/warm state identically."""
        self.misses += 1
        self.points_touched += end - start + 1
        self.cand_evals += fit.evals
        if fit.a_real is not None:
            self._areal.setdefault((start, end), (fit.a_real, fit.b_real))
        self._phase0_only.discard((start, end))
        if fit.warm_hit:
            self.warm_hits += 1
            if start in self._cross_seeded:
                self.cross_warm_hits += 1
        if fit.ok:
            self._warm[start] = fit.a_int
            if not fit.warm_hit:
                self._cross_seeded.discard(start)
        # a feasible-mode scan that found nothing is exhaustive -> complete
        # (probe mode runs the same feasible scan, just unpruned)
        complete = mode not in ("feasible", "probe") or not fit.ok
        ent = self._cache.get((start, end))
        if ent is None or complete:
            self._cache[(start, end)] = _Entry(fit, complete)
            if complete:
                self._frontier_add(start, end, fit.mae)
        elif fit.mae < ent.fit.mae:
            self._cache[(start, end)] = _Entry(fit, False)  # tighter bound

    # -- speculative probe batching --------------------------------------------
    #: chunk budget for *successor* windows in a speculative batch.  The
    #: first window (the probe that is definitely evaluated next) scans
    #: unbounded; successors — of which at most one is visited — stop
    #: after this many chunks, so a mispredicted branch costs one chunk,
    #: not an exhaustive scan.  FQA orders candidates by |d| (d≈0 first),
    #: so feasible windows overwhelmingly resolve inside the warm probe or
    #: the first chunk and still turn into cache hits.
    SPEC_CHUNK_BUDGET = 1

    #: pre-solve the Remez exchange for every fresh window in a
    #: speculative plan as ONE ``fit_minimax_batch`` call (phase 0 below).
    #: Successor windows routinely become the leads of later probes, so
    #: by the time a window is actually scanned its exchange is already
    #: solved at the amortized batch rate instead of the ~0.65 ms serial
    #: rate.  ``False`` restores the prior on-demand policy (each lead
    #: pays a serial solve inside its scan); benchmarks flip this to
    #: measure the win.  Either way results are bit-identical: the
    #: batched exchange is bit-exact with the serial one.
    PREFETCH_FRESH_REMEZ = True

    #: max fresh windows per phase-0 batch (lead + the most likely
    #: successors); deeper plan entries are left for their own prefetch.
    PREFETCH_REMEZ_BATCH = 4

    def prefetch(self, windows: List[Tuple[int, int]],
                 mode: str = "feasible") -> None:
        """Fit every still-unanswered window in ONE batched dispatch.

        Windows the cache can already answer — a hit under the current
        MAE_t, or a monotone-pruning verdict — are skipped (the later
        ``evaluate`` call answers them for free either way).  The rest go
        through :meth:`Quantizer.fit_segments`, which runs their scans in
        lockstep and fuses each round's candidate blocks into one
        multi-window backend dispatch.  The leading window scans in full
        and is recorded exactly like a sequential miss; speculative
        successors scan under ``SPEC_CHUNK_BUDGET`` and are recorded as
        *partial* knowledge only (a satisfying candidate becomes a cache
        hit + warm seed; a truncated failure at most tightens an upper
        bound, never a verdict).  Only ever *adds* cache knowledge, so
        verdicts — and therefore TBW's chosen segments — are unchanged.
        """
        if not self.enabled or not windows:
            return
        # phase 0 — batch the Remez exchange for every announced window
        # that still needs both a fit and its pre-quantization
        # coefficients.  The per-iteration numpy dispatch overhead
        # amortizes across the stacked windows, so each solve costs a
        # fraction of the serial exchange — and since speculative
        # successors routinely become the leads of later probes, this is
        # where the compiler's last serial host loop actually drains:
        # phase 1 (and plain ``evaluate`` misses) find ``_areal`` already
        # populated and skip ``fit_minimax`` entirely.
        if self.PREFETCH_FRESH_REMEZ:
            fresh: List[Tuple[int, int]] = []
            seen: set = set()
            for s, e in windows:
                if (s, e) in seen:
                    continue
                seen.add((s, e))
                if (s, e) in self._areal or not self._needs_fit(s, e, mode):
                    continue
                fresh.append((s, e))
            # plan order is likelihood order: the lead first, then ever-
            # deeper speculative successors.  Deep successors rarely turn
            # into leads, so solving them is mostly waste — cap the batch
            # at the depths that pay for themselves.
            fresh = fresh[: self.PREFETCH_REMEZ_BATCH]
            if len(fresh) >= 2:     # a single window batches with itself
                scale = float(1 << self.cfg.w_in)
                fits = fit_minimax_batch(
                    [(self.x_int[s: e + 1].astype(np.float64) / scale,
                      self.f_vals[s: e + 1]) for s, e in fresh],
                    degree=self.cfg.order)
                for (s, e), (coeffs, b) in zip(fresh, fits):
                    self._areal[(s, e)] = (
                        np.asarray(coeffs, dtype=np.float64), float(b))
                    self._phase0_only.add((s, e))
                self.remez_batches += 1
                self.remez_batch_windows += len(fresh)
        # phase 1 — the leading window is the probe the sequential flow
        # evaluates next, so it scans in full through the solo path (warm
        # short-circuit + fused lookahead dispatches) and is recorded as
        # the miss it replaces.
        start, end = windows[0]
        if self._needs_fit(start, end, mode):
            self.spec_windows += 1
            warm = self._warm.get(start) if mode in ("feasible", "probe") \
                else None
            a_real, b_real = self._areal.get((start, end), (None, None))
            fit = self.quantizer.fit_segment(
                self.x_int[start: end + 1], self.f_vals[start: end + 1],
                self.cfg, self.mae_t, mode=_quant_mode(mode), a_warm=warm,
                a_real=a_real, b_real=b_real)
            self._record(start, end, fit, mode)
        # phase 2 — successor windows, re-filtered now that the primary's
        # outcome is known (a failed primary's frontier entry prunes the
        # grow branch for free).  Only windows a *real scan* has touched
        # before are hinted; a phase-0 batch solve alone does not qualify
        # (measured: hinting every fresh window triples the speculative
        # chunk dispatches and costs more than the batched exchange
        # saves — the phase-0 value is cashed in at the window's own lead
        # scan, not here).
        todo: List[Tuple[int, int]] = []
        warms: List[Optional[Tuple[int, ...]]] = []
        for s, e in windows[1:]:
            if (s, e) in todo or (s, e) == (start, end):
                continue
            if (s, e) not in self._areal or (s, e) in self._phase0_only:
                continue
            ent = self._cache.get((s, e))
            if ent is not None and ent.fit.truncated:
                continue    # already hinted once; don't re-pay its chunk
            if not self._needs_fit(s, e, mode):
                continue
            todo.append((s, e))
            warms.append(self._warm.get(s)
                         if mode in ("feasible", "probe") else None)
        if not todo:
            return
        self.spec_windows += len(todo)
        fits = self.quantizer.fit_segments(
            [(self.x_int[s: e + 1], self.f_vals[s: e + 1]) for s, e in todo],
            self.cfg, self.mae_t, mode=_quant_mode(mode), warms=warms,
            max_chunks=[self.SPEC_CHUNK_BUDGET] * len(todo),
            a_reals=[self._areal[w][0] for w in todo],
            b_reals=[self._areal[w][1] for w in todo])
        for (s, e), fit in zip(todo, fits):
            if fit.truncated:
                self._record_hint(s, e, fit)
            else:
                self._record(s, e, fit, mode)

    def _needs_fit(self, start: int, end: int, mode: str) -> bool:
        """Would :meth:`evaluate` run a real scan for this request right
        now?  (Shared predicate — no counters are charged here.)"""
        return self._cached_answer(start, end, mode) is None

    def _record_hint(self, start: int, end: int, fit: SegmentFit) -> None:
        """Book a budget-truncated speculative scan: real work (counters)
        but only *partial* knowledge — its MAE is an upper bound over a
        scanned prefix, so it may tighten a partial entry yet must never
        become a complete one or touch the frontier."""
        self.points_touched += end - start + 1
        self.cand_evals += fit.evals
        if fit.a_real is not None:
            self._areal.setdefault((start, end), (fit.a_real, fit.b_real))
        self._phase0_only.discard((start, end))
        ent = self._cache.get((start, end))
        if ent is None or (not ent.complete and fit.mae < ent.fit.mae):
            self._cache[(start, end)] = _Entry(fit, False)
