"""Segmentation strategies: TBW (this paper), PLAC bisection, Sun sequential.

All operate over the discrete input grid (indices 0..NUM-1) and share a
``SegmentEvaluator`` that answers "can one polynomial cover grid[i..j]
within MAE_t?" through a pluggable quantizer.  Evaluator calls are counted
— the paper's Eq. (8)-(10) speedup claims are measured from these
counters.

TBW (target-guided bisection window, paper Fig. 5): a pre-estimated target
segment count tSEG gives a uniform window width INT = NUM/tSEG; segments
grow window-by-window while they fit and fall back to ceil-midpoint
bisection between the last good end (lp) and the first bad end (rp) once
they don't.  The degenerate single-point segment (rp == lp+1 shrink rule)
is handled, which PLAC's bisection misses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from .datapath import FWLConfig
from .quantize import Quantizer, SegmentFit

__all__ = [
    "Segment",
    "SegmentEvaluator",
    "tbw_segment",
    "nonuniform_segment",
    "bisection_segment",
    "sequential_segment",
    "estimate_tseg",
]


@dataclasses.dataclass
class Segment:
    start: int            # grid index, inclusive
    end: int              # grid index, inclusive
    fit: SegmentFit


class SegmentEvaluator:
    """Caches f on the grid and dispatches segment fits to the quantizer."""

    def __init__(self, x_int: np.ndarray, f_vals: np.ndarray,
                 cfg: FWLConfig, quantizer: Quantizer, mae_t: float):
        self.x_int = np.asarray(x_int, dtype=np.int64)
        self.f_vals = np.asarray(f_vals, dtype=np.float64)
        self.cfg = cfg
        self.quantizer = quantizer
        self.mae_t = float(mae_t)
        self.calls = 0          # segment evaluations
        self.cand_evals = 0     # candidate-set evaluations inside quantizer
        self.points_touched = 0

    @property
    def num(self) -> int:
        return self.x_int.size

    def evaluate(self, start: int, end: int, mode: str = "feasible"
                 ) -> SegmentFit:
        """Fit grid[start..end] inclusive.

        ``mode="probe"`` is a feasibility question asked without any
        monotone-containment prior: on this plain evaluator (which never
        prunes) it is identical to ``"feasible"``; the memoized evaluator
        answers it from sound cache facts only.  The non-uniform segmenter
        uses it for the jump probes whose whole point is that feasibility
        is *not* monotone in the window end.
        """
        self.calls += 1
        self.points_touched += end - start + 1
        fit = self.quantizer.fit_segment(
            self.x_int[start: end + 1], self.f_vals[start: end + 1],
            self.cfg, self.mae_t,
            mode="feasible" if mode == "probe" else mode)
        self.cand_evals += fit.evals
        return fit

    def prefetch(self, windows: List[Tuple[int, int]],
                 mode: str = "feasible") -> None:
        """Hint that ``windows`` are about to be evaluated.

        The plain evaluator has nowhere to keep speculative results, so
        this is a no-op — TBW with ``speculate > 0`` simply degrades to
        the sequential probe order.  The memoized evaluator
        (:class:`repro_torch.compiler.memo.MemoizedSegmentEvaluator`) overrides
        it to fit all still-unanswered windows as one batched multi-window
        dispatch and park the fits in its cache.
        """


def _finalize(ev: SegmentEvaluator, start: int, end: int,
              final_mode: str) -> Segment:
    fit = ev.evaluate(start, end, mode=final_mode)
    if not fit.ok:
        raise RuntimeError(
            f"segment [{start},{end}] regressed on final fit — "
            "feasible/best mode disagreement (bug)")
    return Segment(start, end, fit)


def _tbw_successors(lp: int, rp: int, ep: int, rflag: int,
                    interval: int, num: int
                    ) -> Tuple[Optional[Tuple[int, int, int, int]],
                               Optional[Tuple[int, int, int, int]]]:
    """The two possible next inner-loop states after probing ``ep``.

    A pure mirror of the transitions in :func:`tbw_segment`'s inner loop —
    returns ``(on_success, on_failure)`` as ``(lp, rp, ep, rflag)`` tuples,
    or None where the loop would exit (success at ``rp``) or raise (the
    single-point-infeasible error path).  The speculative probe planner
    walks this to know which windows the sequential flow can visit next.
    """
    if ep == rp:
        ok_state = None                         # inner loop exits
    else:
        lp2 = ep
        if rflag == 1 and ep <= num - 1 - interval:
            ep2 = ep + interval
        else:
            ep2 = (lp2 + rp + 1) // 2
        ok_state = (lp2, rp, ep2, rflag)
    rp2 = rp - 1 if rp == lp + 1 else ep - 1
    if rp2 < lp:
        fail_state = None                       # would raise (infeasible)
    else:
        fail_state = (lp, rp2, (lp + rp2 + 1) // 2, 0)
    return ok_state, fail_state


def _speculative_windows(sp: int, lp: int, rp: int, ep: int, rflag: int,
                         interval: int, num: int, depth: int
                         ) -> List[Tuple[int, int]]:
    """The probe about to run plus every window the inner loop can reach
    within ``depth`` further steps: the grow window and the bisection
    midpoints it would visit on failure, deduplicated, probe-order first."""
    wins = [(sp, ep)]
    seen = {(sp, ep)}
    frontier = [(lp, rp, ep, rflag)]
    for _ in range(depth):
        nxt = []
        for state in frontier:
            for succ in _tbw_successors(*state, interval=interval, num=num):
                if succ is None:
                    continue
                nxt.append(succ)
                w = (sp, succ[2])
                if w not in seen:
                    seen.add(w)
                    wins.append(w)
        frontier = nxt
    return wins


def tbw_segment(ev: SegmentEvaluator, tseg: int,
                final_mode: str = "best",
                max_segments: Optional[int] = None,
                speculate: int = 0) -> List[Segment]:
    """Target-guided bisection window segmentation (paper Fig. 5).

    ``speculate > 0`` turns on speculative probe batching: before each
    inner-loop probe, the windows reachable within ``speculate`` further
    steps (grow window + failure-path bisection midpoints) are prefetched
    through ``ev.prefetch`` — one batched multi-window dispatch on a
    memoized evaluator — so the sequential probes below become cache hits.
    The control flow itself never changes: probes are still issued one by
    one in the paper's order, so the chosen segments are identical to the
    unbatched path (asserted by the tests).
    """
    num = ev.num
    if tseg <= 0:
        raise ValueError("tseg must be positive")
    interval = max(1, num // tseg)   # INT, uniform window width

    segments: List[Segment] = []
    j = 0                # start of the remaining interval (0-based)
    ep = -1              # carried across segments per the paper's flow
    while j < num:
        lp, rp = j, num - 1
        sp = j
        rflag = 1
        # initial window: one uniform stride past the previous end
        if ep < num - 1 - interval:
            ep = ep + interval
        else:
            ep = (lp + rp + 1) // 2
        ep = max(ep, sp)
        while True:
            if speculate > 0:
                ev.prefetch(_speculative_windows(
                    sp, lp, rp, ep, rflag, interval, num, speculate))
            fit = ev.evaluate(sp, ep, mode="feasible")
            if fit.ok:
                if ep == rp:
                    break  # inner loop done: widest feasible end found
                lp = ep
                if rflag == 1 and ep <= num - 1 - interval:
                    ep = ep + interval
                else:
                    ep = (lp + rp + 1) // 2
            else:
                if rp == lp + 1:
                    rp -= 1
                else:
                    rp = ep - 1
                rflag = 0
                if rp < lp:
                    raise RuntimeError(
                        f"MAE_t={ev.mae_t} unachievable at single grid point "
                        f"{sp} — no segmentation exists for this FWL config")
                ep = (lp + rp + 1) // 2
        segments.append(_finalize(ev, sp, ep, final_mode))
        if max_segments is not None and len(segments) > max_segments:
            raise RuntimeError(f"exceeded max_segments={max_segments}")
        j = ep + 1
    return segments


def _greedy_end(ev: SegmentEvaluator, sp: int, interval: int, num: int,
                speculate: int = 0) -> int:
    """TBW's inner loop (paper Fig. 5) for one segment starting at ``sp``:
    the widest end the grow-then-bisect flow finds.  Runs in ``probe``
    mode — the non-uniform searcher must see raw verdicts, not verdicts
    filtered through the memo's monotone-containment prior, so its result
    is identical on plain and memoized evaluators by construction."""
    lp, rp = sp, num - 1
    rflag = 1
    prev = sp - 1                       # tbw carries ep across segments
    if prev < num - 1 - interval:
        ep = prev + interval
    else:
        ep = (lp + rp + 1) // 2
    ep = max(ep, sp)
    while True:
        if speculate > 0:
            ev.prefetch(_speculative_windows(
                sp, lp, rp, ep, rflag, interval, num, speculate),
                mode="probe")
        if ev.evaluate(sp, ep, mode="probe").ok:
            if ep == rp:
                return ep
            lp = ep
            if rflag == 1 and ep <= num - 1 - interval:
                ep = ep + interval
            else:
                ep = (lp + rp + 1) // 2
        else:
            if rp == lp + 1:
                rp -= 1
            else:
                rp = ep - 1
            rflag = 0
            if rp < lp:
                raise RuntimeError(
                    f"MAE_t={ev.mae_t} unachievable at single grid point "
                    f"{sp} — no segmentation exists for this FWL config")
            ep = (lp + rp + 1) // 2


def _jump_probe(ev: SegmentEvaluator, sp: int, end: int, jump: int,
                num: int) -> int:
    """Push a segment past its greedy-maximal end.

    TBW (and PLAC's bisection) treat one failed end as excluding every
    longer end — sound only if feasibility is monotone in the window end.
    Quantized candidate spaces are re-centered on each window's own Remez
    fit, so feasibility is *not* monotone: a window can fail at ``end+1``
    yet fit at ``end+3``.  Probe up to ``jump`` grid points past the
    farthest feasible end found so far and keep the farthest feasible
    one; give up after ``stall`` consecutive infeasible probes —
    infeasibility pockets are narrow (measured on the Table II NAFs the
    stall cutoff loses no extensions), and it caps the dead-probe cost on
    quantizers whose scans are expensive precisely because they rarely
    leave pockets (FQA: an infeasible probe is an exhaustive scan of a
    huge candidate space).  Probes run in ``probe`` mode (no monotone
    pruning) and are announced through ``ev.prefetch`` so a memoized
    evaluator batches their Remez exchanges."""
    stall = max(8, jump // 2)
    best = end
    p = end + 1
    fails = 0
    while p < num and p <= best + jump and fails < stall:
        hi = min(num - 1, best + jump)
        ev.prefetch([(sp, q) for q in range(p, hi + 1)], mode="probe")
        if ev.evaluate(sp, p, mode="probe").ok:
            best = p
            fails = 0
        else:
            fails += 1
        p += 1
    return best


def _refine_balance(ev: SegmentEvaluator, bounds: List[Tuple[int, int]],
                    max_moves: int) -> Tuple[List[Tuple[int, int]], int]:
    """Local boundary refinement: error balancing by single-point moves.

    Repeatedly take the segment with the worst best-achievable MAE and try
    handing one of its boundary points to a neighbor; accept the move that
    most reduces the pair's max MAE, stop when the worst segment cannot be
    improved (or the move budget runs out).  Since an accepted pair max is
    strictly below the old worst MAE — itself <= MAE_t — feasibility of
    both touched segments is preserved by construction.  Segment count
    never changes (single-point donors are never emptied)."""
    if len(bounds) < 2 or max_moves <= 0:
        return bounds, 0
    bounds = list(bounds)
    maes = [ev.evaluate(s, e, mode="best").mae for s, e in bounds]
    moves = 0
    while moves < max_moves:
        w = max(range(len(bounds)), key=lambda i: (maes[i], -i))
        s, e = bounds[w]
        best_move = None            # (pair_max, tag, mae_nbr, mae_w)
        if s < e:
            if w > 0:               # donate the first point leftward
                ls, _ = bounds[w - 1]
                pm_l = ev.evaluate(ls, s, mode="best").mae
                pm_w = ev.evaluate(s + 1, e, mode="best").mae
                pm = max(pm_l, pm_w)
                if pm < maes[w]:
                    best_move = (pm, "L", pm_l, pm_w)
            if w < len(bounds) - 1:  # donate the last point rightward
                _, re = bounds[w + 1]
                pm_w = ev.evaluate(s, e - 1, mode="best").mae
                pm_r = ev.evaluate(e, re, mode="best").mae
                pm = max(pm_w, pm_r)
                if pm < maes[w] and (best_move is None or pm < best_move[0]):
                    best_move = (pm, "R", pm_r, pm_w)
        if best_move is None:
            break
        _, tag, mae_nbr, mae_w = best_move
        if tag == "L":
            ls, _ = bounds[w - 1]
            bounds[w - 1] = (ls, s)
            bounds[w] = (s + 1, e)
            maes[w - 1] = mae_nbr
        else:
            _, re = bounds[w + 1]
            bounds[w] = (s, e - 1)
            bounds[w + 1] = (e, re)
            maes[w + 1] = mae_nbr
        maes[w] = mae_w
        moves += 1
    return bounds, moves


def nonuniform_segment(ev: SegmentEvaluator, tseg: int,
                       final_mode: str = "best",
                       max_segments: Optional[int] = None,
                       speculate: int = 0,
                       jump: Optional[int] = None,
                       refine_passes: int = 2,
                       report: Optional[dict] = None) -> List[Segment]:
    """Non-uniform breakpoint search (the Flex-SFU direction).

    A breakpoint-placement outer loop around the TBW/full-space search:

    1. **seed** — the uniform-window TBW result (paper Fig. 5), which
       fixes the probe stride and, on a memoized evaluator, warms the
       window cache;
    2. **greedy error-balancing re-split with jump probing** — segments
       are regrown left to right (seed ends are reused while boundaries
       still coincide), and each greedy-maximal end is pushed through
       :func:`_jump_probe`: TBW's monotone-feasibility assumption is
       exactly what quantized candidate spaces violate, so probing up to
       ``jump`` grid points past a failed end recovers longer feasible
       segments and every later breakpoint shifts right — this is where
       the segment-count reduction comes from;
    3. **local boundary refinement** — bounded error-balancing passes
       (:func:`_refine_balance`, ``refine_passes * num_segments`` move
       budget) that shift single grid points out of the worst segment
       while the pairwise max MAE strictly decreases.

    All search queries run in ``probe`` mode, which a memoized evaluator
    answers from sound cache facts only (no monotone-containment prior) —
    the chosen segments are identical on plain and memoized evaluators.
    ``jump`` defaults to the grid-proportional horizon ``num // 32`` (at
    least 16).  ``report``, if given, receives ``uniform_segments`` /
    ``jump_extensions`` / ``refine_moves``.
    """
    num = ev.num
    if tseg <= 0:
        raise ValueError("tseg must be positive")
    interval = max(1, num // tseg)   # INT, uniform window width
    if jump is None:
        # grid-proportional probe horizon: far enough past a failed end to
        # clear the quantization-induced infeasibility pockets (measured:
        # counts plateau near num/32 on the Table II NAFs), independent of
        # how fine the uniform stride happens to be.
        jump = max(16, num // 32)
    jump = max(1, int(jump))

    seed = tbw_segment(ev, tseg, final_mode="feasible",
                       max_segments=max_segments, speculate=speculate)
    seed_end = {s.start: s.end for s in seed}

    bounds: List[Tuple[int, int]] = []
    extensions = 0
    j = 0
    while j < num:
        e = seed_end.get(j)
        if e is None:
            e = _greedy_end(ev, j, interval, num, speculate=speculate)
        e2 = _jump_probe(ev, j, e, jump, num)
        extensions += e2 - e
        bounds.append((j, e2))
        if max_segments is not None and len(bounds) > max_segments:
            raise RuntimeError(f"exceeded max_segments={max_segments}")
        j = e2 + 1

    bounds, moves = _refine_balance(
        ev, bounds, max_moves=refine_passes * len(bounds))

    if report is not None:
        report["uniform_segments"] = len(seed)
        report["jump_extensions"] = int(extensions)
        report["refine_moves"] = int(moves)
    return [_finalize(ev, s, e, final_mode) for s, e in bounds]


def bisection_segment(ev: SegmentEvaluator,
                      final_mode: str = "best") -> List[Segment]:
    """PLAC-style bisection [26]: full-interval window per segment."""
    num = ev.num
    segments: List[Segment] = []
    j = 0
    while j < num:
        sp = j
        # whole remaining interval first
        if ev.evaluate(sp, num - 1, mode="feasible").ok:
            segments.append(_finalize(ev, sp, num - 1, final_mode))
            break
        lo, hi = sp, num - 1          # lo: ok (single point assumed), hi: bad
        if not ev.evaluate(sp, sp, mode="feasible").ok:
            raise RuntimeError(
                f"MAE_t={ev.mae_t} unachievable at single grid point {sp}")
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if ev.evaluate(sp, mid, mode="feasible").ok:
                lo = mid
            else:
                hi = mid
        segments.append(_finalize(ev, sp, lo, final_mode))
        j = lo + 1
    return segments


def sequential_segment(ev: SegmentEvaluator,
                       final_mode: str = "best") -> List[Segment]:
    """Sun et al. [25]: walk the end point back from the interval end."""
    num = ev.num
    segments: List[Segment] = []
    j = 0
    while j < num:
        sp = j
        ep = num - 1
        while ep > sp and not ev.evaluate(sp, ep, mode="feasible").ok:
            ep -= 1
        if ep == sp and not ev.evaluate(sp, ep, mode="feasible").ok:
            raise RuntimeError(
                f"MAE_t={ev.mae_t} unachievable at single grid point {sp}")
        segments.append(_finalize(ev, sp, ep, final_mode))
        j = ep + 1
    return segments


def estimate_tseg(ev: SegmentEvaluator,
                  final_mode: str = "feasible") -> Tuple[int, int]:
    """Paper step 1: the segment count of a reference run with the search
    disabled (d=0, i.e. a plain-rounding quantizer behind ``ev``) bounds the
    target; tSEG = 2^round(log2(SEG_ref)) clamped to >= 1.

    This is the one shared implementation of the reference-run heuristic —
    both the compiler (repro_torch.compiler.compile_table) and callers that want
    the estimate directly go through it.  If MAE_t is unreachable for the
    reference quantizer somewhere on the grid, the d=0 run has no valid
    segmentation; fall back to a dense-but-bounded target.

    Returns (tseg, seg_ref).
    """
    try:
        seg_ref = len(bisection_segment(ev, final_mode=final_mode))
    except RuntimeError:
        seg_ref = max(4, ev.num // 8)  # d=0 infeasible somewhere
    tseg = 1 << max(0, int(round(math.log2(max(1, seg_ref)))))
    return tseg, seg_ref
