"""Coefficient quantizers: FQA (this paper) and the baselines it beats.

All quantizers share one contract: given a segment of the discrete input
grid and the target function, produce integer datapath coefficients and the
resulting MAE_hard, evaluated bit-exactly through the shared datapath code
path (``searchspace._block_metrics`` over ``datapath.horner_body``) on a
pluggable execution backend — numpy golden or torch on the card, bit-identical by
contract (``searchspace.resolve_backend``).

  * ``FQAQuantizer``    — full-space search over the truncation-induced
    offset range d (paper Eq. 4/5, Alg. 1/2), optional Hamming-weight
    constraint on the first-stage coefficient (FQA-Sm-On).
  * ``QPAQuantizer``    — round + per-coefficient ±1 fine-tuning [31].
  * ``PLACQuantizer``   — plain round quantization [26].
  * ``MLPLACQuantizer`` — PLAC with the slope word length bound to the
    shifter count (multiplierless) [29].

The intercept b is never searched: it is error-flattened then rounded
(Alg. 1 lines 7-9), for every candidate coefficient set.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .datapath import FWLConfig
from .fixed_point import hamming_weight, round_half_away
from .remez import fit_minimax, fit_minimax_batch
from .searchspace import SearchBackend, SegmentContext, resolve_backend

__all__ = [
    "SegmentFit",
    "Quantizer",
    "FQAQuantizer",
    "QPAQuantizer",
    "PLACQuantizer",
    "MLPLACQuantizer",
    "make_quantizer",
]

_EPS = 1e-12  # float-compare slack on MAE <= MAE_t tests


@dataclasses.dataclass
class SegmentFit:
    """Result of quantizing one segment."""

    ok: bool
    mae: float
    a_int: Tuple[int, ...]
    b_int: int
    mae0: float = np.inf          # max |f_q - h_q| (paper Eq. 7)
    n_satisfying: int = 0
    a_candidates: Optional[np.ndarray] = None  # (K, n) satisfying sets
    b_candidates: Optional[np.ndarray] = None  # (K,)
    evals: int = 0                # candidate evaluations performed
    warm_hit: bool = False        # satisfied by the warm-start candidate
    #: the scan stopped on a block budget (speculative prefetch) with
    #: candidates left unscanned and no satisfying set found: ``mae`` is an
    #: upper bound over the scanned prefix, NOT the space minimum, and the
    #: scan must not be treated as exhaustive.  Always False for plain
    #: ``fit_segment`` calls.
    truncated: bool = False
    #: the pre-quantization (Remez) coefficients this scan's candidate
    #: space was centered on — cached by the memoized evaluator so a
    #: window re-scanned later (speculative hint -> real probe, feasible
    #: probe -> best-mode finalize, MAE retargeting) skips the exchange
    #: solve and provably regenerates the identical candidate space.
    a_real: Optional[np.ndarray] = None
    #: the matching Remez intercept, cached for the same reason: non-
    #: flattening quantizers (PLAC) fix b from it, so a re-scan must not
    #: pay (or drift from) a second exchange solve.  ``None`` when the
    #: scan was seeded with ``a_real`` and never ran Remez itself.
    b_real: Optional[float] = None


class _SegmentScan:
    """Stepper over one segment's candidate space.

    Owns the chunk-loop state of :meth:`Quantizer.fit_segment` — warm-start
    short-circuit, first-stage chunking with later stages broadcast, early
    exit, full-mode candidate storage — so a single segment (sequential
    path) and many segments in lockstep (the speculative batched path) run
    the *same* scan.  The resulting :class:`SegmentFit` — including the
    ``evals``/``n_satisfying`` counters — is bit-identical either way,
    whichever backend executes the blocks.
    """

    def __init__(self, quantizer: "Quantizer", ctx: SegmentContext,
                 cands: List[np.ndarray], mae_t: float, mode: str,
                 a_warm: Optional[Tuple[int, ...]],
                 max_chunks: Optional[int] = None):
        self.q = quantizer
        self.ctx = ctx
        self.mae_t = float(mae_t)
        self.mode = mode
        self.max_chunks = max_chunks     # block budget (speculative scans)
        self.chunks_issued = 0
        self.truncated = False
        self.a_real: Optional[np.ndarray] = None   # set by _start_scan
        self.b_real: Optional[float] = None        # set by _start_scan
        n = ctx.cfg.order
        self.best = SegmentFit(False, np.inf, tuple(0 for _ in range(n)), 0)
        self.done = any(c.size == 0 for c in cands)  # empty candidate space
        self.evals = 0
        self.n_sat = 0
        self.sat_a: List[np.ndarray] = []
        self.sat_b: List[np.ndarray] = []
        self.stored_rows = 0
        # chunk over the first-stage candidates; later stages broadcast.
        self.first = cands[0] if not self.done else np.empty(0, np.int64)
        rest = cands[1:] if not self.done else []
        rest_grid = np.meshgrid(*rest, indexing="ij") if rest else []
        self.rest_flat = [g.reshape(-1) for g in rest_grid]  # (R,) each
        self.R = self.rest_flat[0].size if self.rest_flat else 1
        self.c0 = 0
        self._pending: List[Tuple[str, List[np.ndarray]]] = []
        # warm start: a candidate that was good for an overlapping window
        # is usually still good here; it must lie inside *this* segment's
        # candidate space so feasibility semantics stay identical.  A
        # *budgeted* (speculative-hint) scan skips the warm short-circuit
        # and spends its budget on the leading chunks directly — the warm
        # candidate almost always lives there anyway (FQA orders by |d|),
        # and the hint contract only needs verdict-soundness, not the
        # sequential scan's exact path.
        self._warm: Optional[Tuple[int, ...]] = None
        if (not self.done and a_warm is not None and mode == "feasible"
                and max_chunks is None and len(a_warm) == n
                and all((cands[i] == int(a_warm[i])).any()
                        for i in range(n))):
            self._warm = tuple(int(v) for v in a_warm)

    def next_block(self) -> Optional[List[np.ndarray]]:
        """The next candidate block to evaluate, or None when the scan is
        over.  Every returned block must be fed back through ``consume``
        (in order; modes without early exit may queue several blocks and
        consume them after a fused dispatch)."""
        if self.done:
            return None
        if self._warm is not None:
            warm, self._warm = self._warm, None
            a_list = [np.asarray([v], dtype=np.int64) for v in warm]
            self._pending.append(("warm", warm, a_list))
            return a_list
        if self.c0 >= self.first.size:
            self.done = True
            return None
        # block budget: warm probes are free, chunks are metered — a
        # budgeted scan that stops with candidates left is ``truncated``
        if (self.max_chunks is not None
                and self.chunks_issued >= self.max_chunks):
            self.truncated = True
            self.done = True
            return None
        self.chunks_issued += 1
        a0 = self.first[self.c0: self.c0 + self.q.chunk]     # (C,)
        self.c0 += self.q.chunk
        a_list = [np.repeat(a0, self.R)]        # (C*R,) per-stage vectors
        for rf in self.rest_flat:
            a_list.append(np.tile(rf, a0.size))
        self._pending.append(("chunk", None, a_list))
        return a_list

    def consume(self, mae: np.ndarray, b_int: np.ndarray,
                mae0: np.ndarray) -> None:
        kind, warm, a_list = self._pending.pop(0)
        self.evals += a_list[0].size
        if kind == "warm":
            if mae[0] <= self.mae_t + _EPS:
                self.best = SegmentFit(
                    ok=True, mae=float(mae[0]), a_int=warm,
                    b_int=int(b_int[0]), mae0=float(mae0[0]),
                    n_satisfying=1, evals=self.evals, warm_hit=True)
                self.done = True
            return
        k = int(np.argmin(mae))
        if mae[k] < self.best.mae:
            self.best = SegmentFit(
                ok=bool(mae[k] <= self.mae_t + _EPS),
                mae=float(mae[k]),
                a_int=tuple(int(a[k]) for a in a_list),
                b_int=int(b_int[k]),
                mae0=float(mae0[k]),
            )
        good = mae <= self.mae_t + _EPS
        ng = int(good.sum())
        self.n_sat += ng
        # cap on actually-accumulated rows: a block holds C*R candidates,
        # not ``chunk`` — counting chunks let extended order-2 scans buffer
        # far past the cap before the final slice trimmed them.
        if (self.mode == "full" and ng
                and self.stored_rows < self.q.store_cap):
            self.sat_a.append(np.stack([a[good] for a in a_list], axis=-1))
            self.sat_b.append(b_int[good])
            self.stored_rows += ng
        if self.mode == "feasible" and self.best.ok:
            self.done = True

    def result(self) -> SegmentFit:
        fit = self.best
        fit.a_real = self.a_real
        fit.b_real = self.b_real
        if fit.warm_hit:
            return fit
        fit.n_satisfying = self.n_sat
        fit.evals = self.evals
        fit.truncated = self.truncated
        if self.mode == "full" and self.sat_a:
            fit.a_candidates = np.concatenate(self.sat_a)[: self.q.store_cap]
            fit.b_candidates = np.concatenate(self.sat_b)[: self.q.store_cap]
        return fit


class Quantizer:
    """Base: candidate generation differs, evaluation is shared.

    ``backend`` selects the :mod:`~repro_torch.core.searchspace` execution
    backend for the candidate blocks (numpy golden / torch on the card); the scan
    itself — and therefore every returned fit — is backend-independent.
    """

    name = "base"
    #: error-flatten the intercept (Alg.1 lines 7-9).  PLAC quantizes the
    #: software-fitted b directly instead [26].
    flatten_b = True

    #: cap on the total candidate count of one fused lookahead dispatch —
    #: bounds how much speculative work an early exit can discard (order-2
    #: chunks hit the cap alone, so only their warm probe is fused in).
    LOOKAHEAD_CAND_CAP = 4096

    def __init__(self, chunk: int = 64, store_cap: int = 8192,
                 backend: "str | SearchBackend | None" = None,
                 lookahead: int = 0):
        self.chunk = chunk
        self.store_cap = store_cap
        self.search = resolve_backend(backend)
        #: effort counters: windows whose Remez exchange ran through one
        #: batched :func:`fit_minimax_batch` call in :meth:`fit_segments`
        self.remez_batch_calls = 0
        self.remez_batch_windows = 0
        #: feasible-scan speculative depth: fuse the warm probe and up to
        #: ``1 + lookahead`` chunks into one dispatch, consuming in order
        #: and discarding everything past the early exit — results and
        #: counters are bit-identical to the sequential scan; only the
        #: dispatch count (and some discarded device lanes) changes.
        self.lookahead = int(lookahead)

    # -- candidate generation (override) -------------------------------------
    def _candidates(self, a_real: np.ndarray, cfg: FWLConfig
                    ) -> List[np.ndarray]:
        raise NotImplementedError

    # -- shared evaluation ----------------------------------------------------
    def _start_scan(self, x_int, f_vals, cfg, mae_t, mode, a_real, a_warm,
                    max_chunks: Optional[int] = None,
                    b_real: Optional[float] = None
                    ) -> Tuple[_SegmentScan, SegmentContext]:
        n = cfg.order
        if a_real is None:
            x_f = x_int.astype(np.float64) / (1 << cfg.w_in)
            coeffs, b_real = fit_minimax(x_f, f_vals, degree=n)
            a_real = np.asarray(coeffs, dtype=np.float64)
        cands = self._candidates(a_real, cfg)
        b_fixed = 0
        if not self.flatten_b:
            if b_real is None:
                x_f = x_int.astype(np.float64) / (1 << cfg.w_in)
                _, b_real = fit_minimax(x_f, f_vals, degree=n)
            b_fixed = int(round_half_away(b_real * (1 << cfg.w_b)))
        ctx = self.search.context(x_int, f_vals, cfg,
                                  flatten_b=self.flatten_b, b_fixed=b_fixed)
        scan = _SegmentScan(self, ctx, cands, mae_t, mode, a_warm,
                            max_chunks=max_chunks)
        scan.a_real = np.asarray(a_real, dtype=np.float64)
        scan.b_real = b_real
        return scan, ctx

    def fit_segment(
        self,
        x_int: np.ndarray,
        f_vals: np.ndarray,
        cfg: FWLConfig,
        mae_t: float,
        mode: str = "feasible",
        a_real: Optional[np.ndarray] = None,
        a_warm: Optional[Tuple[int, ...]] = None,
        b_real: Optional[float] = None,
    ) -> SegmentFit:
        """Quantize one segment.

        Args:
          x_int: grid integers (G,), FWL cfg.w_in.
          f_vals: float64 target values at the grid points.
          mae_t: target MAE; ``ok`` means best MAE <= mae_t.
          mode: "feasible" (early-exit on first satisfying candidate),
                "best" (full scan, return argmin) or
                "full" (also collect all satisfying candidate sets).
          a_real: optional pre-quantization coefficients (skips Remez).
          a_warm: optional warm-start coefficient set (feasible mode only).
            If it lies inside this segment's candidate space and satisfies
            mae_t it is returned after a single evaluation; otherwise the
            normal scan runs.  Feasibility decisions are unchanged either
            way — a warm hit just proves existence with one eval.
          b_real: the Remez intercept paired with ``a_real`` (used by
            non-flattening quantizers; ignored when ``a_real`` is None).
        """
        scan, ctx = self._start_scan(x_int, f_vals, cfg, mae_t, mode,
                                     a_real, a_warm, b_real=b_real)
        if mode == "feasible" and self.lookahead > 0:
            # speculative lookahead: fetch the warm probe plus the next
            # chunks together, dispatch them fused, and stop consuming at
            # the early exit — unconsumed results are simply discarded, so
            # the fit (and every counter) is bit-identical to the
            # sequential scan below.
            while not scan.done:
                blocks = []
                cands = 0
                while len(blocks) < 2 + self.lookahead \
                        and cands < self.LOOKAHEAD_CAND_CAP:
                    blk = scan.next_block()
                    if blk is None:
                        break
                    blocks.append(blk)
                    cands += blk[0].size
                if not blocks:
                    break
                for out in self.search.eval_block_batch(ctx, blocks):
                    scan.consume(*out)
                    if scan.best.ok:    # satisfied: the sequential scan
                        break           # would never evaluate the rest
                scan._pending.clear()   # discard past the early exit
        elif mode == "feasible":
            # early exit possible: blocks must be evaluated one by one
            while True:
                blk = scan.next_block()
                if blk is None:
                    break
                scan.consume(*self.search.eval_block(ctx, blk))
        else:
            # no early exit ("best"/"full" scan the whole space): queue
            # every chunk and let the backend fuse them into grouped
            # dispatches; results are consumed in chunk order, so the fit
            # (argmin ties, store order, counters) is unchanged.
            blocks = []
            while True:
                blk = scan.next_block()
                if blk is None:
                    break
                blocks.append(blk)
            for out in self.search.eval_block_batch(ctx, blocks):
                scan.consume(*out)
        return scan.result()

    def fit_segments(
        self,
        windows: Sequence[Tuple[np.ndarray, np.ndarray]],
        cfg: FWLConfig,
        mae_t: float,
        mode: str = "feasible",
        warms: Optional[Sequence[Optional[Tuple[int, ...]]]] = None,
        max_chunks: Optional[Sequence[Optional[int]]] = None,
        a_reals: Optional[Sequence[Optional[np.ndarray]]] = None,
        b_reals: Optional[Sequence[Optional[float]]] = None,
    ) -> List[SegmentFit]:
        """Fit several windows in lockstep, dispatching each round's
        candidate blocks as ONE multi-window backend call.

        Windows advance independently (warm short-circuit, chunk order,
        early exit), so every per-window :class:`SegmentFit` — counters
        included — is bit-identical to a solo :meth:`fit_segment` call;
        only the dispatches are fused.  This is the execution primitive
        behind TBW speculative probe batching
        (:meth:`repro_torch.compiler.memo.MemoizedSegmentEvaluator.prefetch`).

        Windows arriving without pre-quantization coefficients (``a_reals``
        entry None) get them from ONE :func:`fit_minimax_batch` call — the
        batched exchange is bit-identical to the serial solve the solo path
        runs, so the candidate spaces (and fits) are unchanged; only the
        host time per fresh window drops.

        ``max_chunks`` optionally budgets each window's scan (None =
        unbounded): a budgeted window stops after that many candidate
        chunks (warm probes are free) and, if it neither satisfied MAE_t
        nor exhausted its space, returns a ``truncated`` fit — an upper
        bound usable as a cache hint, never as an exhaustive verdict.
        """
        warms = warms if warms is not None else [None] * len(windows)
        budgets = (max_chunks if max_chunks is not None
                   else [None] * len(windows))
        reals = list(a_reals) if a_reals is not None \
            else [None] * len(windows)
        breals = list(b_reals) if b_reals is not None \
            else [None] * len(windows)
        fresh = [i for i, r in enumerate(reals) if r is None]
        if fresh:
            fits = fit_minimax_batch(
                [(windows[i][0].astype(np.float64) / (1 << cfg.w_in),
                  windows[i][1]) for i in fresh],
                degree=cfg.order)
            for i, (coeffs, b) in zip(fresh, fits):
                reals[i] = np.asarray(coeffs, dtype=np.float64)
                breals[i] = b
            self.remez_batch_calls += 1
            self.remez_batch_windows += len(fresh)
        scans = [self._start_scan(x, f, cfg, mae_t, mode, real, warm,
                                  max_chunks=budget, b_real=breal)
                 for (x, f), warm, budget, real, breal
                 in zip(windows, warms, budgets, reals, breals)]
        while True:
            live = []
            for scan, ctx in scans:
                blk = scan.next_block()
                if blk is not None:
                    live.append((scan, ctx, blk))
            if not live:
                break
            outs = self.search.eval_block_multi(
                [(ctx, blk) for _, ctx, blk in live])
            for (scan, _, _), out in zip(live, outs):
                scan.consume(*out)
        return [scan.result() for scan, _ in scans]

    # -- helpers ---------------------------------------------------------------
    @staticmethod
    def _round_int(a_real: np.ndarray, w: Sequence[int]) -> List[int]:
        return [int(round_half_away(a * (1 << wi)))
                for a, wi in zip(a_real, w)]


def _centered(lo: int, hi: int) -> np.ndarray:
    """Integers lo..hi ordered by |d| (so early-exit hits d≈0 first)."""
    d = np.arange(lo, hi + 1, dtype=np.int64)
    return d[np.argsort(np.abs(d), kind="stable")]


class FQAQuantizer(Quantizer):
    """Full-space quantization search (the paper's contribution).

    extended=True uses the paper's extended range [-2^k, 2^{k+1}] (needed to
    cover the negative deviations of Table I and to enumerate equivalent
    optima); False uses the base [0, 2^k].
    weight_limit=m adds the FQA-Sm-On Hamming-weight constraint
    w_H(a_1,q) <= m (paper Eq. 11); weight_fn selects popcount vs CSD.
    """

    name = "fqa"

    def __init__(self, extended: bool = True,
                 weight_limit: Optional[int] = None,
                 weight_fn: Callable = hamming_weight,
                 **kw):
        super().__init__(**kw)
        self.extended = extended
        self.weight_limit = weight_limit
        self.weight_fn = weight_fn

    def _candidates(self, a_real, cfg):
        out = []
        for i in range(cfg.order):
            k = cfg.d_bits(i)
            base = int(np.floor(a_real[i] * (1 << cfg.w_a[i])))
            base = (base >> k) << k if k > 0 else base
            if self.extended:
                lo, hi = -(1 << k), (1 << (k + 1))
            else:
                lo, hi = 0, (1 << k)
            cand = base + _centered(lo, hi)
            if i == 0 and self.weight_limit is not None:
                cand = cand[self.weight_fn(cand) <= self.weight_limit]
            out.append(cand)
        return out


class QPAQuantizer(Quantizer):
    """Round + ±fine_tune offsets per coefficient (QPA [31])."""

    name = "qpa"

    def __init__(self, fine_tune: int = 1, **kw):
        super().__init__(**kw)
        self.fine_tune = fine_tune

    def _candidates(self, a_real, cfg):
        out = []
        for i in range(cfg.order):
            base = int(round_half_away(a_real[i] * (1 << cfg.w_a[i])))
            out.append(base + _centered(-self.fine_tune, self.fine_tune))
        return out


class PLACQuantizer(Quantizer):
    """Plain round quantization (PLAC [26]): no coefficient search and the
    software-fitted intercept is quantized directly (no error flattening)."""

    name = "plac"
    flatten_b = False

    def _candidates(self, a_real, cfg):
        return [np.array([int(round_half_away(a_real[i] * (1 << cfg.w_a[i])))],
                         dtype=np.int64)
                for i in range(cfg.order)]


class MLPLACQuantizer(Quantizer):
    """Multiplierless PLAC [29]: slope WL bound to the shifter count m.

    The effective first-stage coefficient grid is 2^-m; we round to the
    nearest representable value (and its neighbours, matching the paper's
    SQ-style slope quantization + intercept readjustment).
    """

    name = "mlplac"

    def __init__(self, m: int = 1, **kw):
        super().__init__(**kw)
        self.m = m

    def _candidates(self, a_real, cfg):
        out = []
        for i in range(cfg.order):
            w_eff = min(self.m, cfg.w_a[i]) if i == 0 else cfg.w_a[i]
            scale = cfg.w_a[i] - w_eff
            base = int(round_half_away(a_real[i] * (1 << w_eff))) << scale
            if i == 0:
                out.append(np.array(
                    [base, base + (1 << scale), base - (1 << scale)],
                    dtype=np.int64))
            else:
                out.append(np.array([base], dtype=np.int64))
        return out


def make_quantizer(name: str, **kw) -> Quantizer:
    table = {
        "fqa": lambda: FQAQuantizer(**kw),
        "fqa_fast": lambda: FQAQuantizer(extended=False, **kw),
        "qpa": lambda: QPAQuantizer(**kw),
        "plac": lambda: PLACQuantizer(**kw),
        "mlplac": lambda: MLPLACQuantizer(**kw),
    }
    try:
        return table[name]()
    except KeyError as e:
        raise KeyError(f"unknown quantizer {name!r}") from e
