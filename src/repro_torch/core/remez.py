"""Minimax polynomial fitting (discrete Remez exchange) — serial and batched.

Produces the *pre-quantization* coefficients the FQA quantizer starts from.
Per the paper (Sec. III-C): because FQA searches the full low-bit offset
space, only the coefficient bits above the search space need to be accurate,
so a handful of exchange iterations suffices.

Coefficient order matches the paper's Horner form (Eq. 1):
    h(x) = (...((a1*x + a2)*x + a3)...)*x + b
i.e. ``coeffs = [a1, ..., an]`` (a1 multiplies x**n) and the constant ``b``.

Two entrypoints share one algorithm:

  * :func:`fit_minimax` — one window (the seed path, op-for-op unchanged).
  * :func:`fit_minimax_batch` — W windows at once.  The exchange state
    (reference indices, coefficients, best-so-far) is carried per window;
    each iteration stacks the active windows' Vandermonde systems into one
    ``(W, m, m)`` ``np.linalg.solve`` (numpy's batched gufunc runs the same
    LAPACK routine per matrix as the 2-D call, so the solution bits match),
    evaluates all error signals in one vectorized Horner pass over an
    edge-padded grid stack, and parks windows whose reference set stopped
    moving while stragglers keep iterating.

**Bit-exactness is the contract, not an aspiration**: every elementwise op
in the batched path (subtract, multiply-accumulate Vandermonde, Horner,
abs/max over the real grid points) computes the same IEEE-754 operation on
the same operands as the serial path, the batched LAPACK solve is the same
per-matrix routine, and the extrema exchange runs the shared
:func:`_pick_extrema`.  The paper-table artifacts pin ``fit_minimax``
outputs (candidate spaces are centered on them), so
the tests assert byte-equality of the two paths, and with the JAX
package's copy, across the NAF zoo.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["fit_minimax", "fit_minimax_batch", "horner", "chebyshev_init"]


def horner(coeffs: Sequence[float], b: float, x: np.ndarray) -> np.ndarray:
    """Evaluate the paper-form polynomial at ``x`` (float64)."""
    x = np.asarray(x, dtype=np.float64)
    if len(coeffs) == 0:        # degree-0: constant-only polynomial
        return np.full_like(x, float(b))
    h = np.full_like(x, float(coeffs[0]))
    for c in coeffs[1:]:
        h = h * x + float(c)
    return h * x + float(b)


def chebyshev_init(x: np.ndarray, f: np.ndarray, degree: int) -> np.ndarray:
    """Least-squares polynomial init (power basis, highest degree first)."""
    # Vandermonde least squares is plenty stable for degree <= 3 on the
    # short, shifted segments PPA uses (we centre x for conditioning).
    x = np.asarray(x, dtype=np.float64)
    mid = 0.5 * (x.max() + x.min()) if x.size else 0.0
    xc = x - mid
    V = np.vander(xc, degree + 1)  # columns: xc^degree ... xc^0
    sol, *_ = np.linalg.lstsq(V, f, rcond=None)
    # shift back: p(xc) = p(x - mid) -> expand into power basis of x
    return _shift_poly(sol, -mid)


def _shift_poly(coeffs_high_first: np.ndarray, shift: float) -> np.ndarray:
    """Return coefficients (high first) of q(x) = p(x + shift)."""
    p = np.polynomial.Polynomial(np.asarray(coeffs_high_first)[::-1])
    q = p(np.polynomial.Polynomial([shift, 1.0]))
    out = np.zeros(len(coeffs_high_first))
    out[: len(q.coef)] = q.coef[: len(out)]
    return out[::-1]  # back to high-first


def _shift_poly_batch(coeffs_high_first: np.ndarray,
                      shift: np.ndarray) -> np.ndarray:
    """Row-wise :func:`_shift_poly`: q_w(x) = p_w(x + shift_w).

    Mirrors the polynomial-composition Horner that
    ``np.polynomial.Polynomial`` runs under the hood — ``acc = c[-i] +
    acc * (shift + x)`` where the multiply is a convolution with
    ``[shift, 1]`` — so every coefficient is the same two-term
    multiply-add the serial path computes (two-term float sums are
    order-insensitive, hence bit-identical).
    """
    c = np.asarray(coeffs_high_first, dtype=np.float64)
    W, n = c.shape
    s = np.asarray(shift, dtype=np.float64)
    # low-first composition state, grown one degree per step
    acc = c[:, :1].copy()                       # highest coefficient
    for i in range(1, n):
        nxt = np.zeros((W, acc.shape[1] + 1))
        nxt[:, :-1] = acc * s[:, None]          # conv with [shift, 1]:
        nxt[:, 1:] += acc                       #   out[k] = a[k]*s + a[k-1]
        nxt[:, 0] += c[:, i]                    # + next lower coefficient
        acc = nxt
    return acc[:, ::-1]                         # back to high-first


def _vander_batch(x: np.ndarray, ncols: int) -> np.ndarray:
    """Row-wise ``np.vander`` (decreasing powers), (W, m) -> (W, m, ncols).

    Same cumulative-product construction numpy uses, so each power carries
    the identical rounding chain.
    """
    W, m = x.shape
    v = np.empty((W, m, ncols))
    inc = v[..., ::-1]
    inc[..., 0] = 1.0
    if ncols > 1:
        inc[..., 1:] = x[..., None]
        np.multiply.accumulate(inc[..., 1:], out=inc[..., 1:], axis=-1)
    return v


def _polyval_batch(coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Row-wise ``np.polyval`` (same Horner chain), (W, n) x (W, G)."""
    y = np.zeros_like(x)
    for k in range(coeffs.shape[1]):
        y = y * x + coeffs[:, k, None]
    return y


@functools.lru_cache(maxsize=512)
def _initial_reference_cached(G: int, m: int) -> np.ndarray:
    t = np.cos(np.pi * np.arange(m)[::-1] / (m - 1))  # [-1, 1]
    idx = np.unique(np.round((t + 1) / 2 * (G - 1)).astype(int))
    while idx.size < m:  # ensure m distinct indices
        missing = np.setdiff1d(np.arange(G), idx)
        idx = np.sort(np.concatenate([idx, missing[: m - idx.size]]))
    idx.setflags(write=False)
    return idx


def _initial_reference(G: int, m: int) -> np.ndarray:
    """Chebyshev-like spread of ``m`` distinct grid indices in [0, G).

    Deterministic in (G, m), so memoized — windows in a table sweep reuse
    a handful of grid sizes.  The cached array is read-only; callers only
    rebind, never mutate.
    """
    return _initial_reference_cached(G, m)


def _degenerate_fit(x: np.ndarray, f: np.ndarray, degree: int
                    ) -> Tuple[np.ndarray, float]:
    """G <= ncoef: interpolate exactly through the available points."""
    ncoef = degree + 1
    G = x.size
    if G == 0:
        return np.zeros(max(degree, 0)), 0.0
    deg_eff = G - 1
    cs = np.polyfit(x, f, deg_eff) if deg_eff > 0 else np.array([f[0]])
    full = np.zeros(ncoef)
    full[ncoef - len(cs):] = cs
    return full[:-1], float(full[-1])


def fit_minimax(
    x: np.ndarray,
    f: np.ndarray,
    degree: int,
    max_iter: int = 12,
) -> Tuple[np.ndarray, float]:
    """Discrete minimax fit of a degree-``degree`` polynomial on grid points.

    Returns ``(coeffs, b)`` in paper order ([a1..an], b).  For degenerate
    grids (fewer points than coefficients) falls back to interpolation /
    constants — those segments are exactly representable anyway.
    """
    x = np.asarray(x, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64)
    G = x.size
    ncoef = degree + 1

    if G <= ncoef:
        return _degenerate_fit(x, f, degree)

    # --- Remez exchange on the discrete grid --------------------------------
    # reference set: chebyshev-like spread of n+2 grid indices
    m = ncoef + 1
    idx = _initial_reference(G, m)
    signs = np.power(-1.0, np.arange(m))

    # the least-squares init only ever surfaces when the very first
    # exchange solve is singular (best is replaced by any finite emax), so
    # it is computed lazily on that rare path instead of per call.
    best: Tuple[float, Optional[np.ndarray]] = (np.inf, None)
    for _ in range(max_iter):
        xr, fr = x[idx], f[idx]
        # solve p(xr_i) + (-1)^i E = fr_i
        V = np.vander(xr - xr.mean(), ncoef)
        A = np.concatenate([V, signs[:, None]], axis=1)
        try:
            sol = np.linalg.solve(A, fr)
        except np.linalg.LinAlgError:
            break
        c_shift = sol[:ncoef]
        coeffs = _shift_poly(c_shift, -xr.mean())
        err = np.polyval(coeffs, x) - f
        emax = float(np.max(np.abs(err)))
        if emax < best[0]:
            best = (emax, coeffs.copy())
        # multi-point exchange: local extrema of the error with alternating sign
        new_idx = _pick_extrema(err, m)
        if new_idx is None or np.array_equal(new_idx, idx):
            break
        idx = new_idx

    coeffs = best[1] if best[1] is not None else chebyshev_init(x, f, degree)
    return coeffs[:-1], float(coeffs[-1])


def fit_minimax_batch(
    windows: Sequence[Tuple[np.ndarray, np.ndarray]],
    degree: int,
    max_iter: int = 12,
) -> List[Tuple[np.ndarray, float]]:
    """:func:`fit_minimax` over W ``(x, f)`` windows in one batched exchange.

    Returns ``[(coeffs, b), ...]`` in window order, bit-identical to W
    serial calls.  Windows advance in lockstep: each iteration solves all
    still-active reference systems as one stacked ``(Wa, m, m)`` LAPACK
    dispatch and evaluates all error signals as one vectorized Horner over
    the padded grid stack; a window whose reference set converges parks
    (its state frozen) while the rest iterate.  Degenerate windows
    (``G <= ncoef``) take the serial interpolation fallback directly.
    """
    ncoef = degree + 1
    m = ncoef + 1
    out: List[Optional[Tuple[np.ndarray, float]]] = [None] * len(windows)

    # split off degenerate windows (serial fallback, rare and tiny)
    live: List[int] = []
    xs: List[np.ndarray] = []
    fs: List[np.ndarray] = []
    for w, (x, f) in enumerate(windows):
        x = np.asarray(x, dtype=np.float64)
        f = np.asarray(f, dtype=np.float64)
        if x.size <= ncoef:
            out[w] = _degenerate_fit(x, f, degree)
        else:
            live.append(w)
            xs.append(x)
            fs.append(f)
    if not live:
        return out                                  # type: ignore[return-value]

    W = len(live)
    sizes = np.array([x.size for x in xs])
    Gmax = int(sizes.max())
    xpad = np.empty((W, Gmax))
    fpad = np.empty((W, Gmax))
    for j, (x, f) in enumerate(zip(xs, fs)):
        xpad[j, : x.size] = x
        xpad[j, x.size:] = x[-1]        # edge-pad; masked out of reductions
        fpad[j, : f.size] = f
        fpad[j, f.size:] = f[-1]
    gmask = np.arange(Gmax)[None, :] < sizes[:, None]
    signs = np.power(-1.0, np.arange(m))

    idx = np.stack([_initial_reference(int(g), m) for g in sizes])  # (W, m)
    best_e = np.full(W, np.inf)
    best_c: List[Optional[np.ndarray]] = [None] * W
    active = np.arange(W)

    for _ in range(max_iter):
        if active.size == 0:
            break
        xa, fa = xpad[active], fpad[active]
        ia = idx[active]
        rows = np.arange(active.size)[:, None]
        xr = xa[rows, ia]                               # (Wa, m) gather
        fr = fa[rows, ia]
        mu = xr.mean(axis=1)                            # per-row == 1-D mean
        V = _vander_batch(xr - mu[:, None], ncoef)      # (Wa, m, ncoef)
        A = np.concatenate(
            [V, np.broadcast_to(signs[None, :, None],
                                (active.size, m, 1))], axis=2)
        solved = np.ones(active.size, dtype=bool)
        try:
            # batched gufunc: the same per-matrix LAPACK routine (nrhs=1)
            # the serial 2-D call dispatches, so solution bits match
            sol = np.linalg.solve(A, fr[..., None])[..., 0]
        except np.linalg.LinAlgError:
            sol = np.zeros((active.size, m))
            for j in range(active.size):
                try:
                    sol[j] = np.linalg.solve(A[j], fr[j])
                except np.linalg.LinAlgError:
                    solved[j] = False                   # serial would break
        coeffs = _shift_poly_batch(sol[:, :ncoef], -mu)
        err = _polyval_batch(coeffs, xa) - fa
        emax = np.where(gmask[active], np.abs(err), -np.inf).max(axis=1)

        improved = solved & (emax < best_e[active])
        for j in np.flatnonzero(improved):
            w = int(active[j])
            best_e[w] = emax[j]
            best_c[w] = coeffs[j].copy()

        keep = []
        for j in range(active.size):
            if not solved[j]:
                continue
            w = int(active[j])
            new_idx = _pick_extrema(err[j, : sizes[w]], m)
            if new_idx is None or bool((new_idx == idx[w]).all()):
                continue                                # converged: park
            idx[w] = new_idx
            keep.append(w)
        active = np.asarray(keep, dtype=int)

    for j, w in enumerate(live):
        c = best_c[j]
        if c is None:           # first solve singular: serial's lazy init
            c = chebyshev_init(xs[j], fs[j], degree)
        out[w] = (c[:-1], float(c[-1]))
    return out                                          # type: ignore[return-value]


def _pick_extrema(err: np.ndarray, m: int) -> Optional[np.ndarray]:
    """Pick m alternating-sign extrema indices of the error signal.

    Candidate detection is a vectorized sign-change scan (the endpoints
    plus every interior point where the discrete slope changes sign — the
    identical ``(err[i]-err[i-1])*(err[i+1]-err[i]) <= 0`` float test the
    original per-point loop ran); the greedy alternating selection then
    runs over that short candidate list in plain Python.
    """
    G = err.size
    # local extrema (including endpoints), via one vectorized slope scan
    if G > 2:
        d1 = err[1:-1] - err[:-2]
        d2 = err[2:] - err[1:-1]
        interior = (d1 * d2 <= 0).nonzero()[0]
        cand = np.empty(interior.size + 2, dtype=np.intp)
        cand[0] = 0
        np.add(interior, 1, out=cand[1:-1])
        cand[-1] = G - 1
    else:
        cand = np.unique([0, G - 1])
    # greedily keep the largest-magnitude alternating subsequence
    cvals = err[cand]
    order = np.argsort(-np.abs(cvals))
    cl = cand.tolist()
    sl = np.sign(cvals).tolist()
    min_gap = max(1, G // (4 * m))
    picked: list = []
    picked_s: list = []
    for p in order.tolist():
        i = cl[p]
        s = sl[p]
        ok = True
        for j, sj in zip(picked, picked_s):
            if sj == s and abs(i - j) < min_gap:
                ok = False
                break
        if ok:
            picked.append(i)
            picked_s.append(s)
        if len(picked) == m:
            break
    if len(picked) < m:
        taken = set(picked)
        picked.extend(i for i in cl if i not in taken)
        picked = picked[:m]
    if len(picked) < m:
        return None
    return np.array(sorted(picked), dtype=np.intp)
