"""Pluggable execution backends for the full-space candidate scan.

The paper's software cost is the candidate scan of Alg. 1/2: for every
probed window, thousands of candidate coefficient sets are pushed through
the fixed-point Horner datapath, the intercept is error-flattened per
candidate, and the MAE is reduced over the grid.  This module owns that
block evaluation behind a small backend contract, so the *same* scan runs
eagerly on numpy (the golden model) or as batched torch tensor ops on the
card:

  * :class:`NumpySearchBackend` — the golden model, a copy of the JAX
    package's (same ops through :func:`~.datapath.horner_body`).
  * :class:`TorchSearchBackend` — the same datapath on int64/float64 torch
    tensors on one device (the card unless another is asked for).  The
    window grid is staged device-resident once per segment context;
    candidate blocks and grids are padded to power-of-two buckets (edge
    replication, which leaves every reduction unchanged); several windows'
    blocks (speculative probes) or a full scan's chunks evaluate as one
    stacked dispatch with one host sync.

Bit-identity is the contract: every op in the block body is exact integer
arithmetic or an IEEE-754 float64 operation that rounds once (no fused
multiply-add, no compiler), so numpy and torch give the same bits on the
CPU and on the card.  ``mae`` and ``b_int`` agree on every row, ``mae0``
at the first argmin row of ``mae`` (the one row the scan reads).  The
targets ``f`` stay numpy on the host: only the candidate blocks move.

Backend selection never changes results, so it is kept out of every
content address (``CompileJob.key``): ``make_quantizer(..., backend=...)``,
``compile_table(..., search_backend=...)`` and the
``REPRO_TORCH_SEARCH_BACKEND`` environment variable all plumb into
:func:`resolve_backend`, whose default is the numpy backend.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .datapath import DatapathPlan, FWLConfig, apply_shift, horner_body
from .fixed_point import round_half_away

__all__ = [
    "SegmentContext",
    "SearchBackend",
    "NumpySearchBackend",
    "TorchSearchBackend",
    "SEARCH_BACKENDS",
    "resolve_backend",
]

#: env var consulted by :func:`resolve_backend` when no explicit backend is
#: given (names: ``numpy``, ``torch``).  The JAX package's variable is
#: another one, so a reference setting never reaches the port.
BACKEND_ENV = "REPRO_TORCH_SEARCH_BACKEND"

@dataclasses.dataclass
class SegmentContext:
    """Per-segment scan state shared by every block evaluation.

    Created once per ``fit_segment`` call; backends stash device-resident
    copies of the grid under ``cache`` so repeated chunk dispatches against
    the same window pay the host->device transfer once.
    """

    x_int: np.ndarray           # (G,) grid integers, FWL cfg.w_in
    f_vals: np.ndarray          # (G,) float64 target values
    f_q: np.ndarray             # (G,) target rounded to the w_out grid
    cfg: FWLConfig
    plan: DatapathPlan
    flatten_b: bool             # error-flatten the intercept per candidate
    b_fixed: int = 0            # pre-rounded intercept when flatten_b=False
    cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num(self) -> int:
        return int(self.x_int.size)


def _block_metrics(plan: DatapathPlan, w_b: int, flatten_b: bool,
                   planes: Sequence[np.ndarray], b_fixed: int,
                   x: np.ndarray, f: np.ndarray, f_q: np.ndarray):
    """The numpy candidate-block evaluation (the golden model).

    ``planes``: ``plan.order`` candidate coefficient arrays, shape (K,);
    ``x``/``f``/``f_q``: the window grid, shape (G,).  Returns (mae (K,),
    b_int (K,), mae0 (K,)): per candidate MAE_hard, the flattened and
    rounded intercept, and MAE_0 (paper Eq. 7).  ``mae0`` is computed
    once, at the first argmin row of ``mae`` (ties broken low, as
    ``argmin`` does), and broadcast: the scan reads no other row.
    """
    sel = [p[:, None] for p in planes]
    sel.append(np.zeros_like(planes[0])[:, None])      # b=0: pre-intercept
    _, (hp, w_pre) = horner_body(plan, sel, x, return_pre_b=True)
    f64 = f.dtype
    if flatten_b:
        # error-flatten the intercept per candidate (Alg. 1 lines 7-9)
        e0 = f[None, :] - hp.astype(f64) / (1 << w_pre)
        b = 0.5 * (e0.max(axis=-1) + e0.min(axis=-1))
        v = b * (1 << w_b)
        b_int = np.where(v >= 0, np.floor(v + 0.5),
                         np.ceil(v - 0.5)).astype(hp.dtype)
    else:
        b_int = np.full_like(planes[0], b_fixed)
    # concat add at w_sum = max(w_pre, w_b), then rescale to w_out
    w_sum = max(w_pre, w_b)
    out = apply_shift(hp, w_pre - w_sum) \
        + apply_shift(b_int[:, None], w_b - w_sum)
    out = apply_shift(out, w_sum - plan.w_out)
    y = out.astype(f64) / (1 << plan.w_out)
    mae = np.abs(f[None, :] - y).max(axis=-1)
    mae0 = np.broadcast_to(np.abs(f_q - y[np.argmin(mae)]).max(), mae.shape)
    return mae, b_int, mae0


def _torch_block_metrics(plan: DatapathPlan, w_b: int, flatten_b: bool,
                         a: torch.Tensor, b_fixed: Optional[torch.Tensor],
                         x: torch.Tensor, f: torch.Tensor, f_q: torch.Tensor):
    """The same evaluation on torch tensors with any leading batch dims.

    ``a``: (..., order, K) int64 candidates; ``b_fixed``: (...,) int64
    (read only when not ``flatten_b``); ``x``/``f``/``f_q``: (..., G),
    broadcast against the leading dims.  Returns (mae, b_int, mae0), each
    (..., K), with ``mae0`` over the whole block.  Every float64 op is one
    IEEE rounding (``/`` and ``*`` by powers of two are exact), in the
    order of :func:`_block_metrics`, so the bits match it.
    """
    sel = [a[..., i, :, None] for i in range(plan.order)]
    sel.append(torch.zeros_like(sel[0]))                # b=0: pre-intercept
    _, (hp, w_pre) = horner_body(plan, sel, x[..., None, :],
                                 return_pre_b=True)
    f = f[..., None, :]
    if flatten_b:
        e0 = f - hp.to(torch.float64) / (1 << w_pre)
        b = 0.5 * (e0.amax(-1) + e0.amin(-1))
        v = b * (1 << w_b)
        b_int = torch.where(v >= 0, torch.floor(v + 0.5),
                            torch.ceil(v - 0.5)).to(torch.int64)
    else:
        b_int = b_fixed[..., None].expand(a.shape[:-2] + a.shape[-1:])
    w_sum = max(w_pre, w_b)
    out = apply_shift(hp, w_pre - w_sum) \
        + apply_shift(b_int[..., None], w_b - w_sum)
    out = apply_shift(out, w_sum - plan.w_out)
    y = out.to(torch.float64) / (1 << plan.w_out)
    mae = (f - y).abs().amax(-1)
    mae0 = (f_q[..., None, :] - y).abs().amax(-1)
    return mae, b_int, mae0


BlockResult = Tuple[np.ndarray, np.ndarray, np.ndarray]   # (mae, b_int, mae0)


class SearchBackend:
    """Executes candidate blocks; never decides anything.

    The scan loop (chunk order, warm starts, early exit, store caps) lives
    in ``Quantizer``/``_SegmentScan`` and is shared verbatim by every
    backend, so a backend cannot change which candidate wins — only how
    fast the blocks evaluate.  Contract: ``eval_block`` returns float64 /
    int64 numpy arrays bit-identical to the numpy golden backend.
    """

    name = "base"

    def context(self, x_int: np.ndarray, f_vals: np.ndarray, cfg: FWLConfig,
                *, flatten_b: bool, b_fixed: int = 0) -> SegmentContext:
        f_vals = np.asarray(f_vals, dtype=np.float64)
        f_q = round_half_away(f_vals * (1 << cfg.w_out)).astype(np.float64) \
            / (1 << cfg.w_out)
        return SegmentContext(
            x_int=np.asarray(x_int, dtype=np.int64), f_vals=f_vals, f_q=f_q,
            cfg=cfg, plan=DatapathPlan.from_config(cfg),
            flatten_b=flatten_b, b_fixed=int(b_fixed))

    def eval_block(self, ctx: SegmentContext,
                   a_list: Sequence[np.ndarray]) -> BlockResult:
        raise NotImplementedError

    def eval_block_multi(self, blocks: Sequence[Tuple[SegmentContext,
                                                      Sequence[np.ndarray]]]
                         ) -> List[BlockResult]:
        """Evaluate blocks of several windows; backends that can fuse them
        into one dispatch override this.  Semantics are exactly a loop."""
        return [self.eval_block(ctx, a_list) for ctx, a_list in blocks]

    def eval_block_batch(self, ctx: SegmentContext,
                         blocks: Sequence[Sequence[np.ndarray]]):
        """Evaluate a sequence of blocks of ONE window; results come back
        in block order, as an iterable.

        The base implementation is LAZY (a generator): a feasible-mode
        caller that early-exits simply stops consuming, and the remaining
        blocks are never computed.  Device backends override this to fuse
        blocks into grouped dispatches (results past an early exit are
        computed and discarded, trading wasted lanes for dispatch count).
        """
        return (self.eval_block(ctx, blk) for blk in blocks)


class NumpySearchBackend(SearchBackend):
    """Eager numpy golden model."""

    name = "numpy"

    def eval_block(self, ctx, a_list):
        planes = [np.asarray(a, dtype=np.int64) for a in a_list]
        return _block_metrics(ctx.plan, ctx.cfg.w_b, ctx.flatten_b, planes,
                              ctx.b_fixed, ctx.x_int, ctx.f_vals, ctx.f_q)


def _bucket(n: int, lo: int) -> int:
    """Smallest power-of-two >= n, floored at ``lo`` — the padded-shape
    policy that bounds the distinct shapes to O(log(max size))."""
    b = lo
    while b < n:
        b <<= 1
    return b


def _pad_edge(a: np.ndarray, n: int) -> np.ndarray:
    """Pad a 1-D array to length ``n`` by replicating its last element.

    Replication (never zeros) keeps every reduction exact: a duplicated
    grid point cannot move a max/min, and duplicated candidates are sliced
    off the result before anyone looks at them.
    """
    return a if a.size == n else np.pad(a, (0, n - a.size), mode="edge")


def _stack_candidates(a_list: Sequence[np.ndarray], kp: int) -> np.ndarray:
    """(order, kp) int64: the block's stages, each padded to ``kp``."""
    return np.stack([_pad_edge(np.asarray(a, dtype=np.int64), kp)
                     for a in a_list])


class TorchSearchBackend(SearchBackend):
    """The candidate scan as batched int64/float64 torch ops on a device.

    ``device=None`` is the card, and raises where there is none; the CPU
    runs only when asked for (``device="cpu"``).  int64 throughout:
    order-2 16-bit intermediates exceed int32.  There is no fallback: a
    failure on the device raises.  ``counts`` tallies this instance's
    dispatch groups (one host sync each), blocks and padded candidate
    lanes.
    """

    name = "torch"

    #: padding floors: blocks smaller than these are padded up, so one
    #: shape serves every probe-sized dispatch (warm starts are K=1).
    #: Execution constants: padded lanes are sliced off before anyone
    #: reads them, so results are floor-independent.
    K_FLOOR = 64
    G_FLOOR = 32

    #: element budget (blocks x candidates x grid) of one fused full-scan
    #: dispatch — bounds the padded int64 intermediates (8 bytes an
    #: element each).  Order-1 full scans fuse into one dispatch; order-2
    #: scans split into a few.
    BATCH_ELEMS = 1 << 23

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.counts: Dict[str, int] = {"dispatches": 0, "blocks": 0,
                                       "lanes": 0}

    # -- device staging ------------------------------------------------------
    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _grid(self, ctx: SegmentContext, gp: int):
        """Device-resident (x, f, f_q) padded to the ``gp`` bucket, staged
        once per (context, device, bucket)."""
        key = ("torch", str(self.device), gp)
        dev = ctx.cache.get(key)
        if dev is None:
            dev = tuple(self._put(_pad_edge(v, gp))
                        for v in (ctx.x_int, ctx.f_vals, ctx.f_q))
            ctx.cache[key] = dev
        return dev

    def _run(self, plan, w_b, flatten_b, a, b_fixed, x, f, f_q, blocks):
        """One dispatch group: the block body, then ONE host sync for all
        three results (``b_int``'s int64 bits ride in a float64 view)."""
        mae, b_int, mae0 = _torch_block_metrics(plan, w_b, flatten_b, a,
                                                b_fixed, x, f, f_q)
        res = torch.stack([mae, b_int.contiguous().view(torch.float64),
                           mae0]).cpu().numpy()
        self.counts["dispatches"] += 1
        self.counts["blocks"] += blocks
        self.counts["lanes"] += a.numel() // plan.order
        return res[0], res[1].view(np.int64), res[2]

    def _b_fixed(self, values) -> torch.Tensor:
        """The fixed intercept(s) as an int64 tensor: a scalar, or one a
        window."""
        return torch.tensor(values, dtype=torch.int64, device=self.device)

    def eval_block(self, ctx, a_list):
        k = int(np.asarray(a_list[0]).size)
        kp = _bucket(k, self.K_FLOOR)
        gp = _bucket(ctx.num, self.G_FLOOR)
        x, f, f_q = self._grid(ctx, gp)
        a = self._put(_stack_candidates(a_list, kp))
        b_fixed = None if ctx.flatten_b else self._b_fixed(ctx.b_fixed)
        mae, b_int, mae0 = self._run(ctx.plan, ctx.cfg.w_b, ctx.flatten_b,
                                     a, b_fixed, x, f, f_q, 1)
        return mae[:k], b_int[:k], mae0[:k]

    def eval_block_multi(self, blocks):
        """Many windows, ONE dispatch: a stacked window axis on every
        operand.

        Windows are padded to shared (K, G) buckets and the window count
        itself is bucketed (replicating window 0); per-window results are
        sliced back out and padding windows are discarded unread.
        """
        if len(blocks) == 1:
            ctx, a_list = blocks[0]
            return [self.eval_block(ctx, a_list)]
        ctx0 = blocks[0][0]
        plan, w_b, flatten_b = ctx0.plan, ctx0.cfg.w_b, ctx0.flatten_b
        for ctx, _ in blocks:
            if (ctx.plan, ctx.cfg.w_b, ctx.flatten_b) != (plan, w_b,
                                                          flatten_b):
                raise ValueError("eval_block_multi requires one shared "
                                 "datapath plan across windows")
        ks = [int(np.asarray(a[0]).size) for _, a in blocks]
        kp = _bucket(max(ks), self.K_FLOOR)
        gp = _bucket(max(ctx.num for ctx, _ in blocks), self.G_FLOOR)
        wp = _bucket(len(blocks), 1)
        idx = list(range(len(blocks))) + [0] * (wp - len(blocks))
        a = self._put(np.stack([_stack_candidates(blocks[i][1], kp)
                                for i in idx]))
        x, f, f_q = (self._put(np.stack([_pad_edge(getattr(
            blocks[i][0], name), gp) for i in idx]))
            for name in ("x_int", "f_vals", "f_q"))
        b_fixed = None if flatten_b else self._b_fixed(
            [blocks[i][0].b_fixed for i in idx])
        mae, b_int, mae0 = self._run(plan, w_b, flatten_b, a, b_fixed, x, f,
                                     f_q, len(blocks))
        return [(mae[i][:ks[i]], b_int[i][:ks[i]], mae0[i][:ks[i]])
                for i in range(len(blocks))]

    def eval_block_batch(self, ctx, blocks):
        """Fuse a sequence of one window's blocks into grouped dispatches
        under ``BATCH_ELEMS``: the grid rides the per-context device cache
        and only the candidate stacks move."""
        if len(blocks) <= 1:
            return super().eval_block_batch(ctx, blocks)
        gp = _bucket(ctx.num, self.G_FLOOR)
        x, f, f_q = self._grid(ctx, gp)
        out: List[BlockResult] = []
        group: List[Sequence[np.ndarray]] = []
        kp_max = 0

        def flush():
            nonlocal group, kp_max
            if group:
                ks = [int(np.asarray(blk[0]).size) for blk in group]
                wp = _bucket(len(group), 1)
                idx = list(range(len(group))) + [0] * (wp - len(group))
                a = self._put(np.stack([_stack_candidates(group[i], kp_max)
                                        for i in idx]))
                b_fixed = None if ctx.flatten_b else self._b_fixed(
                    [ctx.b_fixed] * wp)
                mae, b_int, mae0 = self._run(
                    ctx.plan, ctx.cfg.w_b, ctx.flatten_b, a, b_fixed, x, f,
                    f_q, len(group))
                out.extend((mae[i][:ks[i]], b_int[i][:ks[i]],
                            mae0[i][:ks[i]]) for i in range(len(group)))
            group, kp_max = [], 0

        for blk in blocks:
            kp = _bucket(int(np.asarray(blk[0]).size), self.K_FLOOR)
            new_kp = max(kp_max, kp)
            if group and (len(group) + 1) * new_kp * gp > self.BATCH_ELEMS:
                flush()
                new_kp = kp
            group.append(blk)
            kp_max = new_kp
        flush()
        return out


SEARCH_BACKENDS = {
    "numpy": NumpySearchBackend,
    "torch": TorchSearchBackend,
}


def resolve_backend(spec: "str | SearchBackend | None" = None
                    ) -> SearchBackend:
    """One resolver for every plumbing path.

    ``spec`` may be a backend instance (returned as-is), a registry name,
    or None — which falls back to ``$REPRO_TORCH_SEARCH_BACKEND`` and then
    to the numpy golden backend.  ``"torch"`` is the card's backend.
    Selection is address-independent: the store key of a compile never
    encodes it.
    """
    if isinstance(spec, SearchBackend):
        return spec
    name = spec or os.environ.get(BACKEND_ENV) or "numpy"
    try:
        cls = SEARCH_BACKENDS[name]
    except KeyError as e:
        raise KeyError(f"unknown search backend {name!r} "
                       f"(available: {sorted(SEARCH_BACKENDS)})") from e
    return cls()
