"""Model-facing PPA activation ops: float tensors in, float tensors out,
with the fixed-point datapath bit-exact in the middle.

Counterpart of ``repro/kernels/ops.py``:

* ``TableConsts`` — a table packed as torch tensors on one device, plus its
  :class:`~repro_torch.core.datapath.DatapathPlan`.
* ``ppa_apply`` / ``ppa_gate`` — the deployment path ``T(x)`` and its
  gated form ``x * T(x)``, through the selected backend.
* ``ppa_act`` / ``ppa_gate_act`` — the same with the straight-through
  backward (the exact derivative of the target NAF).
* ``ppa_softmax`` — softmax whose exp goes through the ``exp2_frac`` table.

Backends (:func:`available_backends`):

  ref          plain torch searchsorted + Horner (runs on any device)
  lut_value    one gather over the pack-time tabulated datapath output
  lut_index    gathered segment index + Horner datapath
  cuda_int     the integer CUDA kernel (csrc/ppa_int.cu) inside the
               plain float conditioning
  cuda_fused   the fused float -> PPA -> float CUDA kernel
               (csrc/ppa_fused.cu)

With ``cuda_int`` or ``cuda_fused`` the softmax runs the softmax kernel
(csrc/softmax_ppa.cu), also when its input needs a gradient; its backward
is the softmax backward kernel of the same source, the closed form of the
reference composition's straight-through vjp.  The kernel wrappers run
their plain versions on CPU tensors.  All backends are bit-identical;
softmax agrees within 1e-6.

On a DTensor (a mesh's activation) each op runs on the local shard, a
pending sum reduced first (``kernels/local.py``); the softmax's row must
be whole on a rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.datapath import DatapathPlan, horner_body
from ..core.functions import exact, get_naf
from ..core.schemes import PPATable
from ..device import resolve_device
from .fused import condition_f32, eval_ref, ppa_fused_apply
from .local import is_dtensor, on_local
from .ppa import ppa_eval_int
from .ref import horner_int
from .softmax_ppa import softmax_ppa, softmax_ppa_bwd, softmax_ppa_plain

__all__ = ["Backend", "TableConsts", "available_backends", "check_int32",
           "get_backend", "make_ppa_fn", "pack_table", "plan_ints",
           "ppa_act", "ppa_apply", "ppa_gate", "ppa_gate_act", "ppa_softmax"]

_INT32 = (-(1 << 31), (1 << 31) - 1)
_MAX_ORDER = 4


def plan_ints(plan: DatapathPlan) -> Tuple[int, ...]:
    """The plan as the flat int array the CUDA launch functions take
    (layout in csrc/ppa_body.cuh): order, round_mults, mult_shifts[4],
    up_g[3], up_a[3], up_h, up_b, down_out."""
    if plan.order > _MAX_ORDER:
        raise ValueError(f"order {plan.order} > {_MAX_ORDER} is not "
                         "supported by the CUDA kernels")

    def pad(vals, n):
        return tuple(vals) + (0,) * (n - len(vals))

    return ((plan.order, int(plan.round_mults))
            + pad(plan.mult_shifts, _MAX_ORDER)
            + pad(plan.up_g, _MAX_ORDER - 1) + pad(plan.up_a, _MAX_ORDER - 1)
            + (plan.up_h, plan.up_b, plan.down_out))


@dataclasses.dataclass(frozen=True, eq=False)
class TableConsts:
    """A PPATable packed for execution on one device."""

    naf: str
    interval: Tuple[float, float]
    w_in: int
    w_out: int
    plan: DatapathPlan
    plan_ints: Tuple[int, ...]
    symmetry: Optional[str]
    sat_hi: Optional[float]
    sat_identity: bool
    num_segments: int
    starts: torch.Tensor        # (S,) int32
    coefs: torch.Tensor         # (S, n+1) int32: a_1..a_n then b
    idx_lut: torch.Tensor       # (hi-lo,) int32 segment index of x - lo
    val_lut: torch.Tensor       # (hi-lo,) int32 datapath output of x - lo
    lo: int                     # integer interval [lo, hi) at FWL w_in
    hi: int
    lut_spans_rows: bool        # idx_lut runs from row 0 to row S - 1


def check_int32(table: PPATable, grid: np.ndarray) -> np.ndarray:
    """Run the datapath in int64 over ``grid`` and raise if any node leaves
    int32; returns the outputs.

    Exhaustive over the inputs the datapath can see (the float path clips
    to ``[lo, hi)``), so it is exact where an interval bound is not.
    """
    idx = np.clip(np.searchsorted(table.starts_int, grid, side="right") - 1,
                  0, table.num_segments - 1)
    sel = [table.a_int[idx, i] for i in range(table.order)]
    sel.append(table.b_int[idx])
    bad: List[str] = []

    def tap(name, v):
        lo, hi = int(v.min()), int(v.max())
        if lo < _INT32[0] or hi > _INT32[1]:
            bad.append(f"{name} in [{lo}, {hi}]")

    out = horner_body(DatapathPlan.from_config(table.cfg), sel, grid,
                      tap=tap)
    if bad:
        raise ValueError(f"table {table.naf} overflows the int32 datapath: "
                         + "; ".join(bad))
    return out


def pack_table(table: PPATable, device=None) -> TableConsts:
    """Validate, guard and pack ``table`` onto ``device`` (None: the card)."""
    dev = resolve_device(device)
    table.validate()
    spec = get_naf(table.naf)
    lo = int(math.ceil(table.interval[0] * (1 << table.cfg.w_in) - 1e-12))
    hi = int(math.ceil(table.interval[1] * (1 << table.cfg.w_in) - 1e-12))
    grid = np.arange(lo, hi, dtype=np.int64)
    vals = check_int32(table, grid)
    idx = np.clip(np.searchsorted(table.starts_int, grid, side="right") - 1,
                  0, table.num_segments - 1)
    coefs = np.concatenate([table.a_int, table.b_int[:, None]], axis=1)
    plan = DatapathPlan.from_config(table.cfg)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=dev)

    return TableConsts(
        naf=table.naf, interval=tuple(table.interval),
        w_in=table.cfg.w_in, w_out=table.cfg.w_out, plan=plan,
        plan_ints=plan_ints(plan), symmetry=spec.symmetry,
        sat_hi=spec.sat_hi, sat_identity=spec.sat_identity,
        num_segments=table.num_segments, starts=i32(table.starts_int),
        coefs=i32(coefs), idx_lut=i32(idx), val_lut=i32(vals), lo=lo, hi=hi,
        lut_spans_rows=bool(idx[0] == 0
                            and idx[-1] == table.num_segments - 1))


# --------------------------------------------------------------------------
# backend registry
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Backend:
    """One execution path for a packed table.  Exactly one hook is set:

      eval_int(tc, x_int) -> y_int   integer datapath only; the plain float
                                     conditioning (fused.condition_f32)
                                     wraps it.
      apply(tc, x, gate) -> y        the whole float -> float pipeline, in
                                     the input's dtype (the fused kernel).
    """

    name: str
    eval_int: Optional[Callable] = None
    apply: Optional[Callable] = None
    kernel_softmax: bool = False   # softmax through csrc/softmax_ppa.cu


def _eval_lut_value(tc: TableConsts, x_int: torch.Tensor) -> torch.Tensor:
    return tc.val_lut[(x_int - tc.lo).long()]


def _eval_lut_index(tc: TableConsts, x_int: torch.Tensor) -> torch.Tensor:
    idx = tc.idx_lut[(x_int - tc.lo).long()]
    return horner_int(tc.coefs[idx.long()], x_int, tc.plan)


_BACKENDS: Dict[str, Backend] = {b.name: b for b in (
    Backend("ref", eval_int=eval_ref),
    Backend("lut_value", eval_int=_eval_lut_value),
    Backend("lut_index", eval_int=_eval_lut_index),
    Backend("cuda_int", eval_int=ppa_eval_int, kernel_softmax=True),
    Backend("cuda_fused", apply=ppa_fused_apply, kernel_softmax=True),
)}


def get_backend(name: str) -> Backend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; "
                         f"available: {available_backends()}") from None


def available_backends() -> List[str]:
    return sorted(_BACKENDS)


# --------------------------------------------------------------------------
# float deployment path
# --------------------------------------------------------------------------
def _apply(tc: TableConsts, x: torch.Tensor, backend: str, gate: bool
           ) -> torch.Tensor:
    be = get_backend(backend)
    if be.apply is not None:
        # the fused kernel reads a contiguous tensor: a view (the SSM's z,
        # half of its input projection) is copied first, as the softmax's
        # input is (_last_axis)
        return be.apply(tc, x.contiguous(), gate)
    return condition_f32(tc, x.to(torch.float32), be.eval_int,
                         gate).to(x.dtype)


def ppa_apply(tc: TableConsts, x: torch.Tensor, *, backend: str = "ref"
              ) -> torch.Tensor:
    """float in -> fixed-point PPA datapath -> float out (x's dtype)."""
    return on_local(lambda t: _apply(tc, t, backend, False), x)


def ppa_gate(tc: TableConsts, x: torch.Tensor, *, backend: str = "ref"
             ) -> torch.Tensor:
    """Gated path ``x * T(x)``; the multiply runs in float32 before the
    output cast on every backend (inside the fused kernel on cuda_fused)."""
    return on_local(lambda t: _apply(tc, t, backend, True), x)


class _STE(torch.autograd.Function):
    """PPA forward, exact-derivative backward (straight-through)."""

    @staticmethod
    def forward(ctx, x, tc, backend, gate):
        ctx.save_for_backward(x)
        ctx.naf, ctx.gate = tc.naf, gate
        return _apply(tc, x, backend, gate)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            v = x.detach().to(torch.float32).requires_grad_(True)
            y = exact(ctx.naf, v)
            if ctx.gate:
                y = v * y
            (dx,) = torch.autograd.grad(y, v, g.to(torch.float32))
        return dx.to(x.dtype), None, None, None


def ppa_act(tc: TableConsts, x: torch.Tensor, backend: str = "ref"
            ) -> torch.Tensor:
    """``T(x)`` with the straight-through exact-derivative backward."""
    if is_dtensor(x):
        return on_local(lambda t: ppa_act(tc, t, backend), x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _STE.apply(x, tc, backend, False)
    return _apply(tc, x, backend, False)


def ppa_gate_act(tc: TableConsts, x: torch.Tensor, backend: str = "ref"
                 ) -> torch.Tensor:
    """``x * T(x)`` with the backward of the full gated activation
    (silu'/gelu'), not of the inner table alone."""
    if is_dtensor(x):
        return on_local(lambda t: ppa_gate_act(tc, t, backend), x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _STE.apply(x, tc, backend, True)
    return _apply(tc, x, backend, True)


def _last_axis(x: torch.Tensor, axis: int, where: Optional[torch.Tensor]):
    """``x`` as contiguous float32 with ``axis`` last, and ``where`` moved
    the same way, left unexpanded: the kernels broadcast it."""
    xf = torch.movedim(x.to(torch.float32), axis, -1).contiguous()
    if where is not None:
        where = torch.movedim(where.reshape(
            (1,) * (x.dim() - where.dim()) + tuple(where.shape)), axis, -1)
    return xf, where


def _softmax_kernel(tc: TableConsts, x: torch.Tensor, axis: int,
                    where: Optional[torch.Tensor]) -> torch.Tensor:
    xf, where = _last_axis(x, axis, where)
    y = softmax_ppa(xf, tc, where)
    return torch.movedim(y, -1, axis).to(x.dtype)


class _SoftmaxSTE(torch.autograd.Function):
    """The softmax kernel forward; the softmax backward kernel backward
    (each its plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, tc, where, axis):
        ctx.save_for_backward(x, where)
        ctx.tc, ctx.axis = tc, axis
        return _softmax_kernel(tc, x, axis, where)

    @staticmethod
    def backward(ctx, g):
        x, where = ctx.saved_tensors
        xf, where = _last_axis(x.detach(), ctx.axis, where)
        gf, _ = _last_axis(g, ctx.axis, None)
        dx = softmax_ppa_bwd(xf, gf, ctx.tc, where)
        return torch.movedim(dx, -1, ctx.axis).to(x.dtype), None, None, None


def ppa_softmax(tc_exp2: TableConsts, x: torch.Tensor, *, axis: int = -1,
                where: Optional[torch.Tensor] = None,
                backend: str = "ref") -> torch.Tensor:
    """Softmax with the exp through the exp2_frac table.

    With a kernel backend it is the softmax kernel (its plain version on a
    CPU tensor), and an input that needs a gradient gets the softmax
    backward kernel, the closed form of the reference composition's
    straight-through vjp.  Otherwise it is the reference composition
    around ``ppa_act``.
    """
    if is_dtensor(x):
        return on_local(
            lambda t, w: ppa_softmax(tc_exp2, t, axis=axis, where=w,
                                     backend=backend),
            x, where, axis=axis)
    if not get_backend(backend).kernel_softmax:
        return softmax_ppa_plain(
            x, tc_exp2, where, axis,
            pow2=lambda f: ppa_act(tc_exp2, f, backend))
    if torch.is_grad_enabled() and x.requires_grad:
        return _SoftmaxSTE.apply(x, tc_exp2, where, axis)
    return _softmax_kernel(tc_exp2, x, axis, where)


def make_ppa_fn(table: PPATable, backend: str = "ref", device=None):
    """Close over a packed table -> elementwise activation callable."""
    tc = pack_table(table, device)
    return lambda x: ppa_act(tc, x, backend)
