"""Row softmax with the exp through the ``exp2_frac`` PPA table
(``csrc/softmax_ppa.cu``), with an optional boolean mask, and its backward.

Counterpart of ``repro/kernels/softmax_ppa.py::softmax_ppa_2d`` plus the
``where`` mask of ``repro/kernels/ops.py::ppa_softmax``, which attention
needs.  :func:`softmax_ppa_plain` is the reference's composition, the plain
version the wrapper runs on a CPU tensor.

    exp(x - m) = 2**((x-m)*log2e) = 2**k * T(f),  k = floor(s), f = s - k

:func:`softmax_ppa_bwd` is ``jax.vjp`` of the reference's ``ppa_softmax``
(straight-through: the table's derivative is the exact one of 2^f) in
closed form, a kernel of the same source; :func:`softmax_ppa_bwd_plain` is
the closed form in plain PyTorch.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..roofline import bounds, op_costs
from .build import check_cuda_input, get_lib, raise_on_error, stream_of
from .fused import condition_f32, eval_ref
from .local import is_dtensor, no_storage, on_local

__all__ = ["bwd_counts", "bwd_route", "bwd_shape_counts", "counts", "route",
           "shape_counts", "softmax_ppa", "softmax_ppa_bwd",
           "softmax_ppa_bwd_plain", "softmax_ppa_plain"]

#: kernel launches and plain-version calls
counts = {"launches": 0, "plain": 0}
#: kernel launches by input shape
shape_counts: collections.Counter = collections.Counter()
#: the same for the backward
bwd_counts = {"launches": 0, "plain": 0}
bwd_shape_counts: collections.Counter = collections.Counter()

_LOG2E = float(np.float32(math.log2(math.e)))
_CLAMP = -24.0  # 2^-24 is below every table's output ULP
_MAX_DIMS = 8   # leading dims the kernel's mask index takes (SOFTMAX_MAX_DIMS)
_LANE_VALUES = 64   # scores a lane holds in registers on the warp path
_BWD_LANE_VALUES = 32   # the backward's: it holds x, g and e (3 a score)
# The backward's row kernel: one row across up to 16 warps, each lane
# holding up to 4 float4 runs of x and of g (16 scores); only the entries
# of 4 runs a lane take blocks of 512 threads, the others of 256, so 8
# warps a row (csrc/softmax_ppa.cu::BwdRowPlan)
_BWD_WARPS = (1, 2, 4, 8, 16)
_BWD_RUNS = 4
_BWD_THREADS = {1: 256, 2: 256, 3: 256, 4: 512}
_c = ctypes.c_void_p


def softmax_ppa_plain(x: torch.Tensor, tc, where: Optional[torch.Tensor] = None,
                      axis: int = -1,
                      pow2: Optional[Callable] = None) -> torch.Tensor:
    """The plain composition.  ``pow2(f)`` evaluates the table on the
    fractional powers; by default the plain float path of the table (the
    activation ops pass their backend's straight-through op instead)."""
    counts["plain"] += 1
    if tc.naf != "exp2_frac":
        raise ValueError(f"softmax needs the exp2_frac table, got {tc.naf}")
    xf = x.to(torch.float32)
    if where is not None:
        xf = torch.where(where, xf, -math.inf)
    m = torch.amax(xf, dim=axis, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)    # all-masked rows
    s = (xf - m) * _LOG2E
    s = torch.clamp_min(s, _CLAMP)
    k = torch.floor(s)
    f = s - k                                     # in [0, 1)
    pow2f = (pow2(f) if pow2 is not None
             else condition_f32(tc, f, eval_ref, False))
    e = pow2f * torch.exp2(k)                     # exact scale
    if where is not None:
        e = torch.where(where, e, 0.0)
    denom = torch.sum(e, dim=axis, keepdim=True)
    return (e / torch.clamp_min(denom, 1e-30)).to(x.dtype)


def route(n: int, aligned: bool, lane_values: int = _LANE_VALUES
          ) -> Tuple[int, int]:
    """The kernel's layout for rows of ``n`` scores: ``(vec, items)`` for
    one warp per row, each lane holding ``items`` runs of ``vec``
    consecutive scores (``vec`` 4 loads 16 bytes, for rows of a multiple
    of 4 that start 16-byte aligned), or ``(0, 0)`` for one block per row
    when a row does not fit in ``lane_values`` registers a lane (the
    forward's 64, the backward's 32)."""
    vec = 4 if n % 4 == 0 and aligned else 1
    items = 1
    while 32 * vec * items < n:
        items *= 2
    return (vec, items) if vec * items <= lane_values else (0, 0)


def bwd_route(n: int, aligned: bool) -> Tuple[int, int, int]:
    """The backward's layout for rows of ``n`` scores, ``(warps, vec,
    items)``.  A row of a multiple of 4 scores, up to 8192, whose x, g and
    dx start 16-byte aligned lies across ``warps`` warps of a block, each
    lane holding ``items`` float4 runs (``vec`` 4): of the layouts within
    the caps (warps 1, 2, 4, 8 or 16, at most _BWD_THREADS[k] / 32; 1 to 4
    runs a lane) that cover the row, the one with the fewest idle runs,
    then the fewest warps.  Other rows take the earlier paths, ``(0,
    *route(n, aligned, 32))``."""
    if n % 4 == 0 and aligned and 0 < n <= 128 * _BWD_WARPS[-1] * _BWD_RUNS:
        runs = n // 4
        _, warps, items = min(
            (32 * w * k - runs, w, k) for w in _BWD_WARPS
            for k in range(1, _BWD_RUNS + 1)
            if 32 * w * k >= runs and 32 * w <= _BWD_THREADS[k])
        return warps, 4, items
    return (0, *route(n, aligned, _BWD_LANE_VALUES))


def _mask_index(mask: torch.Tensor, lead: int):
    """(inner, size, stride) of each leading dim along which the mask
    moves: the row index divided by ``inner``, modulo ``size``, steps the
    mask by ``stride``."""
    sizes = mask.shape[:lead]
    out, inner = [], 1
    for d in reversed(range(lead)):
        if sizes[d] > 1 and mask.stride(d) != 0:
            out.append((inner, sizes[d], mask.stride(d)))
        inner *= sizes[d]
    last = sum((sz - 1) * st for _, sz, st in out)
    last += (mask.shape[-1] - 1) * mask.stride(-1)
    if last >= 1 << 31:
        raise ValueError("softmax_ppa: the mask's offsets do not fit in 31 "
                         "bits")
    return out


_ARGTYPES = [_c, _c, ctypes.c_int, _c, _c, _c, ctypes.c_longlong, _c,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, _c, _c, ctypes.c_int, _c, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _c]


def _lib() -> ctypes.CDLL:
    lib = get_lib("softmax_ppa")
    if lib.softmax_ppa_launch.argtypes is None:
        lib.softmax_ppa_launch.argtypes = _ARGTYPES
        lib.softmax_ppa_launch.restype = ctypes.c_int
        # the backward takes the row kernel's warps before vec and items
        lib.softmax_ppa_bwd_launch.argtypes = (
            [_c] + _ARGTYPES[:10] + [ctypes.c_int] + _ARGTYPES[10:])
        lib.softmax_ppa_bwd_launch.restype = ctypes.c_int
    return lib


def _launch_args(x: torch.Tensor, tc, where: Optional[torch.Tensor],
                 what: str, layout: Callable[[int, bool], tuple],
                 *others: torch.Tensor):
    """Check a launch's inputs; return the output and the arguments both
    launch functions take after their inputs (mask, mask index, output,
    rows, row length, ``layout(n, aligned)``, table, stream)."""
    if tc.naf != "exp2_frac":
        raise ValueError(f"softmax needs the exp2_frac table, got {tc.naf}")
    for t in (x, *others):
        check_cuda_input(t, (torch.float32,), what)
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{what}: tensors of shape {tuple(x.shape)} "
                             f"on {x.device} expected")
    if tc.starts.device != x.device:
        raise ValueError(f"{what}: table on {tc.starts.device}, "
                         f"input on {x.device}")
    lead = max(x.dim() - 1, 0)
    if lead > _MAX_DIMS:
        raise ValueError(f"{what}: at most {_MAX_DIMS + 1} dims, got "
                         f"{x.dim()}")
    n = x.shape[-1] if x.dim() else 1
    rows = x.numel() // n if n else 0
    if rows >= 1 << 31 or n >= 1 << 31:
        raise ValueError(f"{what}: rows and row length must fit in 31 bits")
    mask, dims, col_stride = None, [], 0
    if where is not None:
        if where.dtype != torch.bool or where.device != x.device:
            raise TypeError(f"{what}: where must be a bool tensor on the "
                            "input's device")
        mask = torch.broadcast_to(where, x.shape)     # a view: no copy
        dims = _mask_index(mask, lead) if x.dim() else []
        col_stride = mask.stride(-1) if x.dim() else 0
    cols = list(zip(*dims)) or [(), (), ()]
    inner, size, stride = ((ctypes.c_longlong * _MAX_DIMS)(*c) for c in cols)
    out = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out, *others))
    plan = (ctypes.c_int * len(tc.plan_ints))(*tc.plan_ints)
    # each ctypes.cast keeps its array alive as long as the pointer
    return out, (None if mask is None else mask.data_ptr(), len(dims),
                 ctypes.cast(inner, _c), ctypes.cast(size, _c),
                 ctypes.cast(stride, _c), col_stride, out.data_ptr(), rows,
                 n, *layout(n, aligned), tc.idx_lut.data_ptr(),
                 tc.coefs.data_ptr(),
                 tc.coefs.numel(), ctypes.cast(plan, _c), tc.lo, tc.hi,
                 tc.w_in, tc.w_out, stream_of(x))


def softmax_ppa(x: torch.Tensor, tc, where: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Softmax over the last axis of a contiguous float32 tensor of any
    shape.  ``where`` (bool, broadcastable to ``x``) marks the columns that
    take part; masked columns give 0, an all-masked row gives 0 everywhere.
    The kernel reads ``where`` through its broadcast strides, unexpanded.
    On a DTensor it runs on the local rows (the last axis unsharded); on a
    fake tensor it reports its work and launches nothing
    (kernels/local.py)."""
    if is_dtensor(x):
        return on_local(lambda t, w: softmax_ppa(t, tc, w), x, where,
                        axis=-1)
    if no_storage(x):
        if op_costs.counting():
            _report("softmax_ppa", bounds.softmax_work, x, tc, where)
        return torch.empty_like(x)
    if x.device.type == "cpu":
        return softmax_ppa_plain(x, tc, where)
    y, args = _launch_args(x, tc, where, "softmax_ppa", route)
    with torch.cuda.device(x.device):
        rc = _lib().softmax_ppa_launch(x.data_ptr(), *args)
    raise_on_error(rc, "softmax_ppa")
    counts["launches"] += 1
    shape_counts[tuple(x.shape)] += 1
    if op_costs.counting():
        _report("softmax_ppa", bounds.softmax_work, x, tc, where)
    return y


def _mask_elems(where: Optional[torch.Tensor]) -> int:
    """The mask's elements at its unexpanded size (as the kernel reads
    it)."""
    if where is None:
        return 0
    n = 1
    for size, stride in zip(where.shape, where.stride()):
        if stride != 0:
            n *= size
    return n


def _report(name, work, x, tc, where) -> None:
    mask = _mask_elems(where)
    op_costs.report_kernel(
        name, x.shape, work(x.numel(), mask, tc.num_segments, tc.plan.order,
                            tc.plan.round_mults),
        mask_bytes=mask, table=tc.naf, segments=tc.num_segments,
        order=tc.plan.order)


def softmax_ppa_bwd_plain(x: torch.Tensor, g: torch.Tensor, tc,
                          where: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The gradient of :func:`softmax_ppa_plain` over the last axis at
    ``x`` against ``g``, in closed form (``e``, ``D`` and ``y`` are the
    forward's):

        c    = sum_i g_i y_i
        d_j  = (where_j and s_j > -24) ? (g_j - c) / D * 2^s_j : 0
        dx_j = d_j - [where_j and x_j == m] / n_max * sum_i d_i

    The last term is the gradient through the row max, shared equally
    among its ties, as ``jnp.max`` shares it.  An all-masked row gives 0."""
    bwd_counts["plain"] += 1
    if tc.naf != "exp2_frac":
        raise ValueError(f"softmax needs the exp2_frac table, got {tc.naf}")
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    if where is not None:
        xf = torch.where(where, xf, -math.inf)
    m = torch.amax(xf, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.clamp_min((xf - m) * _LOG2E, _CLAMP)
    k = torch.floor(s)
    e = condition_f32(tc, s - k, eval_ref, False) * torch.exp2(k)
    live = s > _CLAMP
    tie = xf == m
    if where is not None:
        e = torch.where(where, e, 0.0)
        live = live & where
        tie = tie & where
    den = torch.clamp_min(torch.sum(e, dim=-1, keepdim=True), 1e-30)
    c = torch.sum(gf * (e / den), dim=-1, keepdim=True)
    d = torch.where(live, (gf - c) / den * torch.exp2(s), 0.0)
    n_max = torch.clamp_min(tie.sum(dim=-1, keepdim=True), 1)
    share = torch.sum(d, dim=-1, keepdim=True) / n_max
    return torch.where(tie, d - share, d)


def softmax_ppa_bwd(x: torch.Tensor, g: torch.Tensor, tc,
                    where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The softmax's gradient over the last axis (see
    :func:`softmax_ppa_bwd_plain`): ``x`` the forward's input and ``g`` the
    gradient of its output, contiguous float32 of one shape, ``where`` as
    for :func:`softmax_ppa`.  The kernel recomputes the forward's row max,
    exponentials and sum rather than reading them.  DTensors and fake
    tensors as for :func:`softmax_ppa`."""
    if is_dtensor(x):
        return on_local(lambda t, gg, w: softmax_ppa_bwd(t, gg, tc, w), x, g,
                        where, axis=-1)
    if no_storage(x):
        if op_costs.counting():
            _report("softmax_ppa_bwd", bounds.softmax_bwd_work, x, tc, where)
        return torch.empty_like(x)
    if x.device.type == "cpu":
        return softmax_ppa_bwd_plain(x, g, tc, where)
    dx, args = _launch_args(x, tc, where, "softmax_ppa_bwd", bwd_route, g)
    with torch.cuda.device(x.device):
        rc = _lib().softmax_ppa_bwd_launch(x.data_ptr(), g.data_ptr(), *args)
    raise_on_error(rc, "softmax_ppa_bwd")
    bwd_counts["launches"] += 1
    bwd_shape_counts[tuple(x.shape)] += 1
    if op_costs.counting():
        _report("softmax_ppa_bwd", bounds.softmax_bwd_work, x, tc, where)
    return dx
