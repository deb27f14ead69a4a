"""Row softmax with the exp through the ``exp2_frac`` PPA table
(``csrc/softmax_ppa.cu``), with an optional boolean mask.

Counterpart of ``repro/kernels/softmax_ppa.py::softmax_ppa_2d`` plus the
``where`` mask of ``repro/kernels/ops.py::ppa_softmax``, which attention
needs.  :func:`softmax_ppa_plain` is the reference's composition, the plain
version the wrapper runs on a CPU tensor.

    exp(x - m) = 2**((x-m)*log2e) = 2**k * T(f),  k = floor(s), f = s - k
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .build import check_cuda_input, get_lib, raise_on_error, stream_of
from .fused import condition_f32, eval_ref

__all__ = ["counts", "route", "shape_counts", "softmax_ppa",
           "softmax_ppa_plain"]

#: kernel launches and plain-version calls
counts = {"launches": 0, "plain": 0}
#: kernel launches by input shape
shape_counts: collections.Counter = collections.Counter()

_LOG2E = float(np.float32(math.log2(math.e)))
_CLAMP = -24.0  # 2^-24 is below every table's output ULP
_MAX_DIMS = 8   # leading dims the kernel's mask index takes (SOFTMAX_MAX_DIMS)
_LANE_VALUES = 64   # scores a lane holds in registers on the warp path
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


def route(n: int, aligned: bool) -> Tuple[int, int]:
    """The kernel's layout for rows of ``n`` scores: ``(vec, items)`` for
    one warp per row, each lane holding ``items`` runs of ``vec``
    consecutive scores (``vec`` 4 loads 16 bytes, for rows of a multiple
    of 4 that start 16-byte aligned), or ``(0, 0)`` for one block per row
    when a row does not fit in a warp's registers."""
    vec = 4 if n % 4 == 0 and aligned else 1
    items = 1
    while 32 * vec * items < n:
        items *= 2
    return (vec, items) if vec * items <= _LANE_VALUES else (0, 0)


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


def _lib() -> ctypes.CDLL:
    lib = get_lib("softmax_ppa")
    if lib.softmax_ppa_launch.argtypes is None:
        lib.softmax_ppa_launch.argtypes = [
            _c, _c, ctypes.c_int, _c, _c, _c, ctypes.c_longlong, _c,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            _c, _c, ctypes.c_int, _c, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _c]
        lib.softmax_ppa_launch.restype = ctypes.c_int
    return lib


def softmax_ppa(x: torch.Tensor, tc, where: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Softmax over the last axis of a contiguous float32 tensor of any
    shape.  ``where`` (bool, broadcastable to ``x``) marks the columns that
    take part; masked columns give 0, an all-masked row gives 0 everywhere.
    The kernel reads ``where`` through its broadcast strides, unexpanded."""
    if x.device.type == "cpu":
        return softmax_ppa_plain(x, tc, where)
    if tc.naf != "exp2_frac":
        raise ValueError(f"softmax needs the exp2_frac table, got {tc.naf}")
    check_cuda_input(x, (torch.float32,), "softmax_ppa")
    if tc.starts.device != x.device:
        raise ValueError(f"softmax_ppa: table on {tc.starts.device}, "
                         f"input on {x.device}")
    lead = max(x.dim() - 1, 0)
    if lead > _MAX_DIMS:
        raise ValueError(f"softmax_ppa: at most {_MAX_DIMS + 1} dims, got "
                         f"{x.dim()}")
    n = x.shape[-1] if x.dim() else 1
    rows = x.numel() // n if n else 0
    if rows >= 1 << 31 or n >= 1 << 31:
        raise ValueError("softmax_ppa: rows and row length must fit in 31 "
                         "bits")
    mask, dims, col_stride = None, [], 0
    if where is not None:
        if where.dtype != torch.bool or where.device != x.device:
            raise TypeError("softmax_ppa: where must be a bool tensor on "
                            "the input's device")
        mask = torch.broadcast_to(where, x.shape)     # a view: no copy
        dims = _mask_index(mask, lead) if x.dim() else []
        col_stride = mask.stride(-1) if x.dim() else 0
    cols = list(zip(*dims)) or [(), (), ()]
    inner, size, stride = ((ctypes.c_longlong * _MAX_DIMS)(*c) for c in cols)
    y = torch.empty_like(x)
    vec, items = route(n, x.data_ptr() % 16 == 0)
    plan = (ctypes.c_int * len(tc.plan_ints))(*tc.plan_ints)
    with torch.cuda.device(x.device):
        rc = _lib().softmax_ppa_launch(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            len(dims), ctypes.cast(inner, _c), ctypes.cast(size, _c),
            ctypes.cast(stride, _c), col_stride, y.data_ptr(), rows, n,
            vec, items, tc.idx_lut.data_ptr(), tc.coefs.data_ptr(),
            tc.coefs.numel(), ctypes.cast(plan, _c), tc.lo, tc.hi, tc.w_in,
            tc.w_out, stream_of(x))
    raise_on_error(rc, "softmax_ppa")
    counts["launches"] += 1
    shape_counts[tuple(x.shape)] += 1
    return y
