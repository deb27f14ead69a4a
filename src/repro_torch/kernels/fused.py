"""The fused float -> PPA -> float kernel (``csrc/ppa_fused.cu``).

Counterpart of ``repro/kernels/fused.py::ppa_fused_apply`` and registry
backend ``cuda_fused`` (the reference's ``pallas_fused``): quantize,
symmetry, clip, segment select, Horner, dequantize, saturation, symmetry
restore and the optional ``x * T(x)`` gate in one pass, on float32 or
bfloat16 tensors.

:func:`condition_f32` is the plain composition (``repro/kernels/ops.py::
_apply_f32`` op for op); with the plain integer datapath it is the plain
version of the kernel, which the wrapper runs on a CPU tensor.

The launch shape, (threads a block, blocks an SM at most), is an execution
knob like the reference's Pallas block (``repro/kernels/ppa.py::
default_block``): every shape gives the same output, bit for bit.
:func:`set_default_launch` sets the process default, which the tuner's
third stage measures (``repro_torch.tune``).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from ..roofline import bounds, op_costs
from .build import (VECTOR_BYTES, check_cuda_input, get_lib, raise_on_error,
                    stream_of, vector_split)
from .local import is_dtensor, no_storage, on_local
from .ref import ppa_eval_ref

__all__ = ["DEFAULT_LAUNCH", "LAUNCH_CANDIDATES", "condition_f32", "counts",
           "default_launch", "ppa_fused_apply", "ppa_fused_plain",
           "set_default_launch", "shape_counts", "variant_counts"]

#: kernel launches and plain-version calls
counts = {"launches": 0, "plain": 0}
#: kernel launches by input shape
shape_counts: collections.Counter = collections.Counter()
#: kernel launches by (input shape, dtype name, table's NAF, gate): what a
#: launch computes, where one shape takes several tables
variant_counts: collections.Counter = collections.Counter()

_SYMMETRY_CODE = {None: 0, "odd": 1, "sigmoid": 2, "minus_x": 3}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_c = ctypes.c_void_p

#: (threads a block, blocks an SM at most) of a launch that names none
DEFAULT_LAUNCH: Tuple[int, int] = (128, 4)
#: the shapes the tuner times (``csrc/ppa_fused.cu`` takes any block of a
#: multiple of 32 threads up to 512, at most 2048 threads an SM)
LAUNCH_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    (128, 4), (256, 2), (256, 4), (512, 2))
_MAX_THREADS, _SM_THREADS = 512, 2048

#: the process default, overridable by a tuned config (``tune.activate``)
_active_launch: Tuple[int, int] = DEFAULT_LAUNCH


def _check_launch(launch) -> Tuple[int, int]:
    threads, per_sm = int(launch[0]), int(launch[1])
    if (threads <= 0 or threads > _MAX_THREADS or threads % 32
            or per_sm <= 0 or threads * per_sm > _SM_THREADS):
        raise ValueError(f"fused launch {launch}: threads must be a "
                         f"multiple of 32 up to {_MAX_THREADS}, and "
                         f"threads x blocks an SM at most {_SM_THREADS}")
    return threads, per_sm


def default_launch() -> Tuple[int, int]:
    """The launch shape of a call that names none."""
    return _active_launch


def set_default_launch(launch: Optional[Tuple[int, int]]
                       ) -> Tuple[int, int]:
    """Set the process default launch shape (None resets it to
    ``DEFAULT_LAUNCH``); returns the shape now in force."""
    global _active_launch
    _active_launch = DEFAULT_LAUNCH if launch is None \
        else _check_launch(launch)
    return _active_launch


def eval_ref(tc, x_int: torch.Tensor) -> torch.Tensor:
    """The plain integer datapath of a packed table."""
    return ppa_eval_ref(x_int, tc.starts, tc.coefs, tc.plan)


def to_int32(q: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts, and as the kernel's
    ``__float2int_rd``: saturating, NaN to 0.  A plain cast of a value
    beyond the int32 range is undefined (INT_MIN on x86, whatever its
    sign), which would put +inf and huge inputs below the table's
    interval instead of beyond it."""
    big = q >= 2.0 ** 31
    q = torch.nan_to_num(q, nan=0.0).clamp(min=-2.0 ** 31)
    return torch.where(big, torch.iinfo(torch.int32).max,
                       q.masked_fill(big, 0.0).to(torch.int32))


def condition_f32(tc, x0: torch.Tensor, eval_int, gate: bool
                  ) -> torch.Tensor:
    """float32 in -> float32 out deployment pipeline around ``eval_int``.

    Range reduction (the conditioning around the NAF unit):
      symmetry "odd":     f(-x) = -f(x)       -> evaluate |x|, restore sign
      symmetry "sigmoid": f(-x) = 1 - f(x)    -> evaluate |x|, flip output
      symmetry "minus_x": f(-x) = f(x) - x    -> softplus half-line
      saturation:         x >= xe             -> sat_hi const, or x itself
      gate:               multiply by the raw input (silu/gelu: x * T(x))
    """
    xf = x0.abs() if tc.symmetry else x0
    neg = x0 < 0

    # quantize to the input grid (round-half-away)
    x_int = to_int32(torch.floor(xf.abs() * float(1 << tc.w_in) + 0.5))
    x_int = torch.where(xf < 0, -x_int, x_int)

    oob_hi = x_int >= tc.hi
    x_int_c = torch.clamp(x_int, tc.lo, tc.hi - 1)

    y = eval_int(tc, x_int_c).to(torch.float32) / float(1 << tc.w_out)

    if tc.sat_identity:
        y = torch.where(oob_hi, xf, y)
    elif tc.sat_hi is not None:
        y = torch.where(oob_hi, float(tc.sat_hi), y)
    if tc.symmetry == "odd":
        y = torch.where(neg, -y, y)
    elif tc.symmetry == "sigmoid":
        y = torch.where(neg, 1.0 - y, y)
    elif tc.symmetry == "minus_x":
        y = torch.where(neg, y - xf, y)
    if gate:
        y = x0 * y
    return y


def ppa_fused_plain(tc, x: torch.Tensor, gate: bool = False) -> torch.Tensor:
    """The plain version of the fused kernel: same dtype in and out."""
    counts["plain"] += 1
    return condition_f32(tc, x.to(torch.float32), eval_ref, gate).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = get_lib("ppa_fused")
    if lib.ppa_fused_launch.argtypes is None:
        lib.ppa_fused_launch.argtypes = [
            _c, _c, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _c,
            _c, ctypes.c_int, _c, _c, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, _c]
        lib.ppa_fused_launch.restype = ctypes.c_int
    return lib


def ppa_fused_apply(tc, x: torch.Tensor, gate: bool = False
                    ) -> torch.Tensor:
    """``T(x)`` (or ``x * T(x)`` with ``gate``) for a float32 or bfloat16
    tensor of any shape; the output has the input's dtype.  The kernel
    launches at :func:`default_launch`.  On a DTensor it runs on the local
    shard; on a fake tensor it reports its work and launches nothing
    (kernels/local.py)."""
    if is_dtensor(x):
        return on_local(lambda t: ppa_fused_apply(tc, t, gate), x)
    if no_storage(x):
        _report(tc, x, gate)
        return torch.empty_like(x)
    if x.device.type == "cpu":
        return ppa_fused_plain(tc, x, gate)
    check_cuda_input(x, tuple(_DTYPE_CODE), "ppa_fused")
    if tc.starts.device != x.device:
        raise ValueError(f"ppa_fused: table on {tc.starts.device}, "
                         f"input on {x.device}")
    y = torch.empty_like(x)
    n_vec = vector_split(x.numel(), x.element_size(),
                         (x.data_ptr() | y.data_ptr()) % VECTOR_BYTES == 0)
    plan = (ctypes.c_int * len(tc.plan_ints))(*tc.plan_ints)
    sat = 2 if tc.sat_identity else int(tc.sat_hi is not None)
    statics = (ctypes.c_int * 7)(
        tc.lo, tc.hi, _SYMMETRY_CODE[tc.symmetry], sat, gate, tc.w_in,
        tc.w_out)
    sat_hi = 0.0 if tc.sat_hi is None else float(tc.sat_hi)
    with torch.cuda.device(x.device):
        rc = _lib().ppa_fused_launch(
            x.data_ptr(), y.data_ptr(), x.numel(), n_vec,
            _DTYPE_CODE[x.dtype], tc.idx_lut.data_ptr(),
            tc.coefs.data_ptr(), tc.coefs.numel(), ctypes.cast(plan, _c),
            ctypes.cast(statics, _c), sat_hi, *_active_launch,
            stream_of(x))
    raise_on_error(rc, "ppa_fused")
    counts["launches"] += 1
    shape_counts[tuple(x.shape)] += 1
    variant_counts[(tuple(x.shape), str(x.dtype).replace("torch.", ""),
                    tc.naf, bool(gate))] += 1
    _report(tc, x, gate)
    return y


def _report(tc, x: torch.Tensor, gate: bool) -> None:
    if op_costs.counting():
        op_costs.report_kernel(
            "ppa_fused", x.shape, bounds.fused_work(
                x.numel(), x.element_size(), tc.num_segments, tc.plan.order,
                tc.plan.round_mults, bool(gate)),
            itemsize=x.element_size(), table=tc.naf, gate=bool(gate),
            segments=tc.num_segments, order=tc.plan.order)
