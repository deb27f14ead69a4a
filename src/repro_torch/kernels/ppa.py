"""The integer PPA kernel (``csrc/ppa_int.cu``): int32 in, int32 out.

Counterpart of ``repro/kernels/ppa.py::ppa_eval_2d`` and registry backend
``cuda_int`` (the reference's ``pallas``).  On a CUDA tensor the wrapper
launches the kernel; on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.ppa_eval_ref`.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..roofline import bounds, op_costs
from .build import (VECTOR_BYTES, check_cuda_input, get_lib, raise_on_error,
                    stream_of, vector_split)
from .local import is_dtensor, no_storage, on_local
from .ref import ppa_eval_ref

__all__ = ["counts", "ppa_eval_int", "shape_counts"]

#: kernel launches (incremented only where the kernel is launched)
counts = {"launches": 0}
#: kernel launches by input shape
shape_counts: collections.Counter = collections.Counter()

_c = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = get_lib("ppa_int")
    if lib.ppa_int_launch.argtypes is None:
        lib.ppa_int_launch.argtypes = [
            _c, _c, ctypes.c_longlong, ctypes.c_longlong, _c, _c,
            ctypes.c_int, _c, ctypes.c_int, ctypes.c_int, _c]
        lib.ppa_int_launch.restype = ctypes.c_int
    return lib


def ppa_eval_int(tc, x_int: torch.Tensor) -> torch.Tensor:
    """Evaluate the packed table ``tc`` on int32 inputs of any shape, also
    outside its interval.  The kernel selects the row of ``clamp(x, lo,
    hi - 1)`` in the idx_lut, which is the search's row for every int32
    input only if the idx_lut runs from row 0 to row S - 1: a table that
    does not is refused, on every device.  On a DTensor it runs on the
    local shard; on a fake tensor it reports its work and launches nothing
    (kernels/local.py)."""
    if not tc.lut_spans_rows:
        raise ValueError(
            f"ppa_int: table {tc.naf}'s idx_lut does not run from row 0 to "
            f"row {tc.num_segments - 1}: the kernel's clamped idx_lut select "
            "would not be the search's outside [lo, hi)")
    if is_dtensor(x_int):
        return on_local(lambda t: ppa_eval_int(tc, t), x_int)
    if no_storage(x_int):
        _report(tc, x_int)
        return torch.empty_like(x_int)
    if x_int.device.type == "cpu":
        return ppa_eval_ref(x_int, tc.starts, tc.coefs, tc.plan)
    check_cuda_input(x_int, (torch.int32,), "ppa_int")
    if tc.starts.device != x_int.device:
        raise ValueError(f"ppa_int: table on {tc.starts.device}, "
                         f"input on {x_int.device}")
    y = torch.empty_like(x_int)
    n_vec = vector_split(
        x_int.numel(), 4,
        (x_int.data_ptr() | y.data_ptr()) % VECTOR_BYTES == 0)
    plan = (ctypes.c_int * len(tc.plan_ints))(*tc.plan_ints)
    with torch.cuda.device(x_int.device):
        rc = _lib().ppa_int_launch(
            x_int.data_ptr(), y.data_ptr(), x_int.numel(), n_vec,
            tc.idx_lut.data_ptr(), tc.coefs.data_ptr(), tc.coefs.numel(),
            ctypes.cast(plan, _c), tc.lo, tc.hi, stream_of(x_int))
    raise_on_error(rc, "ppa_int")
    counts["launches"] += 1
    shape_counts[tuple(x_int.shape)] += 1
    _report(tc, x_int)
    return y


def _report(tc, x_int: torch.Tensor) -> None:
    if op_costs.counting():
        op_costs.report_kernel(
            "ppa_int", x_int.shape, bounds.int_work(
                x_int.numel(), tc.num_segments, tc.plan.order,
                tc.plan.round_mults), table=tc.naf,
            segments=tc.num_segments, order=tc.plan.order)
