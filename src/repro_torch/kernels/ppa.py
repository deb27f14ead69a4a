"""The integer PPA kernel (``csrc/ppa_int.cu``): int32 in, int32 out.

Counterpart of ``repro/kernels/ppa.py::ppa_eval_2d`` and registry backend
``cuda_int`` (the reference's ``pallas``).  On a CUDA tensor the wrapper
launches the kernel; on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.ppa_eval_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_cuda_input, get_lib, raise_on_error, stream_of
from .ref import ppa_eval_ref

__all__ = ["counts", "ppa_eval_int"]

#: kernel launches (incremented only where the kernel is launched)
counts = {"launches": 0}

_c = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = get_lib("ppa_int")
    if lib.ppa_int_launch.argtypes is None:
        lib.ppa_int_launch.argtypes = [_c, _c, ctypes.c_longlong, _c, _c,
                                       ctypes.c_int, _c, _c]
        lib.ppa_int_launch.restype = ctypes.c_int
    return lib


def ppa_eval_int(tc, x_int: torch.Tensor) -> torch.Tensor:
    """Evaluate the packed table ``tc`` on int32 inputs of any shape."""
    if x_int.device.type == "cpu":
        return ppa_eval_ref(x_int, tc.starts, tc.coefs, tc.plan)
    check_cuda_input(x_int, (torch.int32,), "ppa_int")
    if tc.starts.device != x_int.device:
        raise ValueError(f"ppa_int: table on {tc.starts.device}, "
                         f"input on {x_int.device}")
    y = torch.empty_like(x_int)
    plan = (ctypes.c_int * len(tc.plan_ints))(*tc.plan_ints)
    with torch.cuda.device(x_int.device):
        rc = _lib().ppa_int_launch(
            x_int.data_ptr(), y.data_ptr(), x_int.numel(),
            tc.starts.data_ptr(), tc.coefs.data_ptr(), tc.num_segments,
            ctypes.cast(plan, _c), stream_of(x_int))
    raise_on_error(rc, "ppa_int")
    counts["launches"] += 1
    return y
