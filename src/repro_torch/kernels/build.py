"""Build the CUDA kernels with ``nvcc`` at first use and load them with
``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v

``-fmad=false`` keeps every float multiply and add separately rounded, as
the plain PyTorch versions compute them, so the float conditioning stays
bit-identical.  Libraries go to ``build/repro_torch/`` at the root of the
checkout, named by a hash of the sources and flags; a build writes a
temporary file and renames it, so concurrent builders never load a partial
library.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

__all__ = ["KERNELS", "NVCC_FLAGS", "VECTOR_BYTES", "build_all",
           "check_cuda_input", "get_lib", "ptxas_log", "raise_on_error",
           "stream_of", "vector_split"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("ppa_int", "ppa_fused", "softmax_ppa")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
VECTOR_BYTES = 16   # one load or store per thread of the elementwise
                    # kernels (csrc/ppa_fused.cu, csrc/ppa_int.cu)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda/bin)")


def _sources(name: str) -> Tuple[Path, ...]:
    return (CSRC / f"{name}.cu", CSRC / "ppa_body.cuh")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one kernel; returns (final path, tmp path, process)
    or (path, None, None) when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> None:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        _logs[name] = log
    else:
        _logs.setdefault(name, "(already built: no compiler output)")
    _libs[name] = ctypes.CDLL(str(out))


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel: one nvcc per source) and load the kernels."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = [(n, *_start(n)) for n in todo]
        try:
            for n, out, tmp, proc in started:
                _finish(n, out, tmp, proc)
        except BaseException:
            for *_, proc in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
            raise
        return {n: _libs[n] for n in names}


def get_lib(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all((name,))[name]
    return lib


def ptxas_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed when ``name`` was built."""
    return _logs.get(name, "")


def check_cuda_input(t, dtypes, what: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    that records no autograd graph: a kernel's gradient is an
    ``autograd.Function`` around it (kernels/ops.py), so the wrappers run
    inside its forward or backward, never on a tensor that needs one."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes no tensor that needs a "
            "gradient; call it through the autograd ops of kernels/ops.py")


def vector_split(numel: int, itemsize: int, aligned: bool) -> int:
    """How many 16-byte vectors an elementwise kernel loads as such: all
    whole ones when input and output are 16-byte aligned, else none.  The
    elements after them take one thread each."""
    return numel // (VECTOR_BYTES // itemsize) if aligned else 0


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s card, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on_error(rc: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
