#!/usr/bin/env python3
"""Time the fused PPA kernel's two candidate segment selects on the card.

  python3 scripts/torch_select_study.py

* lut: the package's kernel (``src/repro_torch/kernels/csrc/ppa_fused.cu``),
  which looks the segment of the clipped input up in the table's idx_lut,
  staged in shared memory;
* coarse: the same kernel with a coarse first-level index over the top
  bits of ``x - lo`` (the segment of each bucket's first input) and at
  most three search steps over the starts
  (``scripts/torch_select_study.cu``).

Both run the served case, bf16 gated silu on sigmoid_wide-16, at the decode
and prefill shapes of ``chip_smoke.py``, must equal the plain version bit
for bit, and are timed as ``chip_smoke.py`` times the kernels.  Prints one
JSON object.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
STUDY = Path(__file__).resolve().with_suffix(".cu")
STEPS = 3          # search steps after the coarse index


def coarse_index(starts: np.ndarray, lo: int, hi: int, steps: int = STEPS):
    """(shift, first): the widest buckets of 2^shift inputs in which at
    most 2^steps - 1 starts follow the segment of the bucket's first
    input, and that segment for every bucket."""
    s = len(starts)
    for shift in range(12, -1, -1):
        b0 = np.arange(lo, hi, 1 << shift)
        b1 = np.minimum(b0 + (1 << shift) - 1, hi - 1)
        first = np.clip(np.searchsorted(starts, b0, "right") - 1, 0, s - 1)
        last = np.clip(np.searchsorted(starts, b1, "right") - 1, 0, s - 1)
        if int((last - first).max()) <= (1 << steps) - 1:
            return shift, first.astype(np.int32)
    raise ValueError("no bucket width fits")


def build(nvcc_flags, out: Path) -> ctypes.CDLL:
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["nvcc", *nvcc_flags, "-I", str(csrc), "-o", str(out),
                    str(STUDY)], check=True)
    lib = ctypes.CDLL(str(out))
    c = ctypes.c_void_p
    lib.coarse_fused_launch.argtypes = [
        c, c, ctypes.c_longlong, ctypes.c_longlong, c, ctypes.c_int, c,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, c, ctypes.c_int, c, c,
        ctypes.c_float, c]
    lib.coarse_fused_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_select_study: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import fused
    from repro_torch.kernels.build import (raise_on_error, stream_of,
                                          vector_split)
    from repro_torch.kernels.ops import pack_table
    from repro_torch.tables import load_table

    dev = torch.device("cuda", 0)
    lib = build(kbuild.NVCC_FLAGS, ROOT / "build" / "select_study.so")
    tc = pack_table(load_table("sigmoid_wide", 16), dev)
    shift, first = coarse_index(tc.starts.cpu().numpy(), tc.lo, tc.hi)
    first_t = torch.as_tensor(first, device=dev)
    c = ctypes.c_void_p
    plan = (ctypes.c_int * len(tc.plan_ints))(*tc.plan_ints)
    sat = 2 if tc.sat_identity else int(tc.sat_hi is not None)
    statics = (ctypes.c_int * 7)(tc.lo, tc.hi, 2, sat, 1, tc.w_in, tc.w_out)
    sat_hi = 0.0 if tc.sat_hi is None else float(tc.sat_hi)

    def coarse(x):
        y = torch.empty_like(x)
        rc = lib.coarse_fused_launch(
            x.data_ptr(), y.data_ptr(), x.numel(),
            vector_split(x.numel(), 2, True), first_t.data_ptr(),
            len(first), tc.starts.data_ptr(), tc.num_segments, shift,
            1 << (STEPS - 1), tc.coefs.data_ptr(), tc.coefs.numel(),
            ctypes.cast(plan, c),
            ctypes.cast(statics, c), sat_hi, stream_of(x))
        raise_on_error(rc, "coarse_fused")
        return y

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"card": cs.card_line(), "table": "sigmoid_wide-16",
           "coarse_shift": shift, "coarse_buckets": len(first),
           "steps": STEPS, "ms": {}}
    for label, shape in cs.FUSED_SHAPES.items():
        x = (torch.randn(shape, generator=gen, device=dev) * 3.0
             ).to(torch.bfloat16)
        want = fused.ppa_fused_plain(tc, x, True)
        for name, fn in (("lut", lambda: fused.ppa_fused_apply(tc, x, True)),
                         ("coarse", lambda: coarse(x))):
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name} select != plain at {shape}")
        for name, fn in (("lut", lambda: fused.ppa_fused_apply(tc, x, True)),
                         ("coarse", lambda: coarse(x)),
                         ("coarse", lambda: coarse(x)),
                         ("lut", lambda: fused.ppa_fused_apply(tc, x, True))):
            ms, _ = cs.time_launch(fn)
            out["ms"].setdefault(f"{name} {label} {list(shape)}", []).append(
                ms)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
