#!/usr/bin/env python3
"""Time the integer PPA, the fused PPA activation and the PPA softmax
kernels of one tree of the PyTorch port at the shapes the served model
launches them at.

  python3 scripts/torch_kernel_times.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so the kernels of two trees are compared by
running the script on each in one call, in the order old, new, new, old.
The work is ``chip_smoke.py``'s (``kernel_times``): each kernel is first
held to its plain version (integer and fused: bit for bit; softmax:
within 1e-6), then timed (device ms per launch from a CUDA graph of
back-to-back launches, host us per call) beside its bound.  Prints one
JSON object, with the registers of every kernel entry the tree's build
reported (``nvcc -Xptxas -v``; empty where the library was built before).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    # the tree's package first: chip_smoke then finds it imported
    sys.path[:0] = [str(src), str(ROOT)]
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    import chip_smoke as cs
    from repro_torch.kernels import build, fused, ppa, softmax_ppa
    from repro_torch.kernels.ops import pack_table
    from repro_torch.tables import load_table

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    times = cs.kernel_times(
        torch, dev, gen, ppa, fused, softmax_ppa,
        pack_table(load_table("sigmoid_wide", 16), dev),
        pack_table(load_table("exp2_frac", 16), dev), plain=False)
    registers = {name: {e: pr.get("registers") for e, pr in
                        cs.ptxas_entries(build.ptxas_log(name)).items()}
                 for name in build.KERNELS}
    print(json.dumps({"src": str(src), "card": cs.card_line(),
                      "times": times, "registers": registers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
