#!/usr/bin/env python3
"""How the serving parity of hymba-1.5b moves with its depth.

  python3 scripts/torch_hybrid_parity_depth.py [--stages 1 2 3 5]

For each count k, keeps the first k of hymba's five stages at the
published width (d_model 1600, 25 query and 5 KV heads of 64, SSM inner
width 3200 with 16 states, d_ff 5504), each stage cut to one layer, float32
with random weights of seed 0, and runs ``chip_smoke.phase_parity`` on it:
a prefill of 4 x 64 tokens and 8 greedy decode steps through the plain
versions (``ref``), ``cuda_int`` and ``cuda_fused``, and four control
softmaxes (``ref`` with each probability moved by +-1e-6, +-1e-5, +-1e-4
or rounded to bf16).  The phase prints the logit gaps of the arms and of
the controls; this prints, per count, whether the phase's gate held (and
its message where it did not), then the card's name and power limit.
Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2, 3, 5])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_hybrid_parity_depth: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C

    dev = torch.device("cuda", 0)
    for k in args.stages:
        try:
            C.phase_parity(torch, dev, C.HYBRID_ARCH, 1, f"stages {k}", k)
            held, why = True, None
        except AssertionError as e:
            held, why = False, str(e)
        print(json.dumps({"arch": C.HYBRID_ARCH, "stages": k,
                          "layers": k, "gate_held": held, "why": why}),
              flush=True)
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
