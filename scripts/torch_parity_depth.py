#!/usr/bin/env python3
"""How a config's serving parity moves with its depth.

  python3 scripts/torch_parity_depth.py --arch hymba-1.5b --stages 1 2 3 5
  python3 scripts/torch_parity_depth.py --arch qwen3-14b --layers 1 2 3 4 6
      [--cache bfloat16 float32] [--fixed] [--limit 0.0009765625]

For each count of layers a stage (``--layers``, default 1), of stages
kept from the first (``--stages``, default all) and decode cache dtype,
cuts ``--arch`` at its published width, float32 with random weights of
seed 0 and random attention biases and qk-norm scales
(``chip_smoke._randomize_attn``; with ``--fixed`` they keep their initial
0 and 1), and runs ``chip_smoke.phase_parity`` on it, the logit gap held
to ``--limit`` of the largest logit (default ``chip_smoke.PARITY_LIMIT``):
a prefill of 4 x 64 tokens and 8 greedy decode steps through the plain
versions (``ref``), ``cuda_int`` and ``cuda_fused``, and four control
softmaxes (``ref`` with each probability moved by +-1e-6, +-1e-5, +-1e-4
or rounded to bf16).  The phase prints the logit gaps of the arms and of
the controls; this prints, per cut, whether the phase's gate held (and
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
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, nargs="+", default=[1])
    ap.add_argument("--stages", type=int, nargs="+", default=[None])
    ap.add_argument("--cache", nargs="+", default=["bfloat16"],
                    choices=["bfloat16", "float32"])
    ap.add_argument("--limit", type=float, default=None)
    ap.add_argument("--fixed", action="store_true",
                    help="keep the biases at 0 and the qk-norm scales at 1")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_parity_depth: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C

    if args.fixed:
        C._randomize_attn = lambda torch, dev, tree, seed=3: 0
    limit = args.limit or C.PARITY_LIMIT
    dev = torch.device("cuda", 0)
    for cache in args.cache:
        for k in args.layers:
            for n in args.stages:
                tag = f"{args.arch} {k}L a stage, stages {n}, {cache}"
                try:
                    C.phase_parity(torch, dev, args.arch, k, tag, n, cache,
                                   limit)
                    held, why = True, None
                except AssertionError as e:
                    held, why = False, str(e)
                print(json.dumps({"arch": args.arch, "layers": k,
                                  "stages": n, "cache": cache,
                                  "fixed": args.fixed, "limit": limit,
                                  "gate_held": held, "why": why}),
                      flush=True)
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
