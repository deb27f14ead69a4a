#!/usr/bin/env python3
"""How the gradient of internlm2-1.8b at its random init grows with depth.

  python3 scripts/torch_depth_growth.py [--depths 2 8 16 24]
                                        [--dtypes float32 bfloat16]

Builds the published width (d_model 2048, d_ff 8192, vocab 92544) with the
random float32 master weights of seed 0 that ``launch/train.py`` trains
from, and for each depth keeps the first ``depth`` of its 24 layers.  For
each compute dtype and depth it takes one loss and gradient (no optimizer
step) of the synthetic stream's first batch (4 x 512 tokens) through
``train.train_step.loss_and_grads``, act_impl="ppa" on ``cuda_fused``,
and prints the loss, the gradient norm, the embedding's norm and the
norm of each layer's gradients, input side first.  At the deepest depth
it also runs the ``ref`` backend (the plain versions) in each dtype.  One
JSON object per reading, then the card's name and power limit.  Needs
the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def layer_norms(torch, grads):
    """The norm of each layer's gradients over every stacked leaf."""
    from repro_torch.tree import leaves
    sq = None
    for stage in grads["stages"].values():
        for g in leaves(stage):
            s = g.float().square().flatten(1).sum(1)
            sq = s if sq is None else sq + s
    return [float(v) for v in sq.sqrt()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 8, 16, 24])
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_depth_growth: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params, make_acts, param_specs
    from repro_torch.train import global_norm
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import map_tree

    dev = torch.device("cuda", 0)
    full = get_config("internlm2-1.8b").replace(act_impl="ppa")
    params = init_params(param_specs(full), 0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        vocab=full.vocab, seq_len=args.seq,
        global_batch=args.batch).batch_at(0).items()}
    deepest = max(args.depths)
    for dtype in args.dtypes:
        for depth in sorted(args.depths):
            cfg = full.replace(compute_dtype=dtype, stages=tuple(
                dataclasses.replace(st, n_layers=depth)
                for st in full.stages))
            cut = {**params, "stages": map_tree(lambda t: t[:depth],
                                                params["stages"])}
            for backend in (("cuda_fused", "ref") if depth == deepest
                            else ("cuda_fused",)):
                loss, grads = loss_and_grads(
                    cfg, make_acts("ppa", backend, dev), cut, batch)
                row = {"dtype": dtype, "depth": depth, "backend": backend,
                       "loss": float(loss),
                       "grad_norm": float(global_norm(grads)),
                       "embed_norm": float(global_norm(grads["embed"])),
                       "head_norm": float(global_norm(grads["lm_head"])),
                       "layer_norms": layer_norms(torch, grads)}
                print(json.dumps(row), flush=True)
                del grads
                torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
