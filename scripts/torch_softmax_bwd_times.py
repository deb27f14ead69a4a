#!/usr/bin/env python3
"""Time the PPA softmax's backward kernel of one tree of the PyTorch port at
the shapes the train paths launch it at, under their masks, and list the
ptxas report of each of its kernel entries.

  python3 scripts/torch_softmax_bwd_times.py [--src DIR] [--plain]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so the kernels of two trees are compared by
running the script on each in one call, in the order old, new, new, old.
Each shape is first held to the plain version within SOFTMAX_BWD_REL x max
|g| under each mask its path puts on it, then timed under the first
(``chip_smoke.softmax_bwd_row``: device ms a launch from a CUDA graph of
back-to-back launches, host us a call) beside its bound; ``--plain`` also
times the plain version and torch's softmax backward (context).  Prints
one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (arch whose attention masks the scores, or None for chip_smoke's
#: attention mask, shape (B, Hk, G, T, S)): the train phases' launches
TRAIN_SHAPES = [("hymba-1.5b", (2, 5, 5, 2048, 2048)),
                ("whisper-medium", (4, 16, 1, 1500, 1500)),
                ("whisper-medium", (4, 16, 1, 512, 1500)),
                ("internvl2-26b", (4, 8, 6, 768, 768)),
                (None, (4, 8, 2, 512, 512)),
                ("whisper-medium", (4, 16, 1, 512, 512))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_softmax_bwd_times: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    # the tree's package first: chip_smoke then finds it imported
    sys.path[:0] = [str(src), str(ROOT)]
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, softmax_ppa
    from repro_torch.kernels.ops import pack_table
    from repro_torch.tables import load_table

    build.build_all(("softmax_ppa",))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    e2 = pack_table(load_table("exp2_frac", 16), dev)
    rows = {}
    for arch, shape in TRAIN_SHAPES:
        masks = (None if arch is None else
                 cs.train_masks(torch, dev, get_config(arch), shape))
        row = cs.softmax_bwd_row(torch, gen, dev, softmax_ppa, e2, shape,
                                 plain=args.plain, masks=masks)
        row["share"] = row["bound_ms"] / row["ms"]
        rows[f"{arch or 'internlm2-1.8b'} {shape}"] = row
        cs._free(torch)
    entries = {cs.entry_label(e): pr for e, pr in cs.ptxas_entries(
        build.ptxas_log("softmax_ppa")).items()}
    print(json.dumps({"src": str(src), "card": cs.card_line(),
                      "rows": rows,
                      "ptxas": {k: v for k, v in sorted(entries.items())
                                if k.startswith("softmax_bwd_")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
