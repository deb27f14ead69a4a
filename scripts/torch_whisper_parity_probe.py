#!/usr/bin/env python3
"""Where whisper-medium's serving parity moves: layer by layer.

  python3 scripts/torch_whisper_parity_probe.py [--layers 2] [--frames 1500]
      [--gate] [--cache bfloat16|float32]

Builds ``chip_smoke.phase_parity``'s whisper cut (the published width,
``--layers`` encoder and decoder layers, float32, random weights of seed
0, 4 prompts of 64 tokens and their frame embeddings from seed 1, of
``--frames`` frames) and runs one prefill through the plain versions
(``ref``), through ``cuda_fused`` and through ``ref`` with its softmax
moved by +-d for d in 1e-6 (the kernel's bound) and 1e-7.  It records
the hidden state after each encoder layer, the encoder's output and the
hidden state after each decoder layer, and prints one JSON line per arm:
each record's largest gap to ``ref`` and ``ref``'s largest magnitude
there, then the largest prefill logit gap.  With ``--gate`` it then runs
``chip_smoke.phase_parity`` on the same cut (1500 frames; prefill and 8
greedy decode steps, the three arms and the four control softmaxes, the
decode cache in ``--cache``'s dtype) and prints whether its gate held.
Then the card's name and power limit.  Needs the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--frames", type=int, default=1500)
    ap.add_argument("--gate", action="store_true")
    ap.add_argument("--cache", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="the decode cache's dtype in the gated run")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_whisper_parity_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import request_extras
    from repro_torch.models import (init_params, make_acts, param_specs,
                                    prefill, prepare_params)
    from repro_torch.models import transformer as T

    dev = torch.device("cuda", 0)
    cfg = C._cut(get_config(C.WHISPER_ARCH), args.layers).replace(
        act_impl="ppa", compute_dtype="float32", enc_seq=args.frames)
    params = prepare_params(init_params(param_specs(cfg), 0, device=dev),
                            cfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (4, 64)),
                                       dtype=torch.int32, device=dev)}
    feats = np.stack([request_extras(cfg, rng)["enc_feats"]
                      for _ in range(4)])
    batch["enc_feats"] = torch.as_tensor(feats, device=dev)

    records = []
    layer, encode = T._layer, T._encode

    def rec_layer(cfg_, st, *a, **k):
        out = layer(cfg_, st, *a, **k)
        records.append((f"{st.kind} layer", out[0].float().clone()))
        return out

    def rec_encode(*a, **k):
        out = encode(*a, **k)
        records.append(("encoder output", out.float().clone()))
        return out

    ref = make_acts("ppa", "ref", dev)
    arms = {"ref": ref, "cuda_fused": make_acts("ppa", "cuda_fused", dev)}
    for d in (1e-6, 1e-7):
        arms[f"ref, softmax +-{d:g}"] = dataclasses.replace(
            ref, softmax=C._moved_softmax(torch, dev, ref.softmax, d))
    T._layer, T._encode = rec_layer, rec_encode
    runs = {}
    try:
        with torch.inference_mode():
            for name, acts in arms.items():
                records.clear()
                logits, _ = prefill(params, cfg, batch, 128, acts)
                runs[name] = (list(records), logits.float().clone())
    finally:
        T._layer, T._encode = layer, encode
    want, want_logits = runs["ref"]
    counts = {}
    labels = []
    for what, _ in want:
        counts[what] = counts.get(what, -1) + 1
        labels.append(f"{what} {counts[what]}" if what != "encoder output"
                      else what)
    for name, (got, logits) in runs.items():
        if name == "ref":
            continue
        print(json.dumps({
            "arch": C.WHISPER_ARCH, "layers": args.layers,
            "frames": args.frames, "arm": name,
            "gaps": {lab: [float((g - w).abs().max()), float(w.abs().max())]
                     for lab, (_, g), (_, w) in zip(labels, got, want)},
            "logit_gap": float((logits - want_logits).abs().max()),
            "logit_max": float(want_logits.abs().max())}), flush=True)
    if args.gate:
        del params, runs
        try:
            C.phase_parity(torch, dev, C.WHISPER_ARCH, args.layers,
                           f"layers {args.layers}, {args.cache} cache",
                           cache_dtype=args.cache)
            held, why = True, None
        except AssertionError as e:
            held, why = False, str(e)
        print(json.dumps({"arch": C.WHISPER_ARCH, "layers": args.layers,
                          "cache": args.cache, "gate_held": held,
                          "why": why}), flush=True)
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
