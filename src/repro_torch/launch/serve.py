"""Serving CLI: batched requests through the continuous-batching engine,
on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --requests 8 --max-new 16 --act-impl ppa

``--layers`` cuts the depth; the width stays the published one.  Weights
are random (seed 0), in the config's compute dtype.  whisper's requests
carry frame embeddings ``enc_feats`` ~ N(0, 0.1) of (enc_seq, d_model),
internvl's patch embeddings ``vision_embeds`` ~ N(0, 0.02) of
(vision_tokens, d_model), drawn before each prompt from the same seeded
generator, as the reference's launcher draws them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..kernels import available_backends
from ..models import init_params, param_specs
from ..models.transformer import dtype_of
from ..serve import Request, ServeEngine


def request_extras(cfg, rng: np.random.Generator) -> dict:
    """One request's stub frontend outputs, float32, from ``rng``: the
    encoder's frame embeddings and the vision prefix's patch embeddings, as
    the config has them (empty for a text-only model)."""
    extra = {}
    if cfg.enc_layers:
        extra["enc_feats"] = rng.normal(
            0, 0.1, (cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.vision_tokens:
        extra["vision_embeds"] = rng.normal(
            0, 0.02, (cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return extra


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every stage to this many layers")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--no-coalesce", action="store_true")
    ap.add_argument("--act-impl", default=None,
                    choices=[None, "exact", "ppa", "ppa8"])
    ap.add_argument("--act-backend", default=None,
                    choices=[None] + available_backends())
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.act_impl:
        cfg = cfg.replace(act_impl=args.act_impl)
    if args.layers:
        cfg = cfg.replace(stages=tuple(
            dataclasses.replace(st, n_layers=min(st.n_layers, args.layers))
            for st in cfg.stages))
    params = init_params(param_specs(cfg), 0,
                         dtype=dtype_of(cfg.compute_dtype), device=device)
    eng = ServeEngine(cfg, params, n_slots=args.slots,
                      cache_len=args.cache_len, act_backend=args.act_backend,
                      coalesce=not args.no_coalesce, device=device)
    del params
    eng.warmup([args.prompt_len])

    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(args.requests):
        extra = request_extras(cfg, rng)
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, args.prompt_len
                                ).astype(np.int32),
            max_new_tokens=args.max_new, temperature=args.temperature,
            extra=extra or None))
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in reqs)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"served {len(reqs)} requests / {total} tokens in {dt:.3f}s "
          f"({total / dt:.1f} tok/s) on {where}, act_impl={cfg.act_impl}, "
          f"act_backend={eng.cfg.act_backend}, {eng.stats()}")


if __name__ == "__main__":
    main()
