"""Batched serving on the PyTorch port through the continuous-batching
engine with the PPA datapath live in prefill + decode — the paper's
deployment scenario (an accelerator whose NAF unit is the FQA block).

It runs on ``--device`` (default: the card); ``--device cpu`` runs the
kernels' plain versions.

  PYTHONPATH=src python examples/torch_serve_lm.py --requests 6 --max-new 12
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import available_backends
from repro_torch.models import init_params, param_specs
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b",
                    help="any assigned arch id (smoke-sized variant used)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--act-impl", default="ppa",
                    choices=["exact", "ppa", "ppa8"])
    ap.add_argument("--act-backend", default=None,
                    choices=available_backends(),
                    help="PPA execution backend override (default: the "
                         "config's, cuda_fused); the cuda_* backends run "
                         "their plain versions on the CPU")
    ap.add_argument("--device", default=None,
                    help="where the engine runs (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch).replace(act_impl=args.act_impl)
    params = init_params(param_specs(cfg), 0, device=dev)
    eng = ServeEngine(cfg, params, n_slots=4, cache_len=64,
                      act_backend=args.act_backend, device=dev)

    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(args.requests):
        extra = {}
        if cfg.enc_layers:
            extra["enc_feats"] = rng.normal(
                0, 0.1, (cfg.enc_seq, cfg.d_model)).astype(np.float32)
        if cfg.vision_tokens:
            extra["vision_embeds"] = rng.normal(
                0, 0.02, (cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        r = Request(rid=rid,
                    prompt=rng.integers(0, cfg.vocab, 16).astype(np.int32),
                    max_new_tokens=args.max_new, extra=extra or None)
        reqs.append(r)
        eng.submit(r)

    t0 = time.time()
    eng.run_until_drained()
    dt = time.time() - t0
    for r in reqs:
        assert r.done and len(r.output) == args.max_new
        print(f"req {r.rid}: {r.output}")
    total = args.requests * args.max_new
    print(f"\n{total} tokens in {dt:.2f}s = {total / dt:.1f} tok/s "
          f"(act_impl={cfg.act_impl}, act_backend={eng.cfg.act_backend}, "
          f"arch={cfg.arch}, device={dev})")
    return [list(r.output) for r in reqs]


if __name__ == "__main__":
    main()
