#!/usr/bin/env python3
"""Where a sharded MoE decode step's host time goes, on one card.

Full-width moonshot-v1-16b-a3b (48 layers, bf16, random weights from seed
0, ``act_impl="ppa"``, ``moe_mode="token_gather"``) served two ways on
the same parameters: a local ``ServeEngine`` and ``ServeEngine(ctx=...)``
on a ("data", "model") ``DeviceMesh`` of (1, 1) over an NCCL process group
of one rank (``chip_smoke.py``'s ``serve_moe_sharded``).  Times
``--steps`` decode steps of each on a fresh cache of 4 slots x 512, in
turn, ``--repeats`` times, then prints a cProfile of two sharded steps
(the functions by own time and by cumulative time) and the card's name
and power limit.

  python3 scripts/torch_sharded_profile.py [--steps 10] [--repeats 2]

Needs the card and about 60 GiB of device memory.
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def decode_ms(torch, eng, n):
    """Milliseconds of each of ``n`` decode steps of ``eng``'s slots on a
    fresh cache, each ending in a synchronise."""
    from repro_torch.models import decode_step, init_cache
    cache = init_cache(eng.cfg, eng.n_slots, eng.cache_len,
                       device=eng.device)
    toks = torch.zeros((eng.n_slots, 1), dtype=torch.int32,
                       device=eng.device)
    pos = torch.full((eng.n_slots,), 100, dtype=torch.int32,
                     device=eng.device)
    out = []
    with torch.inference_mode():
        for _ in range(n):
            t0 = time.perf_counter()
            decode_step(eng.params, eng.cfg, cache, toks, pos, eng.acts,
                        eng.ctx)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_sharded_profile: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.distributed import make_ctx
    from repro_torch.kernels import build
    from repro_torch.models import init_params, param_specs
    from repro_torch.serve import ServeEngine

    dev = torch.device("cuda", 0)
    build.build_all()
    cfg = get_config(C.MOE_ARCH).replace(
        act_impl="ppa", compute_dtype="bfloat16", act_backend="cuda_fused",
        moe_mode="token_gather")
    params = init_params(param_specs(cfg), 0, dtype=torch.bfloat16,
                         device=dev)
    local = ServeEngine(cfg, params, n_slots=C.SERVE_SLOTS,
                        cache_len=C.SERVE_CACHE_LEN, device=dev)
    mesh, store_path = C._nccl_mesh(torch, dev)
    try:
        sharded = ServeEngine(cfg, params, n_slots=C.SERVE_SLOTS,
                              cache_len=C.SERVE_CACHE_LEN,
                              ctx=make_ctx(mesh), device=dev)
        for eng in (local, sharded):
            decode_ms(torch, eng, 2)                 # first use
        for rep in range(args.repeats):
            for name, eng in (("local", local), ("sharded", sharded)):
                t = sorted(decode_ms(torch, eng, args.steps))
                print(f"[{rep}] {name} decode ms median "
                      f"{t[len(t) // 2]:.2f} min {t[0]:.2f} max {t[-1]:.2f}",
                      flush=True)
        prof = cProfile.Profile()
        prof.enable()
        decode_ms(torch, sharded, 2)
        prof.disable()
        stats = pstats.Stats(prof)
        stats.sort_stats("tottime").print_stats(30)
        stats.sort_stats("cumtime").print_stats(30)
    finally:
        dist.destroy_process_group()
        store_path.unlink(missing_ok=True)
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
