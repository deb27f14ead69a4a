#!/usr/bin/env python3
"""Where a full-width train step's time goes on the card.

  python3 scripts/torch_train_profile.py [--remat dots none] [--steps 2]

Trains internlm2-1.8b at its published width (24 layers, random float32
master weights from seed 0, bf16 compute, act_impl="ppa" on cuda_fused,
adamw, batch 4 x seq 512 of the synthetic stream), as ``chip_smoke.py``'s
train phase does, once per ``--remat`` mode.  After 3 warm-up steps it
times ``--steps`` steps with CUDA synchronised around each, then traces as
many with ``torch.profiler``: the device's busy time (the union of its
kernels' intervals) and idle share of the wall time, and the device time
by kernel group and by kernel.  Prints one JSON object per mode and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# kernel name fragments -> group, first match wins
GROUPS = (("softmax_bwd", "ppa softmax backward"),
          ("softmax_warp_kernel", "ppa softmax"),
          ("softmax_block_kernel", "ppa softmax"),
          ("ppa_fused", "ppa fused"),
          ("gemm", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"),
          ("sm90", "matmul"), ("Gemm", "matmul"), ("nvjet", "matmul"),
          ("reduce", "reduction"), ("Reduce", "reduction"),
          ("index", "index / scatter / sort"),
          ("scatter", "index / scatter / sort"),
          ("sort", "index / scatter / sort"), ("Sort", "index / scatter / sort"),
          ("elementwise", "elementwise"), ("Elementwise", "elementwise"),
          ("copy", "copy / cast"), ("Copy", "copy / cast"),
          ("cat", "copy / cast"), ("Memset", "memset"),
          ("memset", "memset"))


def group_of(name: str) -> str:
    for frag, g in GROUPS:
        if frag in name:
            return g
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile(remat: str, steps: int):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params, make_acts, param_specs
    from repro_torch.train import (OptCfg, ScheduleCfg, TrainCfg,
                                   make_train_step, train_init)

    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2-1.8b").replace(
        act_impl="ppa", act_backend="cuda_fused", remat=remat)
    tcfg = TrainCfg(opt=OptCfg(kind="adamw"),
                    sched=ScheduleCfg(peak_lr=3e-4, warmup_steps=2))
    params = init_params(param_specs(cfg), 0, device=dev)
    state = train_init(tcfg, params)
    step = make_train_step(cfg, tcfg, make_acts("ppa", "cuda_fused", dev))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=512, global_batch=4)
    torch.cuda.reset_peak_memory_stats(dev)
    i = 0

    def one():
        nonlocal params, state, i
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch_at(i).items()}
        params, state, _ = step(params, state, batch)
        i += 1

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    wall = []
    for _ in range(steps):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
        calls[e.name] += 1
    by_group = collections.Counter()
    for name, us in by_name.items():
        by_group[group_of(name)] += us
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in kernels])
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) if kernels else 0.0
    mem = torch.cuda.max_memory_allocated(dev)
    del params, state
    torch.cuda.empty_cache()
    return {
        "remat": remat, "steps": steps, "step_ms": wall,
        "traced_ms_per_step": traced_ms / steps,
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "kernel_span_ms_per_step": span / 1e3 / steps,
        "idle_share_of_traced_wall": 1.0 - busy / 1e3 / traced_ms,
        "kernels_per_step": len(kernels) / steps,
        "max_memory_allocated_gib": mem / 2**30,
        "by_group_ms_per_step": {g: us / 1e3 / steps
                                 for g, us in by_group.most_common()},
        "top_kernels": [{"name": n[:120], "ms_per_step": us / 1e3 / steps,
                         "calls_per_step": calls[n] / steps}
                        for n, us in by_name.most_common(25)],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--remat", nargs="+", default=["dots"],
                    choices=["none", "dots", "full"])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    for remat in args.remat:
        print(json.dumps(profile(remat, args.steps)), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
