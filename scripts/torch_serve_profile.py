#!/usr/bin/env python3
"""Where a full-width decode step's time goes on the card.

  python3 scripts/torch_serve_profile.py [--arch moonshot-v1-16b-a3b ...]
                                         [--steps 4]

Serves each ``--arch`` at its published width (all layers, random bf16
weights from seed 0, act_impl="ppa" on cuda_fused) through
``ServeEngine(n_slots=4, cache_len=512)``, as ``chip_smoke.py``'s serve
phases do, with 4 requests of 64 prompt tokens admitted first, so that
every step timed is a decode step of 4 rows.  After 3 warm-up steps it
times ``--steps`` steps with CUDA synchronised around each, then traces as
many with ``torch.profiler``: the device's busy time (the union of its
kernels' intervals) and idle share of the wall time, the kernels and the
host's launch calls and operators a step, and the device time by kernel
group and by kernel; beside them the least time a step could take, every
parameter byte read once over the memory rate.  Prints one JSON object
per arch and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profile(arch: str, steps: int, dev):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_specs
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tree import leaves
    from torch_train_profile import busy_us, group_of

    cfg = get_config(arch).replace(act_impl="ppa", compute_dtype="bfloat16",
                                   act_backend="cuda_fused")
    params = init_params(param_specs(cfg), 0, dtype=torch.bfloat16,
                         device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    eng = ServeEngine(cfg, params, n_slots=cs.SERVE_SLOTS,
                      cache_len=cs.SERVE_CACHE_LEN, device=dev)
    del params
    rng = np.random.default_rng(0)
    for i in range(cs.SERVE_SLOTS):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, 64)
                           .astype(np.int32), max_new_tokens=10_000))
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    wall = []
    for _ in range(steps):
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(1 for e in events if e.name in ("cudaLaunchKernel",
                                                   "cuLaunchKernel",
                                                   "cudaLaunchKernelExC"))
    # operators called from Python: aten ops not inside another aten op
    ops = sum(1 for e in events if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    by_name, calls = collections.Counter(), collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
        calls[e.name] += 1
    by_group = collections.Counter()
    for name, us in by_name.items():
        by_group[group_of(name)] += us
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in kernels])
    mem = torch.cuda.max_memory_allocated(dev)
    del eng
    torch.cuda.empty_cache()
    return {
        "arch": arch, "layers": cfg.n_layers, "steps": steps,
        "step_ms": wall, "traced_ms_per_step": traced_ms / steps,
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "idle_share_of_traced_wall": 1.0 - busy / 1e3 / traced_ms,
        "kernels_per_step": len(kernels) / steps,
        "host_launch_calls_per_step": launches / steps,
        "host_operators_per_step": ops / steps,
        "weight_gb": weight_bytes / 1e9,
        "weight_read_bound_ms": weight_bytes / cs.HBM_BYTES_PER_S * 1e3,
        "max_memory_allocated_gib": mem / 2**30,
        "by_group_ms_per_step": {g: us / 1e3 / steps
                                 for g, us in by_group.most_common()},
        "top_kernels": [{"name": n[:120], "ms_per_step": us / 1e3 / steps,
                         "calls_per_step": calls[n] / steps}
                        for n, us in by_name.most_common(20)],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+",
                    default=["moonshot-v1-16b-a3b", "internlm2-1.8b"])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]
    import chip_smoke as cs
    for arch in args.arch:
        out = profile(arch, args.steps, torch.device("cuda", 0))
        print(json.dumps(out), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
