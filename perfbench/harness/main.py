"""One run of one cell: set-up, the measured window, the traced sub-window
with ``--trace 1``, then the check against the reference, and the result
line.  See ``perfbench/run.py`` for the command."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import List, Optional

from .checks import judge
from .spec import Cell, load_cell

__all__ = ["main", "run_cell", "FORBIDDEN"]

#: top-level modules a run may not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _runner(cell: Cell):
    kind = cell.traffic["kind"]
    if kind == "train":
        from .train import TrainRun
        return TrainRun
    if kind == "serve":
        from .serve import ServeRun
        return ServeRun
    raise ValueError(f"unknown traffic kind {kind!r}")


def _sync(device):
    import torch
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=sys.stderr) -> dict:
    """The result of one run (the dict the result line prints), and under
    ``"_numbers"`` the compared numbers."""
    import torch

    sync = _sync(device)
    drv = _runner(cell)(cell, seed, device)
    if device.type == "cuda":
        from repro_torch.kernels.build import build_all
        build_all(("ppa_fused", "softmax_ppa"))
    drv.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s", file=log, flush=True)
    win = drv.window(seconds)
    run = {"model": cell.config["model"],
           "traffic": cell.traffic, "setup_s": setup_s, "window": win,
           "steps": list(drv.steps), "trace": None}
    run.update(drv.record())
    attempted, failed = drv.attempted, drv.failed
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1}
    if trace:
        from .trace import breakdown, profile_steps
        n = cell.traffic["traced_steps"]
        tr = profile_steps(drv.one, n, sync, host=False)
        run["trace"] = tr
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        run["breakdown"] = breakdown(
            tr, profile_steps(drv.one, max(1, n // 2), sync, host=True))
    device_info["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(device) if device.type == "cuda"
        else 0)
    run["memory_peak_bytes"] = device_info["memory_peak_bytes"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = drv.numbers()
    print(f"check {time.perf_counter() - t_check:.3f} s: {numbers}",
          file=log, flush=True)
    correct, checks = judge(numbers, cell.limits)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = run["breakdown"]
    out["checks"] = checks
    out["_numbers"] = numbers
    return out


def forbidden_modules() -> List[str]:
    loaded = {name.split(".")[0] for name in sys.modules}
    return sorted(loaded & set(FORBIDDEN))


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]], t_start: float) -> int:
    args = parse(argv)
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              "device(s); none or too few here", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed % (1 << 63), args.seconds,
                   bool(args.trace), torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    out.pop("_numbers")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
