"""The traced sub-windows: a few steps under ``torch.profiler``, held in
memory and summarised, never written out whole.

The first traces the device alone (CUPTI's kernel records cost the host
little): its kernels (name, start, end in microseconds), ``busy_s`` (the
union of their intervals) and ``window_s`` (the host clock over the
traced steps, synchronised) feed the per-layer metrics.  A second, shorter
one traces the host's operations too, only to name the longest idle gaps
by the innermost host operation running at each gap's middle.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, List, Tuple

import numpy as np

__all__ = ["union_s", "gaps", "device_ops", "idle_gaps",
           "profile_steps", "breakdown", "idle_pct", "peak_gib"]

Interval = Tuple[float, float]


def union_s(intervals: List[Interval]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: List[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def _innermost(cpu: np.ndarray, names: List[str], t: float) -> str:
    if not len(cpu):
        return "host: no operation"
    cover = np.nonzero((cpu[:, 0] <= t) & (cpu[:, 1] >= t))[0]
    if not len(cover):
        return "host: no operation"
    j = cover[np.argmin(cpu[cover, 1] - cpu[cover, 0])]
    return "host: " + names[j][:120]


def device_ops(kernels) -> list:
    """The 10 device operations that took most time: [[name, seconds]]."""
    by_name = collections.Counter()
    for name, a, b in kernels:
        by_name[name] += b - a
    return [[n[:160], us / 1e6] for n, us in by_name.most_common(10)]


def idle_gaps(kernels, cpu_ops, t0_us: float, t1_us: float) -> list:
    """The 10 longest stretches of [t0_us, t1_us] with no device operation,
    each named by the innermost host operation at its middle:
    [[name, seconds]]."""
    idle = gaps([(a, b) for _, a, b in kernels], t0_us, t1_us)
    idle.sort(key=lambda g: g[1] - g[0], reverse=True)
    cpu = np.array([(a, b) for _, a, b in cpu_ops], dtype=np.float64
                   ).reshape(-1, 2)
    names = [n for n, _, _ in cpu_ops]
    return [[_innermost(cpu, names, (a + b) / 2), (b - a) / 1e6]
            for a, b in idle[:10]]


def profile_steps(step: Callable[[], dict], n: int, sync: Callable,
                  host: bool) -> dict:
    """Run ``step`` ``n`` times under the profiler, tracing the device's
    operations and, with ``host``, every host operation too (which slows
    the host: the device's busy and idle shares come from a trace
    without it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        recs = [step() for _ in range(n)]
        sync()
        t1 = time.perf_counter()
    events = prof.events()
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in events if e.device_type == DeviceType.CUDA]
    cpu_ops = [(e.name, e.time_range.start, e.time_range.end)
               for e in events if e.device_type == DeviceType.CPU]
    return {"window_s": t1 - t0, "steps": recs, "kernels": kernels,
            "cpu_ops": cpu_ops,
            "busy_s": union_s([(a, b) for _, a, b in kernels]) / 1e6}


def breakdown(device: dict, host: dict) -> dict:
    """The result line's breakdown: device operations from the device-only
    trace, idle gaps from the trace with the host's operations (their
    lengths carry the host tracer's cost)."""
    ops = host["cpu_ops"]
    lo = min((a for _, a, _ in ops), default=0.0)
    hi = max((b for _, _, b in ops + host["kernels"]), default=0.0)
    return {"device_ops": device_ops(device["kernels"]),
            "idle_gaps": idle_gaps(host["kernels"], ops, lo, hi)}


def idle_pct(run: dict):
    """Share of the traced sub-window (host clock, synchronised) in which
    no operation ran on the device: 1 - busy / window, busy the union of
    the profiler's device intervals, in percent."""
    tr = run["trace"]
    if tr is None or not tr["kernels"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def peak_gib(run: dict):
    """The run's peak of device memory allocated, in GiB
    (``torch.cuda.max_memory_allocated``, read after the window and before
    the reference runs)."""
    if not run["memory_peak_bytes"]:
        return None
    return run["memory_peak_bytes"] / 2 ** 30
