"""int8 error-feedback gradient all-reduce (pure-DP sync path).

Counterpart of ``repro/distributed/compression.py``.  For replicated-
parameter data parallelism the gradient all-reduce volume dominates the
links between hosts.  Each tensor is compressed to int8 with a per-row
float32 scale before it goes on the wire, and the quantization residual is
carried in an error-feedback buffer (the 1-bit Adam / EF-SGD lineage):
what is lost this step is re-injected next step, so the *accumulated*
gradient is preserved.

Usage, on every rank of a mesh dim's group:
``g_sync, new_err = ef_allreduce(g_local + err, axis, mesh)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..tree import map_trees
from .collectives import all_gather

__all__ = ["q8_encode", "q8_decode", "ef_allreduce", "ef_allreduce_tree"]


def q8_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and their float32 scale (one a row, the last axis's
    largest magnitude / 127); rounds half to even, as the reference."""
    xf = x.to(torch.float32)
    if x.dim() == 0:
        scale = torch.clamp_min(xf.abs(), 1e-30) / 127.0
    else:
        scale = xf.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp_min(scale, 1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def q8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_allreduce(g_with_err: torch.Tensor, axis: str, mesh
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress -> all-gather (int8 + scales) over ``axis`` of ``mesh`` ->
    decode and average locally in float32.

    The wire carries the int8 tensor and one float32 scale a row (a 3.9x
    byte reduction against a float32 all-reduce).  Returns the mean and
    err = local value - its own decode, which the caller re-injects next
    step (error feedback)."""
    q, s = q8_encode(g_with_err)
    err = g_with_err.to(torch.float32) - q8_decode(q, s)
    qg = all_gather(q[None], mesh, axis)          # (n, ...) int8 on wire
    sg = all_gather(s[None], mesh, axis)
    mean = torch.mean(qg.to(torch.float32) * sg, dim=0)
    return mean, err


def ef_allreduce_tree(grads, errs, axis: str, mesh):
    """Tree version (nested dicts): returns (synced_grads, new_errs)."""
    out = map_trees(
        lambda g, e: ef_allreduce(g.to(torch.float32) + e, axis, mesh),
        grads, errs)
    return _split(out, 0), _split(out, 1)


def _split(tree, i: int):
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    return tree[i]
