"""GPipe-style pipeline parallelism over one mesh dim ("pod").

Counterpart of ``repro/distributed/pipeline.py``.  The layers of one
stacked layer tree are split evenly into ``n_stages`` contiguous stages,
one a rank of the mesh dim: each rank holds only its own ``L / n_stages``
layers.  The classic ``n_micro + n_stages - 1`` rotation schedule keeps
every stage busy after the fill: at tick t, stage s runs microbatch
``t - s`` when ``0 <= t - s < n_micro``, and the ring register moves
stage to stage (``batch_isend_irecv``, the reference's ``ppermute``).  The
last stage's output buffer then reaches every rank by a sum in which the
other stages add zeros (the reference's masked ``psum``), which is exact.
Bubble fraction = (S-1)/(M+S-1) (``bubble_fraction``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from ..tree import leaves, map_tree
from .collectives import all_reduce, axis_size, ppermute

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _stage_layers(stack_params, stage: int, n_stages: int):
    """This stage's layers: a DTensor leaf sharded over the stages gives
    its local tensor; a plain leaf is the whole stack (L, ...), of which
    the stage takes its contiguous L / n_stages."""
    def leaf(t):
        if isinstance(t, DTensor):
            return t.to_local()
        n = t.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        per = n // n_stages
        return t[stage * per:(stage + 1) * per]
    return map_tree(leaf, stack_params)


def pipeline_apply(
    body: Callable,          # body(h, layer_params) -> h  (one layer)
    stack_params,            # tree; leaves (L, ...), L % n_stages == 0
    h: torch.Tensor,         # (B, T, D) stage input (full batch)
    mesh,
    *,
    n_micro: int,
    axis: str = "pod",
) -> torch.Tensor:
    """Run a stacked layer tree as a pipeline over ``axis`` of ``mesh``.

    ``h`` (the same on every rank) is split along the batch into
    ``n_micro`` microbatches; every stage runs its own layers on each
    microbatch in turn.  Returns the output of the whole stack on every
    rank."""
    n_stages = axis_size(mesh, axis)
    stage = mesh.get_local_rank(axis)
    b = h.shape[0]
    assert b % n_micro == 0, (b, n_micro)
    assert n_micro % n_stages == 0, \
        "n_micro must be a multiple of n_stages (ring schedule)"
    local = _stage_layers(stack_params, stage, n_stages)
    n_local = leaves(local)[0].shape[0]
    mb = torch.stack(torch.split(h, b // n_micro, dim=0))  # (M, b/M, T, D)

    def run_stage(x):
        for j in range(n_local):
            x = body(x, map_tree(lambda t, j=j: t[j], local))
        return x

    out_buf = torch.zeros_like(mb)
    reg = torch.zeros_like(mb[0])
    last = n_stages - 1
    for t in range(n_micro + n_stages - 1):
        my_mb = t - stage
        take = 0 <= my_mb < n_micro
        idx = min(max(my_mb, 0), n_micro - 1)
        # stage 0 loads a fresh microbatch; the others take the register
        x_in = mb[idx] if stage == 0 else reg
        y = run_stage(x_in) if take else reg
        if take and stage == last:
            out_buf[idx] = y
        # rotate: stage s sends to s+1 (the last sends to 0, discarded)
        reg = ppermute(y, mesh, axis)
    # every stage holds out_buf; only the last stage's is real
    if stage != last:
        out_buf.zero_()
    return all_reduce(out_buf, mesh, axis).reshape(h.shape)

