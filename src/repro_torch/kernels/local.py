"""The kernel wrappers on DTensors and on tensors without storage.

A mesh's activations are ``DTensor`` s (``models.common.shard_hint``).  A
PPA table is nonlinear, so a pending sum (a ``Partial`` placement, as a
row-parallel product leaves) is reduced first; the kernel then runs on
each rank's local shard, and the result carries the input's placements
(:func:`on_local`).

The dry run (``launch/dryrun.py``) runs a step on fake tensors, which have
shapes and no storage: a wrapper given one reports its work to the
``OpCosts`` counters in force and returns an empty (fake) result of the
output's shape and dtype (:func:`no_storage`), launching nothing.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["is_dtensor", "no_storage", "on_local"]


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def no_storage(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (``FakeTensorMode``): shapes, no
    data; or a meta tensor while the dry run counts (an ``OpCosts`` of a
    fake mode in force), which the step made beside its fake ones (a
    buffer of ``torch.empty``).  Otherwise a meta tensor is refused, as
    any tensor off the card."""
    from torch._subclasses.fake_tensor import is_fake

    from ..roofline import op_costs
    return is_fake(t) or (t.device.type == "meta"
                          and op_costs.counting_fakes())


def _localize(t: torch.Tensor, like, pls) -> torch.Tensor:
    """``t`` (broadcastable to the DTensor ``like``; a DTensor or a plain
    tensor holding the global value) cut as ``like`` 's local shard: a dim
    that ``like`` shards and ``t`` spans is cut the same way, a broadcast
    one stays whole."""
    from torch.distributed.tensor import Replicate, Shard

    from ..distributed.sharding import local_at
    lead = like.dim() - t.dim()
    want = []
    for p in pls:
        d = p.dim - lead if isinstance(p, Shard) else -1
        want.append(Shard(d) if d >= 0 and t.shape[d] == like.shape[p.dim]
                    and t.shape[d] > 1 else Replicate())
    return local_at(t, like.device_mesh, want)


def on_local(fn: Callable, x: torch.Tensor, *others: Optional[torch.Tensor],
             axis: Optional[int] = None) -> torch.Tensor:
    """``fn(x, *others)`` elementwise, or along ``axis``: on a plain ``x``
    as it is; on a DTensor ``x`` with any ``Partial`` placement reduced to
    ``Replicate``, on its local shard, with ``others`` (tensors
    broadcastable to ``x``, or None) cut to match, the result wrapped back
    with ``x`` 's placements.  ``axis``, where given, must not be
    sharded."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return fn(x, *others)
    mesh = x.device_mesh
    pls = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if pls != tuple(x.placements):
        x = x.redistribute(mesh, pls)
    if axis is not None:
        ax = axis % x.dim()
        if any(isinstance(p, Shard) and p.dim == ax for p in pls):
            raise ValueError(f"dim {ax} of {tuple(x.shape)} is sharded "
                             f"({pls}): the row must be whole on a rank")
    loc = [None if o is None else _localize(o, x, pls) for o in others]
    y = fn(x.to_local(), *loc)
    return DTensor.from_local(y, mesh, pls, run_check=False, shape=x.shape,
                              stride=x.stride())
