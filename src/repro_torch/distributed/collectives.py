"""Collectives over the named axes of a ``DeviceMesh``.

The counterparts of ``jax.lax``'s ``all_gather`` (tiled), ``psum``,
``pmean``, ``ppermute`` and ``axis_index`` inside a ``shard_map``: an op
over several mesh axes runs as one collective a mesh dim, in turn, on that
dim's process group (``DeviceMesh.get_group``).  A sum over two axes is
then taken in another order than one collective over both would take it;
a gather over several axes, innermost first, lands its blocks in the
order of a tiled gather over the axes as given (the first one major).

Every call runs its collectives, also on a group of one rank, where they
are the identity: so a run on one card still goes through NCCL.  On a
tensor that needs a gradient they are differentiable, with the
reference's transpose under ``shard_map(check_vma=False)`` as backward:
a gather's is a reduce-scatter (the functional collective's), a sum's a
sum (:class:`_Sum`).
``counts`` counts the collectives by kind, as the kernels count their
launches.
"""

from __future__ import annotations

import collections
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_reduce", "axis_index", "axis_size", "counts",
           "ppermute", "reset_counts"]

#: collectives run, by kind (the roofline's names)
counts: collections.Counter = collections.Counter()

Axes = Union[str, Sequence[str]]

# ``all_gather_single`` replaces ``all_gather_into_tensor`` in newer torch
_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _gather_autograd():
    """The differentiable tiled gather on dim 0: ``all_gather_single_autograd``
    (its older name, deprecated where the new one exists, before that)."""
    from torch.distributed import _functional_collectives as fc
    return (getattr(fc, "all_gather_single_autograd", None)
            or fc.all_gather_tensor_autograd)


def reset_counts() -> None:
    counts.clear()


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes: Axes) -> int:
    """The number of ranks along ``axes`` together."""
    n = 1
    for a in _axes(axes):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_index(mesh, axes: Axes) -> int:
    """This rank's index along ``axes`` together, the first axis major
    (``jax.lax.axis_index`` of one axis, or the row of a tiled gather over
    several)."""
    idx = 0
    for a in _axes(axes):
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    return idx


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int = 0
               ) -> torch.Tensor:
    """Tiled all-gather of ``x`` along ``dim`` over ``axes``: the blocks of
    the ranks along the axes, concatenated in their order."""
    for a in reversed(_axes(axes)):
        group = mesh.get_group(a)
        n = dist.get_world_size(group)
        src = x.contiguous()
        # the blocks concatenated along dim 0 (the form every backend takes)
        if _needs_grad(src):
            out = _gather_autograd()(src, 0, group)
        else:
            out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            _GATHER(out, src, group=group)
        counts["all-gather"] += 1
        if dim == 0 or n == 1:
            x = out
        else:
            shape = list(src.shape)
            shape[dim] *= n
            x = out.view((n,) + tuple(src.shape)).movedim(0, dim).reshape(
                shape)
    return x


def all_reduce(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum of ``x`` over ``axes`` (``psum``); ``x`` is summed in place when
    it is contiguous, and returned."""
    x = x.contiguous()
    for a in _axes(axes):
        if _needs_grad(x):
            x = _Sum.apply(x, mesh.get_group(a))
        else:
            dist.all_reduce(x, group=mesh.get_group(a))
        counts["all-reduce"] += 1
    return x


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Sum(torch.autograd.Function):
    """The sum over one process group of a tensor that needs a gradient:
    a copy summed in place; its gradient is the sum of the output's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def ppermute(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` of the rank before this one along ``axis`` (in a ring): every
    rank sends its ``x`` to the next."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    if n == 1:
        return x
    i = mesh.get_local_rank(axis)
    src = x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(i + 1) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - 1) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    counts["collective-permute"] += 1
    return out
