"""Parameter specs shared by the models, and the sharding context.

Models declare their parameters as nested dicts of :class:`P` specs —
shape, logical axis names and initializer — in the layouts of the JAX
package (stacked ``layers`` axis first; ``wq (d, h, e)``, ``wo (h, e, d)``),
so a parameter tree carries across unchanged (:func:`params_from_jax`).
:class:`ShardCtx` carries a ``DeviceMesh`` to the layers; without one
every layer runs on one process.  :func:`shard_hint` is the reference's
``with_sharding_constraint``: on a mesh the activations are ``DTensor`` s,
and a hint redistributes one to the placements of its spec.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..tree import map_tree

__all__ = ["LOCAL", "P", "ShardCtx", "hint_counts", "init_params", "pad_to",
           "params_from_jax", "map_tree", "on_mesh", "shard_hint", "tp_matmul"]

#: ``shard_hint`` 's redistributes (one a hint on a mesh, an identity
#: redistribute included)
hint_counts = {"redistributes": 0}


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter spec."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones
    scale: Optional[float] = None   # stddev override for normal init
    dtype: Any = None           # override the tree-level param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def init_params(specs, seed: int = 0, dtype=torch.float32, device=None):
    """Materialize a spec tree on ``device`` (None: the card) from one
    ``torch.Generator`` seeded with ``seed``.  Fan-in scaled normal (the
    second-to-last axis is the contraction) unless the spec gives a
    stddev; norm scales ones.  A leaf is drawn in float32 and cast, one
    layer slice at a time when it is stacked on a ``layers`` axis, into a
    tensor of its own dtype: a stacked expert leaf at full width would not
    fit in float32 beside the model."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, std):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return w.mul_(std)

    def mk(spec: P):
        dt = spec.dtype or dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        if spec.scale is not None:
            std = spec.scale
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = 1.0 / math.sqrt(max(1, fan_in))
        if spec.axes[0] != "layers":
            return draw(spec.shape, std).to(dt)
        out = torch.empty(spec.shape, dtype=dt, device=dev)
        for j in range(spec.shape[0]):
            out[j] = draw(spec.shape[1:], std)
        return out

    return map_tree(mk, specs)


def params_from_jax(tree, device=None):
    """Carry a parameter tree of the JAX package over, or its train state
    (``train_init``'s ``{"step", "opt": {"count", "mu"}}``, int8 moments
    and their scales included): every leaf (numpy or anything
    ``np.asarray`` takes) becomes a tensor of the same shape, layout and
    dtype on ``device`` (None: the card)."""
    dev = resolve_device(device)
    return map_tree(
        lambda a: torch.as_tensor(np.array(a), device=dev), tree)



def pad_to(n: int, multiple: int) -> int:
    """Round n up to a multiple (sharding divisibility padding)."""
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A ``torch.distributed`` ``DeviceMesh`` and its axis names.
    ``mesh=None`` (the default) means one process: every hint is the
    identity and the MoE block takes its local, collective-free path.
    With a mesh the parameters, inputs and cache are ``DTensor`` s placed
    by the rule tables, the dense layers run as DTensor ops with the
    reference's hints between them, and the MoE block computes on its
    local shards with its own collectives.

    The reference's ``seq_shard`` field and ``psched()`` are left out:
    nothing in the JAX package reads them (``seq_shard`` is only stored by
    its ``make_ctx``, ``psched`` has no caller)."""

    mesh: Any = None                          # DeviceMesh or None
    dp_axes: Tuple[str, ...] = ("data",)      # batch axes (may include pod)
    tp_axis: Optional[str] = "model"
    batch_sharded: bool = True                # False for long_500k (B=1)

    @property
    def batch_spec(self):
        """The batch dim's spec entry: the dp axes, or None (replicated)
        off-mesh or when the batch is not sharded."""
        return tuple(self.dp_axes) if (self.batch_sharded and self.mesh)\
            else None


#: one process: no mesh (a model function's ``ctx`` when it is given none)
LOCAL = ShardCtx()


def on_mesh(ctx: Optional[ShardCtx]):
    """The context a model entry point runs in: on a mesh, plain tensors
    it makes (positions, masks, zeros) take part in DTensor ops as
    replicated ones; off-mesh nothing."""
    if ctx is None or ctx.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def tp_matmul(x: torch.Tensor, w: torch.Tensor, ctx: Optional[ShardCtx],
              row: bool = False) -> torch.Tensor:
    """``x @ w`` (x (..., k), w (k, n)).  On a mesh (``x`` a DTensor) it
    is Megatron's tensor-parallel product on each rank's batch rows over
    the dp axes, ``w`` gathered whole on its other dim (FSDP):
    column-parallel (``w`` 's columns and the output's last dim split over
    "model") or, with ``row``, row-parallel (``x`` 's last dim and
    ``w`` 's rows split over "model", the output a pending sum over it)."""
    from ..kernels.local import is_dtensor
    if ctx is None or ctx.mesh is None or not is_dtensor(x):
        return x @ w
    from ..distributed.sharding import local_call
    bs, tp = ctx.batch_spec, ctx.tp_axis
    lead = (bs,) + (None,) * (x.dim() - 2)
    if row:
        ins, out = [(x, lead + (tp,)), (w, (tp, None))], lead + (None,)
    else:
        ins, out = [(x, lead + (None,)), (w, (None, tp))], lead + (tp,)
    return local_call(ctx.mesh, torch.matmul, ins, out,
                      shape=tuple(x.shape[:-1]) + (w.shape[-1],),
                      partial=(tp,) if row else ())


def shard_hint(x: torch.Tensor, ctx: Optional[ShardCtx], *axes
               ) -> torch.Tensor:
    """The reference's ``with_sharding_constraint``: the identity when
    ``ctx.mesh`` is None; on a mesh, ``x`` (a DTensor, or a plain tensor
    taken as replicated) redistributed to the placements of ``axes``, one
    spec entry a dim (None, a mesh axis, or a tuple of them)."""
    if ctx is None or ctx.mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    from ..distributed.sharding import placements
    mesh = ctx.mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    hint_counts["redistributes"] += 1
    return x.redistribute(mesh, placements(axes, mesh))
