"""Parameter specs shared by the models, and the sharding context.

Models declare their parameters as nested dicts of :class:`P` specs —
shape, logical axis names and initializer — in the layouts of the JAX
package (stacked ``layers`` axis first; ``wq (d, h, e)``, ``wo (h, e, d)``),
so a parameter tree carries across unchanged (:func:`params_from_jax`).
:class:`ShardCtx` carries a ``DeviceMesh`` to the layers that run
collectives (the sharded MoE block); without one every layer runs on one
process.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..tree import map_tree

__all__ = ["P", "ShardCtx", "init_params", "pad_to", "params_from_jax",
           "map_tree"]


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
    """A ``torch.distributed`` ``DeviceMesh`` and its axis names for the
    layers that run collectives (the sharded MoE block).  ``mesh=None``
    (the default) means one process: the MoE block takes its local,
    collective-free path.  With a mesh, the dense layers run replicated on
    every rank (the reference's compiler partitions them; eager PyTorch
    does not), and the MoE block shards its experts over the mesh."""

    mesh: Any = None                          # DeviceMesh or None
    dp_axes: Tuple[str, ...] = ("data",)      # batch axes (may include pod)
    tp_axis: Optional[str] = "model"
    batch_sharded: bool = True                # False for long_500k (B=1)
    # The reference's seq_shard, psched() and batch_spec serve only its
    # shard_hint, which is not ported yet; they come with it.
