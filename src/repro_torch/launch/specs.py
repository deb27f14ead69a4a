"""Abstract input specs per (arch x shape): descriptors, no allocation.

Counterpart of ``repro/launch/specs.py``.  A descriptor is
:class:`Abstract` (shape, dtype, spec), the ``jax.ShapeDtypeStruct`` with a
``NamedSharding`` of the reference: ``spec`` is a tuple with, for each
dim, None, a mesh axis or a tuple of them (``distributed/sharding.py``),
or None for a leaf the caller places (the decode cache, by
``cache_shardings``).  ``active_params`` is the roofline's
(``roofline/analysis.py``), under the reference's name here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..configs import ShapeProfile
from ..distributed.sharding import dp_axes_of
from ..models.config import ModelCfg
from ..models.transformer import dtype_of, init_cache
from ..roofline.analysis import active_params
from ..tree import map_tree

__all__ = ["Abstract", "input_specs", "active_params", "tokens_of_shape"]


@dataclasses.dataclass(frozen=True)
class Abstract:
    """A tensor that is never allocated: shape, dtype and placement."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Optional[tuple]


def tokens_of_shape(shape: ShapeProfile) -> int:
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch          # decode: one token per sequence


def input_specs(cfg: ModelCfg, shape: ShapeProfile, mesh,
                batch_sharded: bool = True) -> Dict[str, object]:
    """Model inputs for one cell.  For decode kinds also the abstract
    cache (``init_cache`` on the meta device: nothing is allocated)."""
    dp = dp_axes_of(mesh)
    b = shape.global_batch
    bspec = (dp if len(dp) > 1 else dp[0]) if (batch_sharded and dp) \
        else None
    cdt = dtype_of(cfg.compute_dtype)

    def extras():
        out = {}
        if cfg.enc_layers:
            out["enc_feats"] = Abstract((b, cfg.enc_seq, cfg.d_model), cdt,
                                        (bspec, None, None))
        if cfg.vision_tokens:
            out["vision_embeds"] = Abstract(
                (b, cfg.vision_tokens, cfg.d_model), cdt,
                (bspec, None, None))
        return out

    if shape.kind in ("train", "prefill"):
        toks = Abstract((b, shape.seq_len), torch.int32, (bspec, None))
        out = {"tokens": toks}
        if shape.kind == "train":
            out["labels"] = toks
        return {**out, **extras()}
    if shape.kind == "decode":
        cache = init_cache(cfg, b, shape.seq_len, torch.bfloat16,
                           device="meta")
        return {
            "tokens": Abstract((b, 1), torch.int32, (bspec, None)),
            "pos": Abstract((b,), torch.int32, (bspec,)),
            "cache": map_tree(
                lambda t: Abstract(tuple(t.shape), t.dtype, None), cache),
        }
    raise ValueError(shape.kind)
