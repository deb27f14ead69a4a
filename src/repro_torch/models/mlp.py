"""Gated (SwiGLU-family) and plain MLP blocks."""

from __future__ import annotations

from typing import Optional

import torch

from .activations import ActBundle
from .common import LOCAL, P, ShardCtx, shard_hint, tp_matmul

__all__ = ["gated_mlp_params", "gated_mlp", "mlp_params", "mlp"]


def _lp(layers, shape, axes, **kw):
    if layers is None:
        return P(shape, axes, **kw)
    return P((layers,) + shape, ("layers",) + axes, **kw)


def gated_mlp_params(d_model: int, d_ff: int, layers: Optional[int] = None
                     ) -> dict:
    return {
        "w_gate": _lp(layers, (d_model, d_ff), ("embed", "mlp")),
        "w_up": _lp(layers, (d_model, d_ff), ("embed", "mlp")),
        "w_down": _lp(layers, (d_ff, d_model), ("mlp", "embed")),
    }


def gated_mlp(params: dict, x: torch.Tensor, acts: ActBundle,
              gate: str = "silu", ctx: Optional[ShardCtx] = None
              ) -> torch.Tensor:
    """SwiGLU: down( act(x @ w_gate) * (x @ w_up) ).  With a PPA bundle the
    silu is the gated sigmoid_wide table (the fused kernel on the card).
    On a mesh the hidden is hinted (batch, -, model) before the down
    projection."""
    ctx = ctx or LOCAL
    g = tp_matmul(x, params["w_gate"], ctx)
    u = tp_matmul(x, params["w_up"], ctx)
    h = acts.gate(gate)(g) * u
    h = shard_hint(h, ctx, ctx.batch_spec, None, ctx.tp_axis)
    return tp_matmul(h, params["w_down"], ctx, row=True)


def mlp_params(d_model: int, d_ff: int, layers: Optional[int] = None,
               bias: bool = False) -> dict:
    out = {
        "w_up": _lp(layers, (d_model, d_ff), ("embed", "mlp")),
        "w_down": _lp(layers, (d_ff, d_model), ("mlp", "embed")),
    }
    if bias:
        out["b_up"] = _lp(layers, (d_ff,), ("mlp",), init="zeros")
        out["b_down"] = _lp(layers, (d_model,), ("embed",), init="zeros")
    return out


def mlp(params: dict, x: torch.Tensor, acts: ActBundle,
        gate: str = "gelu", ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Plain 2-layer MLP (whisper's): down(act(x @ w_up + b_up)) + b_down.
    With a PPA bundle the gelu is the gated ``gelu_inner`` table (the fused
    kernel on the card)."""
    ctx = ctx or LOCAL
    h = tp_matmul(x, params["w_up"], ctx)
    if "b_up" in params:
        h = h + params["b_up"]
    h = shard_hint(acts.gate(gate)(h), ctx, ctx.batch_spec, None,
                   ctx.tp_axis)
    y = tp_matmul(h, params["w_down"], ctx, row=True)
    if "b_down" in params:
        y = y + params["b_down"]
    return y
