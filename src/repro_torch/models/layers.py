"""Shared model building blocks: RMSNorm, rotary embeddings, token
embedding and the LM head.  Cross entropy waits for the training slice."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .common import P

__all__ = ["rmsnorm_params", "rmsnorm", "rope", "rope_freqs",
           "embed_lookup", "lm_head_logits"]


def rmsnorm_params(dim: int, layers: Optional[int] = None) -> dict:
    if layers is None:
        shape, axes = (dim,), ("embed",)
    else:
        shape, axes = (layers, dim), ("layers", "embed")
    return {"scale": P(shape, axes, init="ones")}


def rmsnorm(x: torch.Tensor, params: dict, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


def rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding.  x: (..., T, H, D); positions: (..., T)."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)                  # (D/2,)
    ang = positions.to(torch.float32)[..., None] * freqs      # (..., T, D/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., T, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather.  tokens: (B, T) int -> (B, T, E)."""
    return table[tokens.long()]


def lm_head_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x: (..., E) @ (V, E)^T -> (..., V)."""
    return x @ table.transpose(0, 1)
