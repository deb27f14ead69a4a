"""Shared model building blocks: RMSNorm and LayerNorm, rotary
embeddings, token embedding, the LM head and the chunked cross-entropy
loss."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.local import is_dtensor
from .common import P, ShardCtx, shard_hint, tp_matmul

__all__ = ["rmsnorm_params", "rmsnorm", "layernorm_params", "layernorm",
           "mean_last", "rope", "rope_freqs",
           "embed_lookup", "lm_head_logits", "cross_entropy_chunked"]


def _norm_spec(dim: int, layers: Optional[int], with_bias: bool) -> dict:
    if layers is None:
        shape, axes = (dim,), ("embed",)
    else:
        shape, axes = (layers, dim), ("layers", "embed")
    out = {"scale": P(shape, axes, init="ones")}
    if with_bias:
        out["bias"] = P(shape, axes, init="zeros")
    return out


def rmsnorm_params(dim: int, layers: Optional[int] = None) -> dict:
    return _norm_spec(dim, layers, with_bias=False)


def layernorm_params(dim: int, layers: Optional[int] = None) -> dict:
    return _norm_spec(dim, layers, with_bias=True)


def rmsnorm(x: torch.Tensor, params: dict, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


def mean_last(x: torch.Tensor) -> torch.Tensor:
    """The mean over the last axis, kept, as ``jnp.mean`` takes it: the sum
    in float32 (a 16-bit input is widened), divided by the count, then
    rounded to the input's dtype."""
    n = x.shape[-1]
    return (x.to(torch.float32).sum(dim=-1, keepdim=True) / n).to(x.dtype)


def layernorm(x: torch.Tensor, params: dict, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm in float32 with ``jnp.var``'s formula, the mean of the
    centred squares (not Welford's), and an optional bias."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = mean_last(xf)
    var = mean_last(torch.square(xf - mu))
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(torch.float32)
    if "bias" in params:
        y = y + params["bias"].to(torch.float32)
    return y.to(dt)


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


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Embedding gather.  tokens: (B, T) int -> (B, T, E).  On a mesh it is
    the reference's lowering: the table's shards all-gathered, then a
    local gather of the rank's batch rows, hinted batch over the dp
    axes."""
    if ctx is None or ctx.mesh is None:
        return table[tokens.long()]
    from ..distributed.sharding import local_call
    bs = ctx.batch_spec
    out = local_call(ctx.mesh, lambda tab, tok: tab[tok.long()],
                     [(table, (None, None)), (tokens, (bs, None))],
                     (bs, None, None),
                     shape=tuple(tokens.shape) + (table.shape[1],))
    return shard_hint(out, ctx, bs, None, None)


def lm_head_logits(x: torch.Tensor, table: torch.Tensor,
                   ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """x: (..., E) @ (V, E)^T -> (..., V); on a mesh vocab-parallel (the
    logits' last dim split over "model")."""
    return tp_matmul(x, table.transpose(0, 1), ctx)


def _chunk_nll(xs: torch.Tensor, head: torch.Tensor, ls: torch.Tensor,
               ms: torch.Tensor, ctx: Optional[ShardCtx] = None
               ) -> torch.Tensor:
    logits = lm_head_logits(xs.to(torch.float32), head.to(torch.float32),
                            ctx)
    if is_dtensor(logits):
        lse, gold = _lse_gold_placed(logits, ls)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ls.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * ms)


def _lse_gold_placed(logits, labels):
    """logsumexp and the label's logit of DTensor logits (B, T, V), the
    vocab possibly sharded (vocab-parallel): the max and the sum reduce
    across the shards, and each rank picks the labels that fall in its
    vocab range, the others adding 0 (a pending sum over the ranks that
    split the vocab)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from ..distributed.sharding import local_at
    mesh = logits.device_mesh
    pls = [Replicate() if p.is_partial() else p for p in logits.placements]
    logits = logits.redistribute(mesh, pls)
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.sum(torch.exp(logits - m), dim=-1,
                                   keepdim=True)))[..., 0]
    shape, off = compute_local_shape_and_global_offset(logits.shape, mesh,
                                                       pls)
    v0, vn = off[-1], shape[-1]
    rows = [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
            for p in pls]
    lab = local_at(labels, mesh, rows).long()
    mine = (lab >= v0) & (lab < v0 + vn)
    g = torch.gather(logits.to_local(), -1,
                     (lab - v0).clamp(0, vn - 1)[..., None])[..., 0]
    g = torch.where(mine, g, 0.0)
    gold = DTensor.from_local(
        g, mesh, [Partial() if isinstance(p, Shard) and p.dim == 2 else q
                  for p, q in zip(pls, rows)],
        run_check=False, shape=lse.shape, stride=lse.stride())
    return lse, gold


def cross_entropy_chunked(x: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *,
                          mask: Optional[torch.Tensor] = None,
                          num_chunks: int = 8,
                          ctx: Optional[ShardCtx] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy without materializing the full (B, T, V) logits.

    x: (B, T, E) final hidden, head: (V, E), labels: (B, T) int.  The
    sequence is cut into ``num_chunks`` chunks (fewer when T does not
    divide: the largest count that does); each chunk's float32 logits
    against the float32 head are recomputed in the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` in the reference).
    Returns (mean_nll, denom)."""
    b, t, _ = x.shape
    while t % num_chunks:
        num_chunks -= 1
    if mask is None:
        mask = torch.ones((b, t), dtype=torch.float32, device=x.device)
    c = t // num_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num_chunks):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_nll, x[:, sl], head,
                                   labels[:, sl], mask[:, sl], ctx,
                                   use_reentrant=False)
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    return total / denom, denom
