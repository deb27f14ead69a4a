"""Grouped-query attention, dense path: prefill and decode.

Counterpart of the dense path of ``repro/models/attention.py``, with its
layouts at the public functions: activations (B, T, H, D), scores
(B, Hk, G, T, S).  The softmax goes through the ActBundle, so with a PPA
bundle on the card it is the softmax kernel (csrc/softmax_ppa.cu) with the
validity mask.  Decode keeps a ring-buffer KV cache: slots are addressed
``pos % len`` and each slot remembers its absolute position.  Unlike the
reference, decode writes the new K/V into the cache in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..device import resolve_device
from .activations import ActBundle
from .common import P
from .layers import rope

__all__ = ["AttnCfg", "attn_params", "attention", "decode_attention",
           "init_kv_cache"]


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    """Global causal GQA with RoPE (no QKV bias, qk-norm or window yet)."""

    d_model: int
    n_q: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.head_dim)


def attn_params(cfg: AttnCfg, layers: Optional[int] = None) -> dict:
    """Parameter specs.  With ``layers`` set, a leading stack dim is added."""
    def lp(shape, axes, **kw):
        if layers is None:
            return P(shape, axes, **kw)
        return P((layers,) + shape, ("layers",) + axes, **kw)

    d, hq, hk, dh = cfg.d_model, cfg.n_q, cfg.n_kv, cfg.head_dim
    return {
        "wq": lp((d, hq, dh), ("embed", "q_heads", "head")),
        "wk": lp((d, hk, dh), ("embed", "kv_heads", "head")),
        "wv": lp((d, hk, dh), ("embed", "kv_heads", "head")),
        "wo": lp((hq, dh, d), ("q_heads", "head", "embed")),
    }


def _project_qkv(params: dict, cfg: AttnCfg, x: torch.Tensor,
                 pos: torch.Tensor):
    q = torch.einsum("btd,dhe->bthe", x, params["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, params["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, params["wv"])
    q = rope(q, pos, theta=cfg.rope_theta)
    k = rope(k, pos, theta=cfg.rope_theta)
    return q, k, v


def _mask(q_pos, k_pos) -> torch.Tensor:
    """(..., T, S) bool causal validity from absolute positions (an empty
    ring slot has position -1)."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    return (kp >= 0) & (kp <= qp)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with JAX's dtype promotion (a bfloat16 cache against float32
    weights computes in float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _dense_attn(q, k, v, valid, scale, acts: ActBundle) -> torch.Tensor:
    """q: (B,T,Hq,D), k/v: (B,S,Hk,D), valid: (B,T,S) bool."""
    b, t, hq, dh = q.shape
    hk = k.shape[2]
    g = hq // hk
    qg = q.reshape(b, t, hk, g, dh)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    w = acts.softmax(scores, axis=-1, where=valid[:, None, None])
    out = _einsum("bhgts,bshd->bthgd", w.to(v.dtype), v)
    return out.reshape(b, t, hq, dh)


def attention(params: dict, cfg: AttnCfg, x: torch.Tensor, acts: ActBundle,
              *, positions: Optional[torch.Tensor] = None,
              return_kv: bool = False):
    """Full-sequence causal self-attention (prefill).  With ``return_kv``
    also returns the post-rope K and V for the decode cache."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device).expand(b, t)
    q, k, v = _project_qkv(params, cfg, x, positions)
    valid = _mask(positions, positions)
    out = _dense_attn(q, k, v, valid, cfg.scale, acts)
    y = torch.einsum("bthd,hde->bte", out, params["wo"])
    if return_kv:
        return y, (k, v)
    return y


def init_kv_cache(batch: int, cache_len: int, cfg: AttnCfg,
                  dtype=torch.bfloat16, device=None) -> dict:
    device = resolve_device(device)
    return {
        "k": torch.zeros((batch, cache_len, cfg.n_kv, cfg.head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, cfg.n_kv, cfg.head_dim),
                         dtype=dtype, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def decode_attention(params: dict, cfg: AttnCfg, x: torch.Tensor,
                     cache: dict, pos: torch.Tensor, acts: ActBundle
                     ) -> Tuple[torch.Tensor, dict]:
    """One decode step: write the new K/V into its ring slot (in place),
    attend.  x: (B, 1, D); pos: (B,) absolute position of the new token."""
    b = x.shape[0]
    cache_len = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(params, cfg, x, pos[:, None])
    slot = (pos % cache_len).long()
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = pos.to(torch.int32)
    valid = _mask(pos[:, None], cache["pos"])             # (B, 1, S)
    out = _dense_attn(q, cache["k"], cache["v"], valid, cfg.scale, acts)
    y = _einsum("bthd,hde->bte", out, params["wo"])
    return y, cache
