"""Grouped-query attention: prefill (dense or flash-chunked) and decode.

Counterpart of ``repro/models/attention.py`` for self-attention, with its
layouts at the public functions: activations (B, T, H, D), scores
(B, Hk, G, T, S).  Options: QKV bias (qwen2), qk-norm (qwen3), a sliding
window, RoPE theta.  The dense softmax goes through the ActBundle, so with
a PPA bundle on the card it is the softmax kernel (csrc/softmax_ppa.cu)
with the validity mask.  The flash path is the reference's online softmax
over KV chunks, a Python loop here; its exponentials go through
``acts.exp_decay`` (on the card, the fused kernel on the ``exp_neg``
table).  Decode keeps a ring-buffer KV cache: slots are addressed
``pos % len`` and each slot remembers its absolute position, so a windowed
stage keeps a ring of its window.  Unlike the reference, decode writes the
new K/V into the cache in place.  Cross attention (``x_kv``: whisper's
decoder on its encoder's output) has no rope on either side and no mask;
prefill caches the encoder's K/V (``cross_kv``'s), which
``cross_attention_cached`` reads at each decode step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..device import resolve_device
from ..kernels.local import is_dtensor
from .activations import ActBundle
from .common import LOCAL, P, ShardCtx, shard_hint
from .layers import rmsnorm, rope

__all__ = ["AttnCfg", "attn_params", "attention", "cross_attention_cached",
           "cross_kv", "decode_attention", "init_kv_cache"]


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_q: int                    # query heads
    n_kv: int                   # kv heads
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    window: Optional[int] = None   # sliding window (None = global)
    flash_chunk: int = 1024     # KV chunk for the flash path
    softmax_scale: Optional[float] = None

    @property
    def scale(self) -> float:
        return self.softmax_scale or 1.0 / math.sqrt(self.head_dim)


def attn_params(cfg: AttnCfg, layers: Optional[int] = None) -> dict:
    """Parameter specs.  With ``layers`` set, a leading stack dim is added."""
    def lp(shape, axes, **kw):
        if layers is None:
            return P(shape, axes, **kw)
        return P((layers,) + shape, ("layers",) + axes, **kw)

    d, hq, hk, dh = cfg.d_model, cfg.n_q, cfg.n_kv, cfg.head_dim
    out = {
        "wq": lp((d, hq, dh), ("embed", "q_heads", "head")),
        "wk": lp((d, hk, dh), ("embed", "kv_heads", "head")),
        "wv": lp((d, hk, dh), ("embed", "kv_heads", "head")),
        "wo": lp((hq, dh, d), ("q_heads", "head", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = lp((hq, dh), ("q_heads", "head"), init="zeros")
        out["bk"] = lp((hk, dh), ("kv_heads", "head"), init="zeros")
        out["bv"] = lp((hk, dh), ("kv_heads", "head"), init="zeros")
    if cfg.qk_norm:
        out["q_norm"] = {"scale": lp((dh,), ("head",), init="ones")}
        out["k_norm"] = {"scale": lp((dh,), ("head",), init="ones")}
    return out


def _on_mesh(ctx: Optional[ShardCtx], x) -> bool:
    return ctx is not None and ctx.mesh is not None and is_dtensor(x)


def _heads_proj(x: torch.Tensor, w: torch.Tensor,
                ctx: Optional[ShardCtx]) -> torch.Tensor:
    """``einsum("btd,dhe->bthe")``; on a mesh column-parallel: each rank's
    batch rows against its heads of the whole (FSDP-gathered) weight."""
    if not _on_mesh(ctx, x):
        return torch.einsum("btd,dhe->bthe", x, w)
    from ..distributed.sharding import local_call
    bs, tp = ctx.batch_spec, ctx.tp_axis
    return local_call(
        ctx.mesh, lambda a, b: torch.einsum("btd,dhe->bthe", a, b),
        [(x, (bs, None, None)), (w, (None, tp, None))], (bs, None, tp, None),
        shape=(x.shape[0], x.shape[1], w.shape[1], w.shape[2]))


def _out_proj(out: torch.Tensor, w: torch.Tensor,
              ctx: Optional[ShardCtx]) -> torch.Tensor:
    """``_einsum("bthd,hde->bte")``; on a mesh row-parallel: each rank's
    heads against its rows of the weight, the result a pending sum over
    "model"."""
    if not _on_mesh(ctx, out):
        return _einsum("bthd,hde->bte", out, w)
    from ..distributed.sharding import local_call
    bs, tp = ctx.batch_spec, ctx.tp_axis
    return local_call(
        ctx.mesh, lambda a, b: _einsum("bthd,hde->bte", a, b),
        [(out, (bs, None, tp, None)), (w, (tp, None, None))],
        (bs, None, None), shape=(out.shape[0], out.shape[1], w.shape[2]),
        partial=(tp,))


def _project_q(params: dict, cfg: AttnCfg, x: torch.Tensor,
               pos: Optional[torch.Tensor], ctx: Optional[ShardCtx] = None
               ) -> torch.Tensor:
    """The query projection, then the bias, the qk rmsnorm and RoPE (none
    where ``pos`` is None: cross attention)."""
    q = _heads_proj(x, params["wq"], ctx)
    if cfg.qkv_bias:
        q = q + params["bq"]
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
    if pos is not None:
        q = rope(q, pos, theta=cfg.rope_theta)
    return q


def _project_kv(params: dict, cfg: AttnCfg, x: torch.Tensor,
                pos: Optional[torch.Tensor], ctx: Optional[ShardCtx] = None):
    """The key and value projections, as :func:`_project_q`."""
    k = _heads_proj(x, params["wk"], ctx)
    v = _heads_proj(x, params["wv"], ctx)
    if cfg.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        k = rmsnorm(k, params["k_norm"])
    if pos is not None:
        k = rope(k, pos, theta=cfg.rope_theta)
    return k, v


def _mask(q_pos, k_pos, cfg: AttnCfg, window: Optional[int]
          ) -> torch.Tensor:
    """(..., T, S) bool validity from absolute positions (an empty ring
    slot has position -1)."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    valid = kp >= 0
    if cfg.causal:
        valid = valid & (kp <= qp)
    if window is not None:
        valid = valid & (kp > qp - window)
    return valid


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


def _flash_attn(q, k, v, q_pos, k_pos, cfg: AttnCfg, window,
                acts: ActBundle) -> torch.Tensor:
    """Online softmax over KV chunks: the reference's ``lax.scan`` as a
    Python loop with the same (m, l, acc) recurrence.  The chunk is
    ``cfg.flash_chunk``, shrunk until it divides S.  Each exponential is
    ``acts.exp_decay(-x)`` = e^x for x <= 0, on the chunk scores and the
    running-max rescale factors alike."""
    b, t, hq, dh = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = hq // hk
    c = min(cfg.flash_chunk, s)
    while s % c:
        c -= 1
    qg = q.reshape(b, t, hk, g, dh).to(torch.float32)

    def expfn(x):
        return acts.exp_decay(-x)

    m = torch.full((b, hk, g, t), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hk, g, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, g, t, dh), dtype=torch.float32,
                      device=q.device)
    for j in range(s // c):
        sl = slice(j * c, (j + 1) * c)
        pj = k_pos[..., sl]
        valid = _mask(q_pos, pj if pj.dim() == 2 else pj[None], cfg,
                      window)[:, None, None]             # (b, 1, 1, t, c)
        sc = torch.einsum("bthgd,bshd->bhgts", qg,
                          k[:, sl].to(torch.float32)) * cfg.scale
        sc = torch.where(valid, sc, float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(valid, expfn(sc - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), expfn(m - m_new), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgts,bshd->bhgtd", p, v[:, sl].to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, dh).to(q.dtype)


def _heads_local(ctx: ShardCtx, fn, q, k, v, *extra) -> torch.Tensor:
    """``fn(q, k, v, *extra)``, the attention core; on a mesh on each
    rank's batch rows and heads (as ``shard_map`` would run it: every
    (row, head) is independent), ``extra`` given as (tensor, spec)
    pairs."""
    if ctx.mesh is None or not is_dtensor(q):
        return fn(q, k, v, *(t for t, _ in extra))
    from ..distributed.sharding import local_call
    hs = (ctx.batch_spec, None, ctx.tp_axis, None)
    return local_call(ctx.mesh, fn, [(q, hs), (k, hs), (v, hs), *extra], hs,
                      shape=q.shape)


def _arange(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=device).expand(b, t)


def attention(params: dict, cfg: AttnCfg, x: torch.Tensor, acts: ActBundle,
              *, x_kv: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None,
              window: Optional[int] = None, impl: str = "dense",
              return_kv: bool = False, ctx: Optional[ShardCtx] = None):
    """Full-sequence attention (training and prefill), ``impl`` "dense" or
    "flash"; ``window`` overrides ``cfg.window``.  Self-attention on ``x``,
    or cross attention from ``x`` to ``x_kv`` (its positions ``arange(S)``,
    no rope on either side).  With ``return_kv`` also returns the
    (post-rope) K and V: the decode cache's entries, or ``cross_kv``'s.
    On a mesh (``ctx``) q, k and the output are hinted heads over
    "model"."""
    ctx = ctx or LOCAL
    b, t, _ = x.shape
    if positions is None:
        positions = _arange(b, t, x.device)
    if x_kv is None:
        q = _project_q(params, cfg, x, positions, ctx)
        k, v = _project_kv(params, cfg, x, positions, ctx)
        kv_positions = positions
    else:
        q = _project_q(params, cfg, x, None, ctx)
        k, v = _project_kv(params, cfg, x_kv, None, ctx)
        kv_positions = _arange(b, x_kv.shape[1], x.device)
    q = shard_hint(q, ctx, ctx.batch_spec, None, ctx.tp_axis, None)
    k = shard_hint(k, ctx, ctx.batch_spec, None, ctx.tp_axis, None)
    win = window if window is not None else cfg.window
    bs = (ctx.batch_spec, None)
    if impl == "flash":
        out = _heads_local(
            ctx, lambda *a: _flash_attn(*a, cfg, win, acts), q, k, v,
            (positions, bs), (kv_positions, bs))
    elif impl == "dense":
        out = _heads_local(
            ctx, lambda q, k, v, qp, kp: _dense_attn(
                q, k, v, _mask(qp, kp, cfg, win), cfg.scale, acts),
            q, k, v, (positions, bs), (kv_positions, bs))
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    out = shard_hint(out, ctx, ctx.batch_spec, None, ctx.tp_axis, None)
    y = _out_proj(out, params["wo"], ctx)
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
                     cache: dict, pos: torch.Tensor, acts: ActBundle, *,
                     window: Optional[int] = None,
                     ctx: Optional[ShardCtx] = None
                     ) -> Tuple[torch.Tensor, dict]:
    """One decode step: write the new K/V into its ring slot (in place),
    attend.  x: (B, 1, D); pos: (B,) absolute position of the new token;
    ``window`` overrides ``cfg.window``.  No hint here (the reference's
    decode attention has none); on a mesh the core runs on each rank's
    rows and heads."""
    ctx = ctx or LOCAL
    cache_len = cache["k"].shape[1]
    q = _project_q(params, cfg, x, pos[:, None], ctx)
    k_new, v_new = _project_kv(params, cfg, x, pos[:, None], ctx)
    slot = (pos % cache_len).long()
    for name, new in (("k", k_new[:, 0]), ("v", v_new[:, 0]), ("pos", pos)):
        put_slots(cache[name], slot, new.to(cache[name].dtype))
    win = window if window is not None else cfg.window
    bs = (ctx.batch_spec, None)
    out = _heads_local(
        ctx, lambda q, k, v, qp, kp: _dense_attn(
            q, k, v, _mask(qp, kp, cfg, win), cfg.scale, acts),   # (B, 1, S)
        q, cache["k"], cache["v"], (pos[:, None], bs), (cache["pos"], bs))
    y = _out_proj(out, params["wo"], ctx)
    return y, cache


def put_slots(dst: torch.Tensor, slot: torch.Tensor, val: torch.Tensor
              ) -> None:
    """``dst[b, slot[b]] = val[b]`` for every row ``b`` of a ring cache
    (B, S, ...), in place.  On a DTensor cache each rank writes its own
    rows of its local shard (the ring dim must not be sharded): ``slot``
    and ``val`` are cut as the cache is."""
    if not is_dtensor(dst):
        dst[torch.arange(dst.shape[0], device=dst.device), slot] = val
        return
    from torch.distributed.tensor import Replicate, Shard

    from ..distributed.sharding import local_at
    mesh, pls = dst.device_mesh, dst.placements
    if any(isinstance(p, Shard) and p.dim == 1 for p in pls):
        raise NotImplementedError("put_slots: the cache's ring dim is "
                                  f"sharded ({pls})")
    vpls = [Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard)
            else Replicate() for p in pls]
    spls = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in pls]
    loc = dst.to_local()
    rows = torch.arange(loc.shape[0], device=loc.device)
    loc[rows, local_at(slot, mesh, spls)] = local_at(val, mesh, vpls)


def cross_attention_cached(params: dict, cfg: AttnCfg, x: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           acts: ActBundle, *,
                           enc_valid: Optional[torch.Tensor] = None,
                           ctx: Optional[ShardCtx] = None
                           ) -> torch.Tensor:
    """Cross attention of the decoder's ``x`` (B, T, D) against the
    encoder's K/V (B, S, Hk, Dh) from the cache; every encoder position
    valid unless ``enc_valid`` (B, S) bool says otherwise."""
    ctx = ctx or LOCAL
    q = _project_q(params, cfg, x, None, ctx)

    def core(q, k, v, ev):
        b, t, s = q.shape[0], q.shape[1], k.shape[1]
        if ev is None:
            valid = torch.ones((b, t, s), dtype=torch.bool, device=q.device)
        else:
            valid = ev[:, None, :].expand(b, t, s)
        return _dense_attn(q, k, v, valid, cfg.scale, acts)

    out = _heads_local(ctx, core, q, k, v,
                       (enc_valid, (ctx.batch_spec, None)))
    return _out_proj(out, params["wo"], ctx)


def cross_kv(params: dict, cfg: AttnCfg, enc: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross attention's K/V of the encoder output (B, S, D), once per
    request: what ``attention(x_kv=enc, return_kv=True)`` returns."""
    return _project_kv(params, cfg, enc, None)
