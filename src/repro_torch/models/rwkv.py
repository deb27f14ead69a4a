"""RWKV6 (Finch) blocks: time-mix with data-dependent decay, channel-mix.

Counterpart of ``repro/models/rwkv.py``.  Per head (head dim D), state
S in R^{DxD}:

    out_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
    S_t   = diag(w_t) S_{t-1} + k_t^T v_t
    w_t   = exp(-exp(ww_t)),   ww_t = w0 + tanh(x_w @ A) @ B   (LoRA)

Both exponentials go through the ActBundle (two chained ``exp_decay``
tables with a PPA bundle), as do the tanh, the silu gate and the
channel-mix sigmoid; relu^2 is polynomial.  Prefill and training run the
sequence in chunks with an associative scan on the (B, Tc, H, Dk, Dv)
affine-state elements inside each (JAX's recursion order), each chunk
recomputed in the backward under autograd; decode is the one-step
recurrence on (B, H, Dk, Dv).  As in the reference, the token-shift mixing
coefficients are static per channel; only the decay is data-dependent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve_device
from .activations import ActBundle
from .common import LOCAL, P, ShardCtx, shard_hint
from .layers import rmsnorm
from .scan import associative_scan
from .ssm import _cat_promoted, _combine, chunked

__all__ = ["RWKVCfg", "rwkv_time_params", "rwkv_channel_params",
           "rwkv_time_mix", "rwkv_channel_mix", "init_rwkv_state",
           "time_core", "time_step"]


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    d_model: int
    n_heads: int
    head_dim: int = 64
    decay_lora: int = 64
    d_ff: int = 0         # channel-mix hidden
    chunk: int = 64

    @property
    def d_attn(self) -> int:
        return self.n_heads * self.head_dim


def _lp(layers, shape, axes, **kw):
    if layers is None:
        return P(shape, axes, **kw)
    return P((layers,) + shape, ("layers",) + axes, **kw)


def rwkv_time_params(cfg: RWKVCfg, layers: Optional[int] = None) -> dict:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "mu": _lp(layers, (5, d), (None, "embed"), scale=0.5),  # r,k,v,w,g
        "w_r": _lp(layers, (d, h, dh), ("embed", "q_heads", "head")),
        "w_k": _lp(layers, (d, h, dh), ("embed", "q_heads", "head")),
        "w_v": _lp(layers, (d, h, dh), ("embed", "q_heads", "head")),
        "w_g": _lp(layers, (d, h, dh), ("embed", "q_heads", "head")),
        "w0": _lp(layers, (h, dh), ("q_heads", "head"), init="zeros"),
        "w_lora_a": _lp(layers, (d, cfg.decay_lora), ("embed", None)),
        "w_lora_b": _lp(layers, (cfg.decay_lora, h, dh),
                        (None, "q_heads", "head"), scale=0.01),
        # nonzero: with u = 0 the t=0 row into the group norm is exactly
        # zero and 1/rms(0) explodes the backward pass
        "u_bonus": _lp(layers, (h, dh), ("q_heads", "head"), scale=0.5),
        "ln_x": {"scale": _lp(layers, (h, dh), ("q_heads", "head"),
                              init="ones")},
        "w_o": _lp(layers, (h, dh, d), ("q_heads", "head", "embed")),
    }


def rwkv_channel_params(cfg: RWKVCfg, layers: Optional[int] = None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": _lp(layers, (2, d), (None, "embed"), scale=0.5),   # k, r
        "w_k": _lp(layers, (d, f), ("embed", "mlp")),
        "w_v": _lp(layers, (f, d), ("mlp", "embed")),
        "w_r": _lp(layers, (d, d), ("embed", None)),
    }


def _shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or the carried ``last``, for t=0)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return _cat_promoted([last, x[:, :-1]], 1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu


def time_core(params, cfg: RWKVCfg, x, x_last, s0, acts: ActBundle):
    """One chunk of time-mix (or one decode step).  x: (B, T, D); x_last:
    (B, 1, D) the token before it; s0: (B, H, Dk, Dv) float32 carry.
    Returns (y, x[:, -1:], S after the chunk)."""
    b, t, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    xs = _shift(x, x_last)
    mu = params["mu"]
    xr, xk, xv, xw, xg = (_lerp(x, xs, mu[i]) for i in range(5))

    r = torch.einsum("btd,dhe->bthe", xr, params["w_r"])
    k = torch.einsum("btd,dhe->bthe", xk, params["w_k"])
    v = torch.einsum("btd,dhe->bthe", xv, params["w_v"])
    g = torch.einsum("btd,dhe->bthe", xg, params["w_g"])

    ww = params["w0"] + torch.einsum(
        "btr,rhe->bthe", acts.tanh(torch.einsum(
            "btd,dr->btr", xw, params["w_lora_a"])), params["w_lora_b"])
    # w = exp(-exp(ww)) through two chained exp tables
    e_ww = acts.exp_decay(-ww.to(torch.float32))          # e^{ww}
    decay = acts.exp_decay(e_ww)                          # in (0, 1)

    kv = (k.to(torch.float32)[..., :, None]
          * v.to(torch.float32)[..., None, :])            # (B,T,H,Dk,Dv)
    a = decay[..., :, None]                               # (B,T,H,Dk,1)

    aa, ss = associative_scan(_combine, (a, kv), axis=1)
    ss = ss + aa * s0[:, None]                            # S_t (inclusive)
    s_prev = torch.cat([s0[:, None], ss[:, :-1]], dim=1)  # S_{t-1}
    out = torch.einsum("bthk,bthkv->bthv", r.to(torch.float32),
                       s_prev + params["u_bonus"].to(torch.float32)[..., None]
                       * kv)
    # per-head group norm, then the output gate
    out = rmsnorm(out.reshape(b, t, h, dh), {"scale": params["ln_x"]["scale"]})
    out = out.to(x.dtype) * acts.silu(g)
    y = torch.einsum("bthe,hed->btd", out, params["w_o"])
    return y, x[:, -1:], ss[:, -1]


def rwkv_time_mix(params: dict, cfg: RWKVCfg, x: torch.Tensor,
                  acts: ActBundle, return_state: bool = False,
                  ctx: Optional[ShardCtx] = None):
    """Full-sequence time-mix; with ``return_state`` also the final carry
    (x[:, -1:], S)."""
    b, _, d = x.shape

    def run(p, c, x, x_last, s):
        def step(xi, x_last, s):
            return time_core(p, c, xi, x_last, s, acts)
        y, (x_last, s) = chunked(step, x, c.chunk, (x_last, s))
        return y, x_last, s

    x_last0 = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    s0 = torch.zeros((b, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                     dtype=torch.float32, device=x.device)
    y, x_last, s = _heads(run, params, cfg, x, x_last0, s0, ctx or LOCAL)
    if return_state:
        return y, (x_last, s)
    return y


def time_step(params, cfg: RWKVCfg, x, x_last, s0, acts: ActBundle,
              ctx: Optional[ShardCtx] = None):
    """:func:`time_core` of one decode step; on a mesh on each rank's
    rows and heads."""
    def run(p, c, x, x_last, s):
        return time_core(p, c, x, x_last, s, acts)
    return _heads(run, params, cfg, x, x_last, s0, ctx or LOCAL)


#: the time mix's parameters' specs on a mesh ("tp": the model axis)
_HEAD_SPECS = {"mu": (None, None), "w_r": (None, "tp", None),
               "w_k": (None, "tp", None), "w_v": (None, "tp", None),
               "w_g": (None, "tp", None), "w0": ("tp", None),
               "w_lora_a": (None, None), "w_lora_b": (None, "tp", None),
               "u_bonus": ("tp", None), "ln_x": ("tp", None),
               "w_o": ("tp", None, None)}


def _heads(run, params, cfg: RWKVCfg, x, x_last, s, ctx: ShardCtx):
    """``run(params, cfg, x, x_last, s) -> (y, x_last, s)``; on a mesh on
    each rank's batch rows and heads (as ``shard_map`` would run it: the
    recurrence is per head), ``y`` a pending sum over "model" (the output
    projection's rows are split over it)."""
    if ctx.mesh is None:
        return run(params, cfg, x, x_last, s)
    from ..distributed.collectives import axis_size
    from ..distributed.sharding import local_call
    mesh, bs, tp = ctx.mesh, ctx.batch_spec, ctx.tp_axis
    lcfg = dataclasses.replace(cfg, n_heads=cfg.n_heads
                               // axis_size(mesh, tp))
    names = sorted(_HEAD_SPECS)

    def fn(x, x_last, s, *ps):
        p = dict(zip(names, ps))
        p["ln_x"] = {"scale": p["ln_x"]}
        return run(p, lcfg, x, x_last, s)

    ins = [(x, (bs, None, None)), (x_last, (bs, None, None)),
           (s, (bs, tp, None, None))]
    ins += [(params["ln_x"]["scale"] if k == "ln_x" else params[k],
             tuple(tp if a == "tp" else a for a in _HEAD_SPECS[k]))
            for k in names]
    return local_call(
        mesh, fn, ins, [(bs, None, None), (bs, None, None),
                        (bs, tp, None, None)],
        shape=[tuple(x.shape), tuple(x_last.shape), tuple(s.shape)],
        partial=[(tp,), (), ()])


def rwkv_channel_mix(params: dict, cfg: RWKVCfg, x: torch.Tensor,
                     acts: ActBundle, x_last: Optional[torch.Tensor] = None,
                     ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    ctx = ctx or LOCAL
    xs = _shift(x, x_last)
    mu = params["mu"]
    xk, xr = _lerp(x, xs, mu[0]), _lerp(x, xs, mu[1])
    k = torch.einsum("btd,df->btf", xk, params["w_k"])
    k = torch.square(torch.relu(k))                     # relu^2: polynomial
    k = shard_hint(k, ctx, ctx.batch_spec, None, ctx.tp_axis)
    kv = torch.einsum("btf,fd->btd", k, params["w_v"])
    return acts.sigmoid(torch.einsum("btd,de->bte", xr, params["w_r"])) * kv


def init_rwkv_state(batch: int, cfg: RWKVCfg, d_model: int,
                    dtype=torch.bfloat16, device=None) -> dict:
    device = resolve_device(device)
    return {
        "tm_last": torch.zeros((batch, 1, d_model), dtype=dtype,
                               device=device),
        "cm_last": torch.zeros((batch, 1, d_model), dtype=dtype,
                               device=device),
        "s": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                         dtype=torch.float32, device=device),
    }
