"""Mixture-of-Experts block (moonshot 64e/top-6, kimi-k2 384e/top-8), the
local path.

Counterpart of ``repro/models/moe.py`` with ``ctx.mesh is None``: an exact
float32 router (softmax or sigmoid scores, not the PPA bundle), top-k,
capacity-bounded dispatch into (E, C, d) expert buffers, batched expert
products, and a weighted fill-gather back.  Dispatch uses index arithmetic
only: a token's place in its expert's buffer is a one-hot cumsum over the
top-k slices in slice-major order (the reference's per-slice loop with its
running counts), and a write beyond the capacity lands in an overflow row
that is sliced away.  Nothing waits on the host.  ``MoECfg.mode`` selects
the sharded path's collectives, which one device does not run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .activations import ActBundle
from .common import P
from .mlp import gated_mlp, gated_mlp_params

__all__ = ["MoECfg", "moe_params", "moe_block"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int                      # per-expert hidden
    n_experts: int
    top_k: int
    router_score: str = "softmax"  # softmax | sigmoid (deepseek/kimi style)
    capacity_factor: float = 1.25
    gate: str = "silu"
    n_shared: int = 0              # shared (always-on) experts
    aux_coef: float = 0.01
    mode: str = "weight_gather"    # weight_gather | token_gather


def moe_params(cfg: MoECfg, layers: Optional[int] = None) -> dict:
    def lp(shape, axes, **kw):
        if layers is None:
            return P(shape, axes, **kw)
        return P((layers,) + shape, ("layers",) + axes, **kw)

    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    out = {
        "router": lp((d, e), (None, None)),
        "w_gate": lp((e, d, f), ("expert", "expert_embed", "expert_mlp")),
        "w_up": lp((e, d, f), ("expert", "expert_embed", "expert_mlp")),
        "w_down": lp((e, f, d), ("expert", "expert_mlp", "expert_embed")),
    }
    if cfg.n_shared:
        out["shared"] = gated_mlp_params(d, f * cfg.n_shared, layers)
    return out


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot of ``ids`` over ``n`` classes, in a new last axis."""
    classes = torch.arange(n, dtype=ids.dtype, device=ids.device)
    return (ids[..., None] == classes).to(torch.int32)


def _route(x2: torch.Tensor, router: torch.Tensor, cfg: MoECfg
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, d) -> top-k ids (S, k) int32, weights (S, k) in x2's dtype, the
    switch-style load-balance loss (float32 scalar).  Ties in the scores
    go to the lower expert index, as ``jax.lax.top_k``'s."""
    logits = x2.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    scores = torch.sigmoid(logits) if cfg.router_score == "sigmoid" else probs
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :cfg.top_k], ids[:, :cfg.top_k]
    wts = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)

    e = cfg.n_experts
    assign = _one_hot(ids, e).sum(1).to(torch.float32)            # (S, e)
    f_e = assign.mean(0) / cfg.top_k
    p_e = probs.mean(0)
    aux = cfg.aux_coef * e * torch.sum(f_e * p_e)
    return ids.to(torch.int32), wts.to(x2.dtype), aux


def _positions(ids_loc: torch.Tensor, e_loc: int) -> torch.Tensor:
    """(k * S,) int32 place of each (slice, token) assignment in its
    expert's buffer, slice-major: the reference's running count before
    slice j plus the token's rank among slice j's tokens of that expert.
    ``ids_loc`` == e_loc (remote or invalid) counts in a buffer of its
    own."""
    le = ids_loc.t().reshape(-1).long()                       # (k * S,)
    within = torch.cumsum(_one_hot(le, e_loc + 1), dim=0) - 1
    return within.gather(1, le[:, None])[:, 0].to(torch.int32)


def _dispatch_compute(x2, ids_loc, wts, wg, wu, wd, e_loc: int, cap: int,
                      acts: ActBundle, gate: str) -> torch.Tensor:
    """Scatter tokens into the (e_loc, cap, d) expert buffers, run the
    experts, combine.  ``ids_loc`` in [0, e_loc) for local assignments,
    == e_loc for remote or invalid ones; assignments at or beyond ``cap``
    in their buffer are dropped, as are the remote ones."""
    s, d = x2.shape
    k = ids_loc.shape[1]
    le = ids_loc.t().reshape(-1).long()
    pos = _positions(ids_loc, e_loc).long()
    keep = (le < e_loc) & (pos < cap)
    flat = torch.where(keep, le * cap + pos, e_loc * cap)     # overflow row
    buf = torch.zeros((e_loc * cap + 1, d), dtype=x2.dtype, device=x2.device)
    buf.index_put_((flat,), x2.repeat(k, 1))
    buf = buf[:-1].view(e_loc, cap, d)

    h = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    y_e = torch.bmm(acts.gate(gate)(h) * u, wd).view(e_loc * cap, d)

    g = torch.where(keep[:, None], y_e[flat.clamp(max=e_loc * cap - 1)],
                    0.0).view(k, s, d)
    return (wts.t()[:, :, None] * g).sum(0)


def _capacity(tokens: int, cfg: MoECfg) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def moe_block(params: dict, x: torch.Tensor, cfg: MoECfg, acts: ActBundle
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, D) -> (B, T, D), aux-loss scalar.  With a PPA bundle on the
    card the experts' gate is the gated fused kernel on the (E, C, f)
    buffer."""
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    ids, wts, aux = _route(x2, params["router"], cfg)
    y = _dispatch_compute(x2, ids, wts, params["w_gate"], params["w_up"],
                          params["w_down"], cfg.n_experts,
                          _capacity(b * t, cfg), acts, cfg.gate)
    y = y.reshape(b, t, d)
    if cfg.n_shared:
        y = y + gated_mlp(params["shared"], x, acts, cfg.gate)
    return y, aux
