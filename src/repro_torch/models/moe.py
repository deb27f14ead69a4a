"""Mixture-of-Experts block (moonshot 64e/top-6, kimi-k2 384e/top-8).

Counterpart of ``repro/models/moe.py``: an exact float32 router (softmax
or sigmoid scores, not the PPA bundle), top-k, capacity-bounded dispatch
into (E, C, d) expert buffers, batched expert products, and a weighted
fill-gather back.  Dispatch uses index arithmetic only: a token's place in
its expert's buffer is a one-hot cumsum over the top-k slices in
slice-major order (the reference's per-slice loop with its running
counts), and a write beyond the capacity lands in an overflow row that is
sliced away.  Nothing waits on the host.

Distribution (``ctx.mesh``, a ``DeviceMesh``; the reference's
``shard_map``, manual over every mesh axis), on every rank of the mesh:

  mode="weight_gather" (train / prefill — token-heavy):
    experts sharded over "model"; expert weights additionally FSDP-sharded
    over the dp axes on d and all-gathered per layer; tokens stay in their
    data shard; outputs all-reduced over "model".

  mode="token_gather" (decode — weight-heavy):
    expert weights stay fully sharded (E over "model", f over the dp
    axes); the token batch is all-gathered over dp, every rank computes
    its (E_loc, f_loc) partial, and one sum over all axes rebuilds the
    outputs: no weight moves.

The block takes global tensors, as the reference's: ``x`` a DTensor
from the tensor-parallel dense layers (or a plain tensor, the same on
every rank), the expert weights either global plain tensors or DTensors
holding each rank's shard (:func:`shard_experts`).  Each rank runs
:func:`_moe_body` on its shard and batch rows, as shard_map's in_specs
cut them; a DTensor ``x`` gets its result back at shard_map's out_specs,
a plain one the rows gathered back over dp.  With
``ctx.mesh`` None the same dispatch core runs locally (E_loc = E, no
collectives); on a mesh of one rank every collective is the identity and
the output equals the local path's exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .activations import ActBundle
from .common import P, ShardCtx
from .mlp import gated_mlp, gated_mlp_params

__all__ = ["MoECfg", "moe_params", "moe_block", "expert_specs",
           "shard_experts"]


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


def moe_block(params: dict, x: torch.Tensor, cfg: MoECfg, acts: ActBundle,
              ctx: Optional[ShardCtx] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, D) -> (B, T, D), aux-loss scalar.  With a PPA bundle on the
    card the experts' gate is the gated fused kernel on the (E, C, f)
    buffer."""
    b, t, d = x.shape
    if ctx is None or ctx.mesh is None:
        x2 = x.reshape(b * t, d)
        ids, wts, aux = _route(x2, params["router"], cfg)
        y = _dispatch_compute(x2, ids, wts, params["w_gate"],
                              params["w_up"], params["w_down"],
                              cfg.n_experts, _capacity(b * t, cfg), acts,
                              cfg.gate)
        y = y.reshape(b, t, d)
    else:
        y, aux = _moe_sharded(params, x, cfg, acts, ctx)
    if cfg.n_shared:
        y = y + gated_mlp(params["shared"], x, acts, cfg.gate, ctx)
    return y, aux


# ------------------------------------------------------------- the mesh
def _mesh_axes(ctx: ShardCtx):
    names = ctx.mesh.mesh_dim_names
    dp = tuple(a for a in ctx.dp_axes if a in names)
    return dp, ctx.tp_axis


def expert_specs(mode: str, dp: Tuple[str, ...], tp: str):
    """(w_gate / w_up spec, w_down spec) of ``mode``, as tuples of mesh
    axes a dim (the reference's ``_moe_sharded`` specs)."""
    dp = dp or None
    if mode == "weight_gather":
        return (tp, dp, None), (tp, None, dp)   # d -> fsdp
    return (tp, None, dp), (tp, dp, None)       # f -> fsdp (stationary)


def shard_experts(params: dict, cfg: MoECfg, ctx: ShardCtx) -> dict:
    """One layer's MoE params with the expert weights as DTensors on
    ``ctx.mesh`` at ``cfg.mode``'s specs: each rank keeps its own shard
    (taken without communication from the global tensors, which every
    rank holds)."""
    from ..distributed.sharding import to_dtensor
    dp, tp = _mesh_axes(ctx)
    wspec, dspec = expert_specs(cfg.mode, dp, tp)
    out = dict(params)
    for k, spec in (("w_gate", wspec), ("w_up", wspec), ("w_down", dspec)):
        out[k] = to_dtensor(params[k], ctx.mesh, spec)
    return out


def _moe_sharded(params, x, cfg: MoECfg, acts, ctx: ShardCtx):
    from torch.distributed.tensor import DTensor

    from ..distributed.collectives import all_gather
    from ..distributed.sharding import local_shard, wrap_local
    mesh = ctx.mesh
    dp, tp = _mesh_axes(ctx)
    bspec = dp if (ctx.batch_sharded and dp) else None
    e_loc = cfg.n_experts // mesh.size(mesh.mesh_dim_names.index(tp))
    wspec, dspec = expert_specs(cfg.mode, dp, tp)
    wg = local_shard(params["w_gate"], mesh, wspec)
    wu = local_shard(params["w_up"], mesh, wspec)
    wd = local_shard(params["w_down"], mesh, dspec)
    router = local_shard(params["router"], mesh, (None, None))
    # the rank's batch rows, as shard_map's in_specs cut them
    x_loc = local_shard(x, mesh, (bspec, None, None))
    y, aux = _moe_body(router, wg, wu, wd, x_loc, cfg=cfg,
                       acts=acts, e_loc=e_loc, dp=dp, tp=tp,
                       batch_sharded=bool(bspec), mesh=mesh)
    if isinstance(x, DTensor):
        # a DTensor activation: the result at shard_map's out_specs
        return (wrap_local(y, mesh, (bspec, None, None), x.shape),
                wrap_local(aux, mesh, (), ()))
    # a plain (replicated) activation: the global result, as shard_map's
    # out_specs assemble it
    if bspec:
        y = all_gather(y, mesh, dp, dim=0)
    return y, aux


def _moe_body(router, wg, wu, wd, x, *, cfg: MoECfg, acts, e_loc, dp, tp,
              batch_sharded, mesh):
    from ..distributed.collectives import (all_gather, all_reduce,
                                           axis_index, axis_size)
    b, t, d = x.shape
    e0 = axis_index(mesh, tp) * e_loc

    if cfg.mode == "weight_gather":
        # FSDP gather of this layer's local experts over the dp axes
        if dp:
            wg = all_gather(wg, mesh, dp, dim=1)
            wu = all_gather(wu, mesh, dp, dim=1)
            wd = all_gather(wd, mesh, dp, dim=2)
        x2 = x.reshape(b * t, d)
        ids, wts, aux = _route(x2, router, cfg)
        ids_loc = torch.where((ids >= e0) & (ids < e0 + e_loc),
                              ids - e0, e_loc)
        cap = _capacity(b * t, cfg)
        y = _dispatch_compute(x2, ids_loc, wts, wg, wu, wd, e_loc, cap,
                              acts, cfg.gate)
        y = all_reduce(y, mesh, tp)
        if dp:
            aux = all_reduce(aux, mesh, dp) / axis_size(mesh, dp)
        return y.reshape(b, t, d), aux

    # token_gather: weights stationary (f sharded over dp), tokens gathered
    xg = all_gather(x, mesh, dp, dim=0) if (dp and batch_sharded) else x
    bg = xg.shape[0]
    x2 = xg.reshape(bg * t, d)
    ids, wts, aux = _route(x2, router, cfg)
    ids_loc = torch.where((ids >= e0) & (ids < e0 + e_loc), ids - e0, e_loc)
    cap = _capacity(bg * t, cfg)
    y = _dispatch_compute(x2, ids_loc, wts, wg, wu, wd, e_loc, cap,
                          acts, cfg.gate)
    y = all_reduce(y, mesh, (tp,) + tuple(dp))   # full (Bg*T, d) everywhere
    y = y.reshape(bg, t, d)
    if dp and batch_sharded:
        row = axis_index(mesh, dp)
        y = y[row * b:(row + 1) * b]
    return y, aux
