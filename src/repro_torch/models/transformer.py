"""Model assembly for ``dec`` stages (dense or MoE decoder blocks):
parameter specs, prefill, decode and the training loss.

Counterpart of the ``dec`` path of ``repro/models/transformer.py``: each
block is self-attention (QKV bias, qk-norm, a sliding window and dense or
flash attention as the config says) plus a gated MLP, or an MoE on a
``moe`` stage.  The reference scans a stacked layer axis under
``jax.lax.scan``; here :func:`prepare_params` casts the parameters to
``compute_dtype`` once and splits the stack into per-layer views, which a
Python loop walks.  The decode cache keeps the reference's stacked layout
(L, B, S, Hk, D) per stage, S the stage's ring (its window when that is
shorter than the cache), and is updated in place.

:func:`loss_fn` casts the (float32 master) parameters inside the autograd
graph, as the reference's ``_cast_params``, and splits each stacked leaf
with ``unbind``, whose backward stacks the layers' gradients once: the
gradients land on the stacked float32 leaves.  Its aux is the sum over
layers of the MoE load-balance loss.  ``cfg.remat`` recomputes each layer
in the backward: ``"full"`` all of it, ``"dots"`` all but the outputs of
its matrix products without batch dimensions (the reference's
``checkpoint_dots_with_no_batch_dims``: the experts' batched products are
recomputed), ``"none"`` nothing.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from .activations import ActBundle
from .attention import (AttnCfg, attn_params, attention, decode_attention,
                        init_kv_cache)
from .common import P, map_tree
from .config import ModelCfg, StageCfg
from .layers import (cross_entropy_chunked, embed_lookup, lm_head_logits,
                     rmsnorm, rmsnorm_params)
from .mlp import gated_mlp, gated_mlp_params
from .moe import MoECfg, moe_block, moe_params

__all__ = ["param_specs", "prepare_params", "forward_hidden", "init_cache",
           "prefill", "decode_step", "loss_fn", "ring_len"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_dec(cfg: ModelCfg) -> None:
    """Refuse what the port does not run yet: the hybrid SSM, RWKV and
    encoder-decoder stages, the vision prefix and layernorm."""
    for st in cfg.stages:
        if st.kind != "dec":
            raise NotImplementedError(
                f"{cfg.arch}: only 'dec' stages are ported (got {st.kind})")
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"{cfg.arch}: only rmsnorm is ported")
    if cfg.vision_tokens or cfg.enc_layers:
        raise NotImplementedError(f"{cfg.arch}: no vision/encoder port yet")


def _attn_cfg(cfg: ModelCfg, stage: StageCfg) -> AttnCfg:
    return AttnCfg(
        d_model=cfg.d_model, n_q=cfg.n_q, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, window=stage.window,
        flash_chunk=cfg.flash_chunk)


def _moe_cfg(cfg: ModelCfg) -> MoECfg:
    return MoECfg(
        d_model=cfg.d_model, d_ff=cfg.moe_dff, n_experts=cfg.moe_experts,
        top_k=cfg.moe_topk, router_score=cfg.router_score,
        capacity_factor=cfg.capacity_factor, gate=cfg.gate,
        n_shared=cfg.moe_shared, mode=cfg.moe_mode)


def _stage_key(i: int, st: StageCfg) -> str:
    return f"s{i}_{st.kind}"


def ring_len(st: StageCfg, cache_len: int) -> int:
    """A stage's decode ring: the cache, or its window when shorter."""
    return cache_len if st.window is None else min(st.window, cache_len)


def _stage_specs(cfg: ModelCfg, st: StageCfg) -> dict:
    l = st.n_layers
    out = {"ln1": rmsnorm_params(cfg.d_model, l),
           "attn": attn_params(_attn_cfg(cfg, st), l),
           "ln2": rmsnorm_params(cfg.d_model, l)}
    if st.moe:
        out["moe"] = moe_params(_moe_cfg(cfg), l)
    else:
        out["mlp"] = gated_mlp_params(cfg.d_model, cfg.d_ff, l)
    return out


def param_specs(cfg: ModelCfg) -> dict:
    _check_dec(cfg)
    out: Dict[str, Any] = {
        "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "ln_f": rmsnorm_params(cfg.d_model),
        "stages": {_stage_key(i, st): _stage_specs(cfg, st)
                   for i, st in enumerate(cfg.stages)},
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           scale=0.02)
    return out


def prepare_params(params: dict, cfg: ModelCfg, device=None) -> dict:
    """Cast floating parameters to ``compute_dtype`` (once), move them to
    ``device`` (None: where they are) and split every stage's stacked layer
    axis into a list of per-layer dicts (views)."""
    _check_dec(cfg)
    dt = dtype_of(cfg.compute_dtype)
    cast = map_tree(
        lambda t: t.to(device=device,
                       dtype=dt if t.is_floating_point() else t.dtype),
        params)
    stages = {}
    for i, st in enumerate(cfg.stages):
        key = _stage_key(i, st)
        stages[key] = [map_tree(lambda t, j=j: t[j], cast["stages"][key])
                       for j in range(st.n_layers)]
    out = {k: v for k, v in cast.items() if k != "stages"}
    out["stages"] = stages
    return out


def _head(params: dict) -> torch.Tensor:
    return params.get("lm_head", params["embed"])


def forward_hidden(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                   acts: ActBundle) -> torch.Tensor:
    """Final hidden (B, T, D) of a full sequence (prepared params)."""
    h, _ = _prefill_hidden(params, cfg, tokens, acts, None, None)
    return h


def _ffn(cfg: ModelCfg, st: StageCfg, p: dict, x: torch.Tensor,
         acts: ActBundle):
    """The block's second half: (y, MoE aux loss or None)."""
    if st.moe:
        return moe_block(p["moe"], x, _moe_cfg(cfg), acts)
    return gated_mlp(p["mlp"], x, acts, gate=cfg.gate), None


def _layer(cfg, st, acts, positions, h, p):
    """One ``dec`` block on a full sequence: (h, (k, v), aux or None)."""
    a, kv = attention(p["attn"], _attn_cfg(cfg, st), rmsnorm(h, p["ln1"]),
                      acts, positions=positions, impl=cfg.attn_impl,
                      return_kv=True)
    h = h + a
    y, aux = _ffn(cfg, st, p, rmsnorm(h, p["ln2"]), acts)
    return h + y, kv, aux


def _prefill_hidden(params, cfg, tokens, acts, cache_len, cache_dtype):
    h = embed_lookup(params["embed"], tokens)
    b, t, _ = h.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=h.device).expand(b, t)
    cache = {}
    for i, st in enumerate(cfg.stages):
        key = _stage_key(i, st)
        packed = []
        for p in params["stages"][key]:
            h, (k, v), _ = _layer(cfg, st, acts, positions, h, p)
            if cache_len is not None:
                packed.append(_pack_ring(k, v, positions,
                                         ring_len(st, cache_len), cache_dtype))
        if cache_len is not None:
            cache[key] = {"kv": {n: torch.stack([c[n] for c in packed])
                                 for n in ("k", "v", "pos")}}
    return rmsnorm(h, params["ln_f"]), cache


def init_cache(cfg: ModelCfg, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Empty decode cache: per stage {"kv": {"k", "v": (L, B, S, Hk, D),
    "pos": (L, B, S) = -1}}, S the stage's ring (``ring_len``)."""
    _check_dec(cfg)
    device = resolve_device(device)
    out = {}
    for i, st in enumerate(cfg.stages):
        one = init_kv_cache(batch, ring_len(st, cache_len), _attn_cfg(cfg, st),
                            dtype, device)
        out[_stage_key(i, st)] = {"kv": {
            n: t.unsqueeze(0).repeat((st.n_layers,) + (1,) * t.dim())
            for n, t in one.items()}}
    return out


def _pack_ring(k, v, positions, eff: int, dtype) -> dict:
    """Pack full-prompt K/V (B, T, Hk, Dh) into a ring cache of length eff,
    keeping the last ``eff`` positions at slots pos % eff."""
    b, t = k.shape[:2]
    keep = min(t, eff)
    kk, vv = k[:, -keep:], v[:, -keep:]
    pp = positions[:, -keep:]
    slots = (pp[0] % eff).long()            # identical across batch
    kc = torch.zeros((b, eff) + tuple(k.shape[2:]), dtype=dtype,
                     device=k.device)
    vc = torch.zeros((b, eff) + tuple(v.shape[2:]), dtype=dtype,
                     device=v.device)
    pc = torch.full((b, eff), -1, dtype=torch.int32, device=k.device)
    kc[:, slots] = kk.to(dtype)
    vc[:, slots] = vv.to(dtype)
    pc[:, slots] = pp.to(torch.int32)
    return {"k": kc, "v": vc, "pos": pc}


def prefill(params: dict, cfg: ModelCfg, batch: dict, cache_len: int,
            acts: ActBundle, cache_dtype=torch.bfloat16,
            last_idx: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Run the full prompt once (prepared params); return (last-token
    logits, decode cache).  ``last_idx`` (B,) picks each row's last real
    position when prompts are right-padded to a shared length."""
    h, cache = _prefill_hidden(params, cfg, batch["tokens"], acts,
                               cache_len, cache_dtype)
    if last_idx is None:
        last = h[:, -1]
    else:
        last = h[torch.arange(h.shape[0], device=h.device), last_idx.long()]
    return lm_head_logits(last, _head(params)), cache


def decode_step(params: dict, cfg: ModelCfg, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor, acts: ActBundle
                ) -> Tuple[torch.Tensor, dict]:
    """One token for every sequence: tokens (B, 1), pos (B,) -> logits
    (B, V); the cache is updated in place and returned."""
    h = embed_lookup(params["embed"], tokens)
    for i, st in enumerate(cfg.stages):
        key = _stage_key(i, st)
        acfg = _attn_cfg(cfg, st)
        kv = cache[key]["kv"]
        for j, p in enumerate(params["stages"][key]):
            layer_kv = {n: kv[n][j] for n in ("k", "v", "pos")}
            a, _ = decode_attention(p["attn"], acfg, rmsnorm(h, p["ln1"]),
                                    layer_kv, pos, acts)
            h = h + a
            h = h + _ffn(cfg, st, p, rmsnorm(h, p["ln2"]), acts)[0]
    h = rmsnorm(h, params["ln_f"])
    return lm_head_logits(h, _head(params))[:, 0], cache


# ---------------------------------------------------------------- training
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, func, *args, **kwargs):
    """Save the outputs of matrix products without batch dimensions (a
    batched product of one matrix is one); recompute everything else."""
    if func in _DOTS or (func is torch.ops.aten.bmm.default
                         and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"unknown remat {remat!r}")


def _train_layer(cfg, st, acts, positions, h, p):
    h, _, aux = _layer(cfg, st, acts, positions, h, p)
    return h, aux


def _unstack(tree: dict, n: int) -> list:
    """Per-layer dicts of a stacked tree, through ``unbind``."""
    parts = map_tree(lambda t: t.unbind(0), tree)
    return [map_tree(lambda u, j=j: u[j], parts) for j in range(n)]


def loss_fn(params: dict, cfg: ModelCfg, batch: dict, acts: ActBundle
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"
    (B, T) int, optional "loss_mask"}) under the raw (float32 master)
    ``params``: (loss, {"nll", "aux", "denom"}), differentiable in the
    params."""
    _check_dec(cfg)
    dt = dtype_of(cfg.compute_dtype)
    p = map_tree(lambda t: t.to(dt) if t.is_floating_point() else t, params)
    h = embed_lookup(p["embed"], batch["tokens"])
    b, t, _ = h.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=h.device).expand(b, t)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, st in enumerate(cfg.stages):
        layer = _remat(functools.partial(_train_layer, cfg, st, acts,
                                         positions), cfg.remat)
        for lp in _unstack(p["stages"][_stage_key(i, st)], st.n_layers):
            h, a = layer(h, lp)
            if a is not None:
                aux = aux + a
    h = rmsnorm(h, p["ln_f"])
    nll, denom = cross_entropy_chunked(h, _head(p), batch["labels"],
                                       mask=batch.get("loss_mask"),
                                       num_chunks=cfg.ce_chunks)
    return nll + aux, {"nll": nll, "aux": aux, "denom": denom}
