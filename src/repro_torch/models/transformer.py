"""Model assembly: parameter specs, prefill, decode and the training loss
for ``dec`` stages (dense or MoE decoder blocks), ``hyb`` stages (hymba:
attention and a selective SSM in parallel, then a gated MLP), ``rwkv``
stages (RWKV6 time-mix and channel-mix, attention-free) and the
encoder-decoder kinds (whisper): ``enc`` (bidirectional attention and a
plain MLP, the encoder's stack) and ``xdec`` (self-attention, cross
attention to the encoder's output, a plain MLP).

Counterpart of ``repro/models/transformer.py``.  A ``dec`` block is
self-attention (QKV bias, qk-norm, a sliding window and dense or flash
attention as the config says) plus a gated MLP, or an MoE on a ``moe``
stage; a ``hyb`` block adds half the attention and half the SSM mixer to
the residual.  The norm is RMSNorm or LayerNorm as ``cfg.norm`` says.  The
modality frontends are stubs, as in the reference: whisper's encoder takes
precomputed frame embeddings (``batch["enc_feats"]``, standardised per
frame), internvl's decoder precomputed patch embeddings
(``batch["vision_embeds"]``) put before the token embeddings.

The reference scans a stacked layer axis under ``jax.lax.scan``; here
:func:`prepare_params` casts the parameters to ``compute_dtype`` once and
splits the stack into per-layer views, which a Python loop walks.  The
decode cache keeps the reference's stacked layout per stage: ``kv`` {"k",
"v": (L, B, S, Hk, D), "pos"}, S the stage's ring (its window when that
is shorter than the cache), on ``dec`` and ``hyb`` stages; ``ssm``
{"conv": (L, B, K-1, di), "h": (L, B, di, N) float32} on ``hyb``;
``rwkv`` {"tm_last", "cm_last": (L, B, 1, D), "s": (L, B, H, D, D)
float32} on ``rwkv``; ``xk``, ``xv`` (L, B, enc_seq, Hk, D), the
encoder's cross-attention K/V, on ``xdec``.  Decode updates it in place.

:func:`loss_fn` casts the (float32 master) parameters inside the autograd
graph, as the reference's ``_cast_params``, and splits each stacked leaf
with ``unbind``, whose backward stacks the layers' gradients once: the
gradients land on the stacked float32 leaves.  Its aux is the sum over
layers of the MoE load-balance loss.  ``cfg.remat`` recomputes each layer
(the encoder's too) in the backward: ``"full"`` all of it, ``"dots"`` all
but the outputs of its matrix products without batch dimensions (the
reference's ``checkpoint_dots_with_no_batch_dims``: the experts' batched
products are recomputed), ``"none"`` nothing.  The recurrent mixers also
recompute each of their chunks, as the reference's ``jax.checkpoint``
does.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..kernels.local import is_dtensor
from ..tree import map_trees
from .activations import ActBundle
from .attention import (AttnCfg, attn_params, attention,
                        cross_attention_cached, decode_attention,
                        init_kv_cache)
from .common import LOCAL, P, ShardCtx, map_tree, on_mesh, shard_hint
from .config import ModelCfg, StageCfg
from .layers import (cross_entropy_chunked, embed_lookup, layernorm,
                     layernorm_params, lm_head_logits, mean_last, rmsnorm,
                     rmsnorm_params)
from .mlp import gated_mlp, gated_mlp_params, mlp, mlp_params
from .moe import MoECfg, moe_block, moe_params
from .rwkv import (RWKVCfg, init_rwkv_state, rwkv_channel_mix,
                   rwkv_channel_params, rwkv_time_mix, rwkv_time_params,
                   time_step)
from .ssm import (SSMCfg, init_ssm_state, ssm_decode_step, ssm_mixer,
                  ssm_params)

__all__ = ["param_specs", "prepare_params", "shard_params", "forward_hidden",
           "init_cache", "prefill", "decode_step", "loss_fn", "ring_len"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


#: the stage kinds the port runs: every kind of the reference
PORTED_KINDS = ("dec", "hyb", "rwkv", "enc", "xdec")
#: the norms
NORMS = ("rmsnorm", "layernorm")
#: the kinds whose decode cache carries state in prompt order (an SSM or
#: RWKV recurrence), which right-padding would run on past the prompt
RECURRENT_KINDS = ("hyb", "rwkv")
#: the kinds with a decode step (an ``enc`` stage runs in the encoder or
#: in a full-sequence forward only, as in the reference)
DECODE_KINDS = ("dec", "hyb", "rwkv", "xdec")


def _check_ported(cfg: ModelCfg) -> None:
    """Refuse a stage kind or a norm the reference does not have."""
    for st in cfg.stages:
        if st.kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.arch}: unknown stage kind {st.kind!r} "
                f"(ported: {PORTED_KINDS})")
    if cfg.norm not in NORMS:
        raise NotImplementedError(f"{cfg.arch}: unknown norm {cfg.norm!r}")


def _check_decodes(cfg: ModelCfg) -> None:
    for st in cfg.stages:
        if st.kind not in DECODE_KINDS:
            raise NotImplementedError(
                f"{cfg.arch}: a {st.kind!r} stage has no decode step")


def _attn_cfg(cfg: ModelCfg, stage: StageCfg, causal: bool = True
              ) -> AttnCfg:
    return AttnCfg(
        d_model=cfg.d_model, n_q=cfg.n_q, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, causal=causal, window=stage.window,
        flash_chunk=cfg.flash_chunk)


def _norm_params(cfg: ModelCfg, layers: Optional[int] = None) -> dict:
    return (rmsnorm_params(cfg.d_model, layers) if cfg.norm == "rmsnorm"
            else layernorm_params(cfg.d_model, layers))


def _norm(cfg: ModelCfg, x: torch.Tensor, params: dict) -> torch.Tensor:
    return (rmsnorm(x, params) if cfg.norm == "rmsnorm"
            else layernorm(x, params))


def _moe_cfg(cfg: ModelCfg) -> MoECfg:
    return MoECfg(
        d_model=cfg.d_model, d_ff=cfg.moe_dff, n_experts=cfg.moe_experts,
        top_k=cfg.moe_topk, router_score=cfg.router_score,
        capacity_factor=cfg.capacity_factor, gate=cfg.gate,
        n_shared=cfg.moe_shared, mode=cfg.moe_mode)


def _ssm_cfg(cfg: ModelCfg) -> SSMCfg:
    return SSMCfg(d_model=cfg.d_model, d_inner=cfg.ssm_inner,
                  d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
                  dt_rank=cfg.ssm_dt_rank, chunk=cfg.ssm_chunk)


def _rwkv_cfg(cfg: ModelCfg) -> RWKVCfg:
    return RWKVCfg(d_model=cfg.d_model, n_heads=cfg.n_q,
                   head_dim=cfg.head_dim, decay_lora=cfg.rwkv_decay_lora,
                   d_ff=cfg.d_ff, chunk=cfg.rwkv_chunk)


def _stage_key(i: int, st: StageCfg) -> str:
    return f"s{i}_{st.kind}"


def ring_len(st: StageCfg, cache_len: int) -> int:
    """A stage's decode ring: the cache, or its window when shorter."""
    return cache_len if st.window is None else min(st.window, cache_len)


def _stage_specs(cfg: ModelCfg, st: StageCfg) -> dict:
    l = st.n_layers
    if st.kind == "rwkv":
        return {"ln1": _norm_params(cfg, l),
                "tm": rwkv_time_params(_rwkv_cfg(cfg), l),
                "ln2": _norm_params(cfg, l),
                "cm": rwkv_channel_params(_rwkv_cfg(cfg), l)}
    out = {"ln1": _norm_params(cfg, l),
           "attn": attn_params(_attn_cfg(cfg, st, st.kind != "enc"), l),
           "ln2": _norm_params(cfg, l)}
    if st.kind == "hyb":
        out["ssm"] = ssm_params(_ssm_cfg(cfg), l)
    if st.moe:
        out["moe"] = moe_params(_moe_cfg(cfg), l)
    elif st.kind in ("enc", "xdec"):
        out["mlp"] = mlp_params(cfg.d_model, cfg.d_ff, l, bias=True)
    else:
        out["mlp"] = gated_mlp_params(cfg.d_model, cfg.d_ff, l)
    if st.kind == "xdec":
        out["lnx"] = _norm_params(cfg, l)
        out["xattn"] = attn_params(_attn_cfg(cfg, st, False), l)
    return out


def _enc_stage(cfg: ModelCfg) -> StageCfg:
    return StageCfg("enc", cfg.enc_layers)


def param_specs(cfg: ModelCfg) -> dict:
    _check_ported(cfg)
    out: Dict[str, Any] = {
        "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "ln_f": _norm_params(cfg),
        "stages": {_stage_key(i, st): _stage_specs(cfg, st)
                   for i, st in enumerate(cfg.stages)},
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           scale=0.02)
    if cfg.enc_layers:
        out["encoder"] = {
            "pos": P((cfg.enc_seq, cfg.d_model), (None, "embed"), scale=0.02),
            "stack": _stage_specs(cfg, _enc_stage(cfg)),
            "ln_f": _norm_params(cfg),
        }
    return out


def prepare_params(params: dict, cfg: ModelCfg, device=None) -> dict:
    """Cast floating parameters to ``compute_dtype`` (once), move them to
    ``device`` (None: where they are) and split every stacked layer axis
    (each stage's, the encoder's) into a list of per-layer dicts
    (views)."""
    _check_ported(cfg)
    dt = dtype_of(cfg.compute_dtype)
    cast = map_tree(
        lambda t: t.to(device=device,
                       dtype=dt if t.is_floating_point() else t.dtype),
        params)

    def split(tree, n):
        return [map_tree(lambda t, j=j: t[j], tree) for j in range(n)]

    out = {k: v for k, v in cast.items() if k != "stages"}
    out["stages"] = {
        _stage_key(i, st): split(cast["stages"][_stage_key(i, st)],
                                 st.n_layers)
        for i, st in enumerate(cfg.stages)}
    if cfg.enc_layers:
        out["encoder"] = dict(cast["encoder"], stack=split(
            cast["encoder"]["stack"], cfg.enc_layers))
    return out


def shard_params(params: dict, cfg: ModelCfg, ctx: ShardCtx) -> dict:
    """Prepared params with every leaf a DTensor on ``ctx.mesh``, placed by
    ``param_shardings`` under the "serve" profile's rules: each rank keeps
    its own shard, taken without communication from the global tensors,
    which every rank holds.  A stacked leaf's per-layer views take its
    spec without the "layers" dim."""
    if ctx.mesh is None:
        return params
    from ..distributed.sharding import make_rules, spec_tree, to_dtensor
    mesh = ctx.mesh
    specs = spec_tree(param_specs(cfg), mesh, make_rules("serve", mesh))

    def put(t, spec):
        return to_dtensor(t, mesh, spec)

    def layers(views, stacked):
        return [map_trees(lambda t, s: put(t, s[1:]), v, stacked)
                for v in views]

    out = {k: map_trees(put, v, specs[k]) for k, v in params.items()
           if k not in ("stages", "encoder")}
    out["stages"] = {k: layers(v, specs["stages"][k])
                     for k, v in params["stages"].items()}
    if "encoder" in params:
        enc, es = params["encoder"], specs["encoder"]
        out["encoder"] = {k: (layers(v, es[k]) if k == "stack"
                              else map_trees(put, v, es[k]))
                          for k, v in enc.items()}
    return out


def _head(params: dict) -> torch.Tensor:
    return params.get("lm_head", params["embed"])


def forward_hidden(params: dict, cfg: ModelCfg, batch: dict,
                   acts: ActBundle) -> torch.Tensor:
    """Final hidden (B, T', D) of a full sequence (prepared params):
    ``batch`` {"tokens" (B, T) int, and "enc_feats" (B, enc_seq, D) with
    an encoder, "vision_embeds" (B, vision_tokens, D) with a vision
    prefix}.  T' counts the vision prefix (the caller slices)."""
    h, _ = _prefill_hidden(params, cfg, batch, acts, None, None)
    return h


def _ffn(cfg: ModelCfg, st: StageCfg, p: dict, x: torch.Tensor,
         acts: ActBundle, ctx: Optional[ShardCtx] = None):
    """The block's second half: (y, MoE aux loss or None).  The encoder's
    and the cross decoder's MLP is the plain one with gelu, whatever
    ``cfg.gate``, as in the reference.  ``ctx``: the mesh the layers
    shard over (None: one process)."""
    if st.moe:
        return moe_block(p["moe"], x, _moe_cfg(cfg), acts, ctx)
    if st.kind in ("enc", "xdec"):
        return mlp(p["mlp"], x, acts, gate="gelu", ctx=ctx), None
    return gated_mlp(p["mlp"], x, acts, gate=cfg.gate, ctx=ctx), None


def _layer(cfg, st, acts, positions, h, p, enc_out=None, ctx=None):
    """One block on a full sequence: (h, its decode state unpacked, aux or
    None).  The state is {"kv": (k, v)} and, on a ``hyb`` block, the SSM's
    final carry, on an ``xdec`` block the encoder's cross K/V {"xk", "xv"};
    on an ``rwkv`` block {"rwkv": {"tm_last", "cm_last", "s"}}."""
    hn = _norm(cfg, h, p["ln1"])
    if st.kind == "rwkv":
        rcfg = _rwkv_cfg(cfg)
        y, (tm_last, s) = rwkv_time_mix(p["tm"], rcfg, hn, acts,
                                        return_state=True, ctx=ctx)
        h = h + y
        hn2 = _norm(cfg, h, p["ln2"])
        h = h + rwkv_channel_mix(p["cm"], rcfg, hn2, acts, ctx=ctx)
        return h, {"rwkv": {"tm_last": tm_last, "cm_last": hn2[:, -1:],
                            "s": s}}, None
    a, kv = attention(p["attn"], _attn_cfg(cfg, st, st.kind != "enc"), hn,
                      acts, positions=positions, impl=cfg.attn_impl,
                      return_kv=True, ctx=ctx)
    state = {"kv": kv}
    if st.kind == "hyb":
        s, state["ssm"] = ssm_mixer(p["ssm"], _ssm_cfg(cfg), hn, acts,
                                    return_state=True, ctx=ctx)
        h = h + 0.5 * (a + s)
    else:
        h = h + a
    if st.kind == "xdec":
        c, (state["xk"], state["xv"]) = attention(
            p["xattn"], _attn_cfg(cfg, st, False),
            _norm(cfg, h, p["lnx"]), acts, x_kv=enc_out,
            impl=cfg.attn_impl, return_kv=True, ctx=ctx)
        h = h + c
    y, aux = _ffn(cfg, st, p, _norm(cfg, h, p["ln2"]), acts, ctx)
    return h + y, state, aux


def _encode(cfg: ModelCfg, enc: dict, layers, enc_feats: torch.Tensor,
            acts: ActBundle, layer_fn=None, ctx=None) -> torch.Tensor:
    """The encoder on frame embeddings (B, S, D) in the compute dtype:
    each frame standardised (the mean, then the mean of the centred
    squares, as ``jnp.mean`` takes them), the learned positions added,
    then the ``enc`` layers (``layers``: per-layer params; ``layer_fn``
    wraps the layer, e.g. for recompute) and the final norm.  The conv
    frontend is a stub: the features may come at any scale, and the real
    one emits unit-scale features."""
    mu = mean_last(enc_feats)
    var = mean_last(torch.square(enc_feats - mu))
    h = (enc_feats - mu) * torch.rsqrt(var + 1e-6)
    h = h + enc["pos"][None, :enc_feats.shape[1]]
    st = _enc_stage(cfg)
    fn = functools.partial(_train_layer, cfg, st, acts, None, None, ctx=ctx)
    if layer_fn is not None:
        fn = layer_fn(fn)
    for p in layers:
        h, _ = fn(h, p)
    return _norm(cfg, h, enc["ln_f"])


def _embed_inputs(params: dict, cfg: ModelCfg, batch: dict,
                  acts: ActBundle, layer_fn=None, ctx=None):
    """(h (B, T', D), the encoder's output or None): the token embeddings
    after the vision prefix, and the encoder (its stack a list of
    per-layer params) run on ``enc_feats``."""
    h = embed_lookup(params["embed"], batch["tokens"], ctx)
    if cfg.vision_tokens:
        h = torch.cat([batch["vision_embeds"].to(h.dtype), h], dim=1)
    enc_out = None
    if cfg.enc_layers:
        enc = params["encoder"]
        enc_out = _encode(cfg, enc, enc["stack"],
                          batch["enc_feats"].to(h.dtype), acts, layer_fn,
                          ctx)
    return h, enc_out


def _pack_state(state: dict, positions, eff: int, dtype) -> dict:
    """A layer's decode-cache entry from its ``_layer`` state: K/V into a
    ring of ``eff``, the SSM conv window and the RWKV token shifts in the
    cache dtype, the recurrent states in float32.  Each is a copy: a carry
    is a view of its chunk's whole state tensor (RWKV's (B, T, H, D, D)
    float32, 42 MB a layer for one 64-token chunk at rwkv6-3b's width),
    which the packed layers would otherwise keep alive to the end of the
    prefill."""
    out = {}
    if "kv" in state:
        out["kv"] = _pack_ring(*state["kv"], positions, eff, dtype)
    if "ssm" in state:
        out["ssm"] = {"conv": state["ssm"]["conv"].to(dtype, copy=True),
                      "h": state["ssm"]["h"].clone()}
    if "xk" in state:
        out["xk"] = state["xk"].to(dtype, copy=True)
        out["xv"] = state["xv"].to(dtype, copy=True)
    if "rwkv" in state:
        st = state["rwkv"]
        out["rwkv"] = {"tm_last": st["tm_last"].to(dtype, copy=True),
                       "cm_last": st["cm_last"].to(dtype, copy=True),
                       "s": st["s"].clone()}
    return out


def _prefill_hidden(params, cfg, batch, acts, cache_len, cache_dtype,
                    ctx=None):
    ctx = ctx or LOCAL
    h, enc_out = _embed_inputs(params, cfg, batch, acts, ctx=ctx)
    b, t, _ = h.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=h.device).expand(b, t)
    cache = {}
    if cache_len is not None:
        _check_decodes(cfg)
    for i, st in enumerate(cfg.stages):
        key = _stage_key(i, st)
        packed = []
        h = shard_hint(h, ctx, ctx.batch_spec, None, None)
        for p in params["stages"][key]:
            h, state, _ = _layer(cfg, st, acts, positions, h, p, enc_out,
                                 ctx)
            if cache_len is not None:
                packed.append(_pack_state(state, positions,
                                          ring_len(st, cache_len),
                                          cache_dtype))
        if cache_len is not None:
            cache[key] = map_trees(lambda *ls: torch.stack(ls), *packed)
    return _norm(cfg, h, params["ln_f"]), cache


def init_cache(cfg: ModelCfg, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Empty decode cache in the layout the module docstring gives: K/V
    rings with every position -1, zero recurrent states and cross K/V."""
    _check_ported(cfg)
    _check_decodes(cfg)
    device = resolve_device(device)
    out = {}
    for i, st in enumerate(cfg.stages):
        one = {}
        if st.kind != "rwkv":
            one["kv"] = init_kv_cache(batch, ring_len(st, cache_len),
                                      _attn_cfg(cfg, st), dtype, device)
        if st.kind == "xdec":
            for name in ("xk", "xv"):
                one[name] = torch.zeros(
                    (batch, cfg.enc_seq, cfg.n_kv, cfg.head_dim),
                    dtype=dtype, device=device)
        if st.kind == "hyb":
            one["ssm"] = init_ssm_state(batch, _ssm_cfg(cfg), dtype, device)
        if st.kind == "rwkv":
            one["rwkv"] = init_rwkv_state(batch, _rwkv_cfg(cfg), cfg.d_model,
                                          dtype, device)
        out[_stage_key(i, st)] = map_trees(
            lambda t, n=st.n_layers: t.unsqueeze(0).repeat(
                (n,) + (1,) * t.dim()), one)
    return out


def _pack_ring(k, v, positions, eff: int, dtype) -> dict:
    """Pack full-prompt K/V (B, T, Hk, Dh) into a ring cache of length eff,
    keeping the last ``eff`` positions at slots pos % eff."""
    b, t = k.shape[:2]
    keep = min(t, eff)
    kk, vv = k[:, -keep:], v[:, -keep:]
    pp = positions[:, -keep:]
    slots = (pp[0] % eff).long()            # identical across batch
    if is_dtensor(k):
        return _pack_ring_placed(kk, vv, pp, slots, eff, dtype)
    kc = torch.zeros((b, eff) + tuple(k.shape[2:]), dtype=dtype,
                     device=k.device)
    vc = torch.zeros((b, eff) + tuple(v.shape[2:]), dtype=dtype,
                     device=v.device)
    pc = torch.full((b, eff), -1, dtype=torch.int32, device=k.device)
    kc[:, slots] = kk.to(dtype)
    vc[:, slots] = vv.to(dtype)
    pc[:, slots] = pp.to(torch.int32)
    return {"k": kc, "v": vc, "pos": pc}


def _pack_ring_placed(kk, vv, pp, slots, eff: int, dtype) -> dict:
    """:func:`_pack_ring` on DTensors, out of place (a DTensor has no
    in-place row write across placements): the kept positions are 0..keep-1
    then padding when the prompt is shorter than the ring, else a
    permutation of the ring's slots."""
    keep = kk.shape[1]
    if keep < eff:
        def pad(x, fill, dt):
            tail = torch.full((x.shape[0], eff - keep) + tuple(x.shape[2:]),
                              fill, dtype=dt, device=x.device)
            return torch.cat([x.to(dt), tail], dim=1)
        return {"k": pad(kk, 0, dtype), "v": pad(vv, 0, dtype),
                "pos": pad(pp, -1, torch.int32)}
    order = torch.argsort(slots)
    return {"k": kk.index_select(1, order).to(dtype),
            "v": vv.index_select(1, order).to(dtype),
            "pos": pp.index_select(1, order).to(torch.int32)}


def prefill(params: dict, cfg: ModelCfg, batch: dict, cache_len: int,
            acts: ActBundle, cache_dtype=torch.bfloat16,
            last_idx: Optional[torch.Tensor] = None,
            ctx: Optional[ShardCtx] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Run the full prompt once (prepared params); return (last-token
    logits, decode cache).  ``batch`` as :func:`forward_hidden` takes it.
    ``last_idx`` (B,) picks each row's last real position in the whole
    sequence (the vision prefix included) when prompts are right-padded to
    a shared length.  ``ctx``: a mesh (the params, batch and cache
    DTensors), or None."""
    with on_mesh(ctx):
        h, cache = _prefill_hidden(params, cfg, batch, acts, cache_len,
                                   cache_dtype, ctx)
        if last_idx is None:
            last = h[:, -1]
        elif ctx is None or ctx.mesh is None:
            last = h[torch.arange(h.shape[0], device=h.device),
                     last_idx.long()]
        else:
            from ..distributed.sharding import local_call
            bs = ctx.batch_spec
            last = local_call(
                ctx.mesh, lambda x, i: x[torch.arange(
                    x.shape[0], device=x.device), i.long()],
                [(h, (bs, None, None)), (last_idx, (bs,))], (bs, None),
                shape=(h.shape[0], h.shape[-1]))
        return lm_head_logits(last, _head(params), ctx), cache


def _decode_layer(cfg, st, acts, p, cache: dict, j: int, pos, h,
                  ctx=None):
    """Layer ``j`` of a stage at one decode step; writes its cache entries
    in place."""
    hn = _norm(cfg, h, p["ln1"])
    if st.kind == "rwkv":
        rcfg, c = _rwkv_cfg(cfg), cache["rwkv"]
        y, tm_last, s = time_step(p["tm"], rcfg, hn, c["tm_last"][j],
                                  c["s"][j], acts, ctx)
        h = h + y
        hn2 = _norm(cfg, h, p["ln2"])
        h = h + rwkv_channel_mix(p["cm"], rcfg, hn2, acts,
                                 x_last=c["cm_last"][j], ctx=ctx)
        for name, new in (("tm_last", tm_last), ("cm_last", hn2), ("s", s)):
            c[name][j].copy_(new)
        return h
    layer_kv = {n: cache["kv"][n][j] for n in ("k", "v", "pos")}
    a, _ = decode_attention(p["attn"], _attn_cfg(cfg, st), hn, layer_kv,
                            pos, acts, ctx=ctx)
    if st.kind == "hyb":
        c = cache["ssm"]
        s, new = ssm_decode_step(p["ssm"], _ssm_cfg(cfg), hn,
                                 {n: c[n][j] for n in ("conv", "h")}, acts,
                                 ctx)
        for name in ("conv", "h"):
            c[name][j].copy_(new[name])
        h = h + 0.5 * (a + s)
    else:
        h = h + a
    if st.kind == "xdec":
        h = h + cross_attention_cached(
            p["xattn"], _attn_cfg(cfg, st, False), _norm(cfg, h, p["lnx"]),
            cache["xk"][j], cache["xv"][j], acts, ctx=ctx)
    return h + _ffn(cfg, st, p, _norm(cfg, h, p["ln2"]), acts, ctx)[0]


def decode_step(params: dict, cfg: ModelCfg, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor, acts: ActBundle,
                ctx: Optional[ShardCtx] = None
                ) -> Tuple[torch.Tensor, dict]:
    """One token for every sequence: tokens (B, 1), pos (B,) -> logits
    (B, V); the cache is updated in place and returned.  ``ctx``: a mesh
    (the params, inputs and cache DTensors), or None."""
    with on_mesh(ctx):
        h = embed_lookup(params["embed"], tokens, ctx)
        for i, st in enumerate(cfg.stages):
            key = _stage_key(i, st)
            for j, p in enumerate(params["stages"][key]):
                h = _decode_layer(cfg, st, acts, p, cache[key], j, pos, h,
                                  ctx)
        h = _norm(cfg, h, params["ln_f"])
        return lm_head_logits(h, _head(params), ctx)[:, 0], cache


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


def _train_layer(cfg, st, acts, positions, enc_out, h, p, ctx=None):
    h, _, aux = _layer(cfg, st, acts, positions, h, p, enc_out, ctx)
    return h, aux


def _unstack(tree: dict, n: int) -> list:
    """Per-layer dicts of a stacked tree, through ``unbind``."""
    parts = map_tree(lambda t: t.unbind(0), tree)
    return [map_tree(lambda u, j=j: u[j], parts) for j in range(n)]


def loss_fn(params: dict, cfg: ModelCfg, batch: dict, acts: ActBundle,
            ctx: Optional[ShardCtx] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"
    (B, T) int, optional "loss_mask", and the extras
    :func:`forward_hidden` takes}) under the raw (float32 master)
    ``params``: (loss, {"nll", "aux", "denom"}), differentiable in the
    params.  The vision prefix's positions take no loss.  ``ctx``: a mesh
    (the params and batch DTensors), or None."""
    with on_mesh(ctx):
        return _loss(params, cfg, batch, acts, ctx or LOCAL)


def _loss(params, cfg, batch, acts, ctx):
    _check_ported(cfg)
    dt = dtype_of(cfg.compute_dtype)
    p = map_tree(lambda t: t.to(dt) if t.is_floating_point() else t, params)
    if cfg.enc_layers:
        p["encoder"]["stack"] = _unstack(p["encoder"]["stack"],
                                         cfg.enc_layers)
    remat = functools.partial(_remat, remat=cfg.remat)
    h, enc_out = _embed_inputs(p, cfg, batch, acts, remat, ctx)
    b, t, _ = h.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=h.device).expand(b, t)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, st in enumerate(cfg.stages):
        layer = remat(functools.partial(_train_layer, cfg, st, acts,
                                        positions, enc_out, ctx=ctx))
        h = shard_hint(h, ctx, ctx.batch_spec, None, None)
        for lp in _unstack(p["stages"][_stage_key(i, st)], st.n_layers):
            h, a = layer(h, lp)
            if a is not None:
                aux = aux + a
    h = _norm(cfg, h, p["ln_f"])[:, cfg.vision_tokens:]
    nll, denom = cross_entropy_chunked(h, _head(p), batch["labels"],
                                       mask=batch.get("loss_mask"),
                                       num_chunks=cfg.ce_chunks, ctx=ctx)
    return nll + aux, {"nll": nll, "aux": aux, "denom": denom}
