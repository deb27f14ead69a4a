"""Selective SSM (Mamba-style) mixer — the state-space half of hymba.

Counterpart of ``repro/models/ssm.py``.  Per channel c, state dim N:

    delta_t = softplus(dt_proj(x'_t) + dt_bias)          [PPA softplus]
    a_t     = exp(-delta_t * A_c)                        [PPA exp_decay]
    h_t     = a_t * h_{t-1} + delta_t * B_t * x_t
    y_t     = <C_t, h_t> + D_c * x_t

Prefill and training run the sequence in chunks (the reference's
``jax.lax.scan``, a Python loop here) with an associative scan inside each
chunk (:func:`~repro_torch.models.scan.associative_scan`, JAX's recursion
order); under autograd each chunk is recomputed in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` in the reference), so the
(B, Tc, d, N) state tensor is the only O(T) activation.  Decode is the
one-step recurrence on a carried (B, d, N) state.  The silu, softplus and
exp_decay go through the ActBundle: on the card, the fused kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels.local import no_storage
from ..roofline import op_costs
from .activations import ActBundle
from .common import LOCAL, P, ShardCtx, shard_hint, tp_matmul
from .scan import associative_scan

__all__ = ["SSMCfg", "ssm_params", "ssm_mixer", "ssm_decode_step",
           "init_ssm_state", "chunked"]


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_model: int
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 64
    chunk: int = 256


def ssm_params(cfg: SSMCfg, layers: Optional[int] = None) -> dict:
    def lp(shape, axes, **kw):
        if layers is None:
            return P(shape, axes, **kw)
        return P((layers,) + shape, ("layers",) + axes, **kw)

    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank
    return {
        "w_in": lp((d, 2 * di), ("embed", "inner2")),     # x_part | z gate
        "conv_w": lp((cfg.d_conv, di), (None, "inner"), scale=0.5),
        "conv_b": lp((di,), ("inner",), init="zeros"),
        "w_x": lp((di, r + 2 * n), ("inner", None)),      # dt_low | B | C
        "w_dt": lp((r, di), (None, "inner")),
        "dt_bias": lp((di,), ("inner",), init="zeros"),
        "a_log": lp((di, n), ("inner", None), init="zeros"),
        "d_skip": lp((di,), ("inner",), init="ones"),
        "w_out": lp((di, d), ("inner", "embed")),
    }


def chunked(step, x: torch.Tensor, chunk: int, carry: tuple):
    """``step(x_chunk, *carry) -> (y, *carry)`` over the chunks of ``x``
    along time (axis 1), in order: (y of the whole sequence, final carry).
    The chunk is the reference's: ``min(chunk, T)``, lowered until it
    divides T (a prime T above ``chunk`` gives chunks of 1).  Under
    autograd each chunk is recomputed in the backward.

    On a tensor without data (the dry run), chunk 0 runs, then chunk 1
    with its counts, forward and backward, taken for the remaining chunks
    (``op_costs.scaled``, ``op_costs.scale_nodes``): from chunk 1 on every
    chunk runs the same ops at the same shapes and dtypes, and a fake
    tensor's chunks differ in nothing else.  Only the sums of the chunks'
    gradients into one parameter are counted once, not once a chunk."""
    t = x.shape[1]
    c = min(chunk, t)
    while t % c:
        c -= 1
    if t // c > 2 and no_storage(x):
        return _chunked_once(step, x, c, t // c, carry)
    ys = []
    for j in range(t // c):
        xc = x[:, j * c:(j + 1) * c]
        if torch.is_grad_enabled():
            y, *carry = checkpoint(step, xc, *carry, use_reentrant=False)
        else:
            y, *carry = step(xc, *carry)
        ys.append(y)
    return torch.cat(ys, dim=1), tuple(carry)


def _run_chunk(step, xc, carry):
    if torch.is_grad_enabled():
        return checkpoint(step, xc, *carry, use_reentrant=False)
    return step(xc, *carry)


def _chunked_once(step, x, c: int, n: int, carry: tuple):
    """:func:`chunked` on a tensor without data: chunks 0 and 1 run, chunk
    1 counted n - 1 times."""
    y0, *carry = _run_chunk(step, x[:, :c], carry)
    mark = op_costs.node_mark()
    with op_costs.scaled(n - 1):
        y1, *carry = _run_chunk(step, x[:, c:2 * c], carry)
    op_costs.scale_nodes([y1, *carry], mark, n - 1)
    ys = [y0, y1] + [torch.empty_like(y1) for _ in range(n - 2)]
    return torch.cat(ys, dim=1), tuple(carry)


def _cat_promoted(parts, dim: int) -> torch.Tensor:
    """concatenate with JAX's dtype promotion (a float32 carry beside a
    bfloat16 sequence gives float32)."""
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    return torch.cat([p.to(dt) for p in parts], dim=dim)


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            state: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over T.  x: (B, T, di), w: (K, di); ``state``
    (B, K-1, di) is the trailing context of the previous call."""
    k = w.shape[0]
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out + b


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _ssm_inner(params, cfg: SSMCfg, xz: torch.Tensor, conv_state, h0,
               acts: ActBundle, reduce=None):
    """Shared body: xz = x @ w_in; returns (y, new conv state, final h).
    ``reduce``: the sum over the ranks that split the channels (on a
    mesh), taken of the x projection, whose contraction runs over them."""
    di = cfg.d_inner
    xs, z = xz[..., :di], xz[..., di:]
    new_conv = _cat_promoted([conv_state, xs], 1)[:, -(cfg.d_conv - 1):]
    xc = acts.silu(_conv1d(xs, params["conv_w"], params["conv_b"],
                           conv_state))

    proj = torch.einsum("btd,dr->btr", xc, params["w_x"])
    if reduce is not None:
        proj = reduce(proj)
    r, n = cfg.dt_rank, cfg.d_state
    dt_low = proj[..., :r]
    bmat = proj[..., r:r + n]                      # (B, T, N)
    cmat = proj[..., r + n:]                       # (B, T, N)
    delta = acts.softplus(
        torch.einsum("btr,rd->btd", dt_low, params["w_dt"])
        + params["dt_bias"])                       # (B, T, di)
    a = -torch.exp(params["a_log"].to(torch.float32))   # (di, N), A < 0
    # decay in (0, 1]: exp(delta * a) = exp_decay(delta * |a|)
    dn = delta.to(torch.float32)[..., None] * (-a)      # (B,T,di,N) >= 0
    decay = acts.exp_decay(dn)
    drive = ((delta * xc).to(torch.float32)[..., None]
             * bmat.to(torch.float32)[..., None, :])    # (B,T,di,N)

    aa, hh = associative_scan(_combine, (decay, drive), axis=1)
    hh = hh + aa * h0[:, None]                     # prefix state
    y = torch.einsum("btdn,btn->btd", hh, cmat.to(torch.float32))
    y = y.to(xc.dtype) + params["d_skip"] * xc
    y = y * acts.silu(z)
    return y, new_conv, hh[:, -1]


def ssm_mixer(params: dict, cfg: SSMCfg, x: torch.Tensor, acts: ActBundle,
              return_state: bool = False, ctx: Optional[ShardCtx] = None):
    """Full-sequence mixer (training and prefill).  With ``return_state``
    also the final carry {"conv": (B, K-1, di), "h": (B, di, N) float32},
    which prefill packs into the decode cache."""
    ctx = ctx or LOCAL
    b = x.shape[0]
    xz = _in_proj(x, params, ctx)
    xz = shard_hint(xz, ctx, ctx.batch_spec, None, ctx.tp_axis)

    def run(p, c, xz, conv_s, h, reduce=None):
        def step(xz_c, conv_s, h):
            return _ssm_inner(p, c, xz_c, conv_s, h, acts, reduce)
        y, (conv_f, h_f) = chunked(step, xz, c.chunk, (conv_s, h))
        return y, conv_f, h_f

    conv0 = torch.zeros((b, cfg.d_conv - 1, cfg.d_inner), dtype=xz.dtype,
                        device=x.device)
    h0 = torch.zeros((b, cfg.d_inner, cfg.d_state), dtype=torch.float32,
                     device=x.device)
    y, conv_f, h_f = _channels(run, params, cfg, xz, conv0, h0, ctx)
    out = _out_proj(y, params, ctx)
    if return_state:
        return out, {"conv": conv_f, "h": h_f}
    return out


def _in_proj(x, params, ctx: ShardCtx) -> torch.Tensor:
    if ctx.mesh is None:
        return torch.einsum("btd,de->bte", x, params["w_in"])
    return tp_matmul(x, params["w_in"], ctx)


def _out_proj(y, params, ctx: ShardCtx) -> torch.Tensor:
    if ctx.mesh is None:
        return torch.einsum("bte,ed->btd", y, params["w_out"])
    return tp_matmul(y, params["w_out"], ctx, row=True)


#: the channel-split parameters' specs on a mesh ("tp": the model axis)
_CHANNEL_SPECS = {"conv_w": (None, "tp"), "conv_b": ("tp",),
                  "w_x": ("tp", None), "w_dt": (None, "tp"),
                  "dt_bias": ("tp",), "a_log": ("tp", None),
                  "d_skip": ("tp",)}


def _channels(run, params, cfg: SSMCfg, xz, conv_s, h, ctx: ShardCtx):
    """``run(params, cfg, xz, conv, h, reduce) -> (y, conv, h)``; on a
    mesh on each rank's batch rows and its channels of ``d_inner`` (as
    ``shard_map`` would run the mixer: the scan is per channel), the x
    projection summed over the ranks that split them."""
    if ctx.mesh is None:
        return run(params, cfg, xz, conv_s, h)
    from ..distributed.collectives import all_reduce, axis_size
    from ..distributed.sharding import local_call
    mesh, bs, tp = ctx.mesh, ctx.batch_spec, ctx.tp_axis
    di = cfg.d_inner
    lcfg = dataclasses.replace(cfg, d_inner=di // axis_size(mesh, tp))
    names = sorted(_CHANNEL_SPECS)

    def fn(xs, z, conv_s, h, *ps):
        return run(dict(params, **dict(zip(names, ps))), lcfg,
                   torch.cat([xs, z], dim=-1), conv_s, h,
                   lambda t: all_reduce(t, mesh, tp))

    chan = (bs, None, tp)
    ins = [(xz[..., :di], chan), (xz[..., di:], chan), (conv_s, chan),
           (h, (bs, tp, None))]
    ins += [(params[k], tuple(tp if a == "tp" else a
                              for a in _CHANNEL_SPECS[k])) for k in names]
    b, t = xz.shape[:2]
    return local_call(mesh, fn, ins, [chan, chan, (bs, tp, None)],
                      shape=[(b, t, di), tuple(conv_s.shape),
                             tuple(h.shape)])


def init_ssm_state(batch: int, cfg: SSMCfg, dtype=torch.bfloat16,
                   device=None) -> dict:
    device = resolve_device(device)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                         dtype=torch.float32, device=device),
    }


def ssm_decode_step(params: dict, cfg: SSMCfg, x: torch.Tensor, state: dict,
                    acts: ActBundle, ctx: Optional[ShardCtx] = None
                    ) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, D) -> ((B, 1, D), the new state in the state's dtypes)."""
    ctx = ctx or LOCAL
    xz = _in_proj(x, params, ctx)

    def run(p, c, xz, conv_s, h, reduce=None):
        return _ssm_inner(p, c, xz, conv_s, h, acts, reduce)

    y, conv_s, h = _channels(run, params, cfg, xz, state["conv"],
                             state["h"], ctx)
    out = _out_proj(y, params, ctx)
    return out, {"conv": conv_s.to(state["conv"].dtype), "h": h}
