"""Optimizers: a copy of ``repro/train/optimizer.py`` on dicts of tensors.

  sgdm      — tests / toy runs.
  adamw     — fp32 moments.
  adamw8    — int8 moments with per-row fp32 scales (2 bytes a parameter
              instead of 8).
  adafactor — factored second moment (row + column) over the last two axes,
              no first moment.

``opt_init(cfg, params) -> state``; ``opt_update(cfg, grads, state,
params, lr) -> (params, state)``.  Unlike the reference's pure functions,
the update writes the new parameters into ``params`` and the new moments
into ``state`` in place, leaf by leaf under ``torch.no_grad()``, so that at
full width only one leaf's temporaries exist beside the model and its
state; the arithmetic is the reference's, in its order.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..kernels.local import is_dtensor
from ..tree import leaves, map_tree, map_trees

__all__ = ["OptCfg", "opt_init", "opt_update", "global_norm", "clip_grads"]


@dataclasses.dataclass(frozen=True)
class OptCfg:
    kind: str = "adamw"          # sgdm | adamw | adamw8 | adafactor
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9        # sgdm
    factored_min: int = 128      # adafactor: factor axes >= this


def _f32(like: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` as a float32 0-dim tensor on ``like``'s device (a Python
    number on the left of ``/`` would be a reciprocal and a product)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------- helpers
@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    return torch.sqrt(sum(sq))


@torch.no_grad()
def clip_grads(grads, max_norm: float):
    n = global_norm(grads)
    scale = torch.clamp_max(_f32(n, max_norm) / torch.clamp_min(n, 1e-9),
                            1.0)
    return map_tree(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), n


# ----------------------------------------------------- int8 moment codec
def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization (row = leading axes); rounds
    half to even, as ``jnp.round``."""
    xf = x.to(torch.float32)
    amax = (torch.amax(torch.abs(xf), dim=-1, keepdim=True) if x.dim()
            else torch.abs(xf))
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _factored(cfg: OptCfg, p: torch.Tensor) -> bool:
    return (p.dim() >= 2 and p.shape[-1] >= cfg.factored_min
            and p.shape[-2] >= cfg.factored_min)


# ------------------------------------------------- adafactor on a mesh
def _moment(p, dim: int):
    """Float32 zeros of ``p``'s shape without ``dim``, placed as ``p``
    without it (replicated over the mesh axes that split ``dim``), made
    from zeros of the local shard's shape with no collective."""
    from ..distributed.sharding import spec_of, wrap_local
    d = dim % p.dim()
    loc = p.to_local()
    spec = list(spec_of(p))
    del spec[d]
    z = torch.zeros(loc.shape[:d] + loc.shape[d + 1:], dtype=torch.float32,
                    device=loc.device)
    return wrap_local(z, p.device_mesh, tuple(spec),
                      p.shape[:d] + p.shape[d + 1:])


def _means(p=None):
    """The means adafactor takes of leaf ``p``: ``mean(x, dim=None,
    keepdim=False, leaf_dim=None)`` of ``x`` laid out as ``p`` (``dim``
    None: all of it; ``leaf_dim``: the dim of ``p`` that ``x`` 's ``dim``
    holds, default ``dim``).  Off a mesh (``p`` None) ``torch.mean``.  On
    a mesh, of the rank's shard: the local sum, one all-reduce a mesh axis
    that splits the dim, divided by the dim's global length."""
    if p is None:
        def mean(x, dim=None, keepdim=False, leaf_dim=None):
            return (torch.mean(x) if dim is None
                    else torch.mean(x, dim=dim, keepdim=keepdim))
        return mean
    from ..distributed.collectives import all_reduce
    from ..distributed.sharding import spec_of
    mesh, spec = p.device_mesh, spec_of(p)
    split = [a for a in mesh.mesh_dim_names if any(a in s for s in spec)]

    def mean(x, dim=None, keepdim=False, leaf_dim=None):
        if dim is None:
            axes, n, s = split, p.numel(), torch.sum(x)
        else:
            ld = dim if leaf_dim is None else leaf_dim
            axes, n = spec[ld], p.shape[ld]
            s = torch.sum(x, dim=dim, keepdim=keepdim)
        if axes:
            s = all_reduce(s, mesh, axes)
        return s / n
    return mean


def _grad_shard(g, p) -> torch.Tensor:
    """The rank's shard of gradient ``g`` placed as ``p``.  A pending sum
    over mesh axes (``Partial``, as a replicated leaf's gradient comes out
    of the backward) is summed first with one all-reduce an axis, of a copy
    of the local tensor, so that DTensor splits no dim for a
    reduce-scatter."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from ..distributed.collectives import all_reduce
    from ..distributed.sharding import local_at
    mesh = p.device_mesh
    if isinstance(g, DTensor):
        axes = [a for a, pl in zip(mesh.mesh_dim_names, g.placements)
                if isinstance(pl, Partial) and pl.reduce_op == "sum"]
        if axes:
            pls = [Replicate() if a in axes else pl for a, pl in
                   zip(mesh.mesh_dim_names, g.placements)]
            g = DTensor.from_local(all_reduce(g.to_local().clone(), mesh,
                                              axes),
                                   mesh, pls, run_check=False, shape=g.shape,
                                   stride=g.stride())
    return local_at(g, mesh, p.placements)


# ----------------------------------------------------------------- init
@torch.no_grad()
def opt_init(cfg: OptCfg, params):
    def per_leaf(p):
        if cfg.kind == "adafactor" and _factored(cfg, p) and is_dtensor(p):
            return {"vr": _moment(p, -1), "vc": _moment(p, -2)}
        z = torch.zeros_like(p, dtype=torch.float32)
        if cfg.kind == "sgdm":
            return {"m": z}
        if cfg.kind == "adamw":
            return {"m": z, "v": torch.zeros_like(z)}
        if cfg.kind == "adamw8":
            zq, zs = _q8(z)
            return {"m_q": zq, "m_s": zs, "v_q": zq.clone(),
                    "v_s": zs.clone()}
        if cfg.kind == "adafactor":
            if _factored(cfg, p):
                return {"vr": torch.zeros_like(z[..., 0]),
                        "vc": torch.zeros_like(z[..., 0, :])}
            return {"v": z}
        raise ValueError(cfg.kind)

    moments = map_tree(per_leaf, params)
    dev = leaves(params)[0].device
    return {"count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": moments}


# --------------------------------------------------------------- update
def _leaf(cfg: OptCfg, g, s: dict, p, lr, cf) -> None:
    mean, held = _means(), None
    if cfg.kind == "adafactor" and is_dtensor(p):
        # the rank's shards; the moments come back placed as they were
        mean, held = _means(p), s
        g = _grad_shard(g, p)
        p, s = p.to_local(), {k: v.to_local() for k, v in s.items()}
    gf = g.to(torch.float32)
    if cfg.kind == "sgdm":
        m = cfg.momentum * s["m"] + gf
        upd = m
        new_s = {"m": m}
    elif cfg.kind in ("adamw", "adamw8"):
        if cfg.kind == "adamw":
            m0, v0 = s["m"], s["v"]
        else:
            m0, v0 = _dq8(s["m_q"], s["m_s"]), _dq8(s["v_q"], s["v_s"])
        m = cfg.b1 * m0 + (1 - cfg.b1) * gf
        v = cfg.b2 * v0 + (1 - cfg.b2) * gf * gf
        mh = m / (1 - cfg.b1 ** cf)
        vh = v / (1 - cfg.b2 ** cf)
        upd = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.kind == "adamw":
            new_s = {"m": m, "v": v}
        else:
            (mq, ms), (vq, vs) = _q8(m), _q8(v)
            new_s = {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}
    elif cfg.kind == "adafactor":
        g2 = gf * gf + 1e-30
        if "vr" in s:
            vr = cfg.b2 * s["vr"] + (1 - cfg.b2) * mean(g2, -1)
            vc = cfg.b2 * s["vc"] + (1 - cfg.b2) * mean(g2, -2)
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / torch.clamp_min(mean(vr, -1, keepdim=True, leaf_dim=-2)
                                  [..., None], 1e-30))
            upd = gf / torch.clamp_min(denom, cfg.eps)
            new_s = {"vr": vr, "vc": vc}
        else:
            v = cfg.b2 * s["v"] + (1 - cfg.b2) * g2
            upd = gf / (torch.sqrt(v) + cfg.eps)
            new_s = {"v": v}
        # adafactor-style update clipping (RMS <= 1)
        rms = torch.sqrt(mean(torch.square(upd)) + 1e-30)
        upd = upd / torch.clamp_min(rms, 1.0)
    else:
        raise ValueError(cfg.kind)

    if cfg.weight_decay and p.dim() >= 2:     # no decay on norms/biases
        upd = upd + cfg.weight_decay * p.to(torch.float32)
    p.copy_((p.to(torch.float32) - lr * upd).to(p.dtype))
    if held is not None:
        from ..distributed.sharding import spec_of, wrap_local
        s, new_s = held, {k: wrap_local(v, held[k].device_mesh,
                                        spec_of(held[k]), held[k].shape)
                          for k, v in new_s.items()}
    s.update(new_s)


@torch.no_grad()
def opt_update(cfg: OptCfg, grads, state, params, lr):
    """One step: the params and moments of ``state`` are updated in place
    and returned, with the step count advanced."""
    count = state["count"] + 1
    cf = count.to(torch.float32)
    lr = torch.as_tensor(lr, dtype=torch.float32).to(cf.device)
    map_trees(lambda p, g, s: _leaf(cfg, g, s, p, lr, cf), params, grads,
              state["mu"])
    state["count"] = count
    return params, state
