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


# ----------------------------------------------------------------- init
@torch.no_grad()
def opt_init(cfg: OptCfg, params):
    def per_leaf(p):
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
                # zeros of z's row and column shapes (on a mesh, DTensors
                # placed as z is)
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
            vr = cfg.b2 * s["vr"] + (1 - cfg.b2) * torch.mean(g2, dim=-1)
            vc = cfg.b2 * s["vc"] + (1 - cfg.b2) * torch.mean(g2, dim=-2)
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True)
                                  [..., None], 1e-30))
            upd = gf / torch.clamp_min(denom, cfg.eps)
            new_s = {"vr": vr, "vc": vc}
        else:
            v = cfg.b2 * s["v"] + (1 - cfg.b2) * g2
            upd = gf / (torch.sqrt(v) + cfg.eps)
            new_s = {"v": v}
        # adafactor-style update clipping (RMS <= 1)
        rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
        upd = upd / torch.clamp_min(rms, 1.0)
    else:
        raise ValueError(cfg.kind)

    if cfg.weight_decay and p.dim() >= 2:     # no decay on norms/biases
        upd = upd + cfg.weight_decay * p.to(torch.float32)
    p.copy_((p.to(torch.float32) - lr * upd).to(p.dtype))
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
