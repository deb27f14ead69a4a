"""The reference training steps: the loss of ``model.py``, its gradients by
autograd (one row at a time, summed), the global-norm clip, and AdamW as
the traffic file states it, in float32 (or the control's precision).

The learning rate of step ``s`` (1-based) is the warmup-then-cosine
schedule at ``s``.  Weight decay applies to leaves of at least
``decay_min_rank`` dimensions in the stacked layout.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from .model import Precision, Reference

__all__ = ["lr_at", "follow"]


def lr_at(sched: dict, step: int) -> float:
    s = float(step)
    if s < sched["warmup_steps"]:
        return sched["peak_lr"] * s / max(1.0, sched["warmup_steps"])
    prog = min(max((s - sched["warmup_steps"])
                   / max(1.0, sched["decay_steps"] - sched["warmup_steps"]),
                   0.0), 1.0)
    r = sched["min_ratio"]
    return sched["peak_lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(
        math.pi * prog)))


def _flat(tree: dict, pre: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k in sorted(tree):
        v, path = tree[k], f"{pre}/{k}" if pre else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def follow(model: dict, traffic: dict, params: dict,
           batch_at: Callable[[int], dict], initial_leaf: Callable,
           steps: int, device, prec: Precision = Precision()) -> dict:
    """Train ``params`` (the float32 tree, consumed) for ``steps`` steps on
    ``batch_at(0), batch_at(1), ...``: {"loss": [...], "grad_norm": {path:
    norm of the clipped first gradient}, "change_norm": {path: norm of the
    parameters' change over the steps}}."""
    ref = Reference(model, device, prec)
    opt, sched = traffic["optimizer"], traffic["schedule"]
    flat = _flat(params)
    for p in flat.values():
        p.requires_grad_(True)
    m = {k: torch.zeros_like(p) for k, p in flat.items()}
    v = {k: torch.zeros_like(p) for k, p in flat.items()}
    losses: List[float] = []
    first: Dict[str, float] = {}
    for s in range(steps):
        batch = batch_at(s)
        tokens, labels = batch["tokens"], batch["labels"]
        feats = batch.get("enc_feats")
        n_tok = tokens.numel()
        total = 0.0
        for r in range(tokens.shape[0]):
            nll = ref.nll_sum(params, tokens[r:r + 1], labels[r:r + 1],
                              None if feats is None else feats[r:r + 1])
            (nll / n_tok).backward()
            total += float(nll.detach())
        losses.append(total / n_tok)
        with torch.no_grad():
            grads = {k: p.grad for k, p in flat.items()}
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp_max(opt["grad_clip"]
                                    / torch.clamp_min(norm, 1e-9), 1.0)
            lr = lr_at(sched, s + 1)
            c = s + 1
            for k, p in flat.items():
                g = grads[k] * scale
                if s == 0:
                    first[k] = float(torch.linalg.vector_norm(g))
                m[k].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                v[k].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                upd = (m[k] / (1 - opt["b1"] ** c)) / (
                    torch.sqrt(v[k] / (1 - opt["b2"] ** c)) + opt["eps"])
                if opt["weight_decay"] and p.dim() >= opt["decay_min_rank"]:
                    upd = upd + opt["weight_decay"] * p
                p.sub_(lr * upd)
                p.grad = None
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(
            p - initial_leaf(k).to(p.dtype))) for k, p in flat.items()}
    return {"loss": losses, "grad_norm": first, "change_norm": change}
