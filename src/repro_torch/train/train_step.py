"""The training step: loss -> grads -> clip -> optimizer.

Counterpart of ``repro/train/train_step.py``.  Microbatch gradient
accumulation sums the float32 gradients of each microbatch in a Python
loop (the reference's ``lax.scan``, the same arithmetic), so peak
activation memory is one microbatch's.  The step returns once its metrics
are on the host, so a caller's clock around it (the watchdog) times the
device's work, not the launches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import ActBundle, ModelCfg, loss_fn, make_acts
from ..models.common import on_mesh
from ..tree import leaves, map_tree, map_trees
from .optimizer import OptCfg, clip_grads, global_norm, opt_init, opt_update
from .schedule import ScheduleCfg, lr_at

__all__ = ["TrainCfg", "loss_and_grads", "make_train_step", "train_init"]

_METRICS = ("loss", "grad_norm", "lr", "param_norm")


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    opt: OptCfg = OptCfg()
    sched: ScheduleCfg = ScheduleCfg()
    grad_clip: float = 1.0
    accum_steps: int = 1


def train_init(tcfg: TrainCfg, params):
    opt = opt_init(tcfg.opt, params)
    return {"step": torch.zeros((), dtype=torch.int32,
                                device=opt["count"].device), "opt": opt}


def loss_and_grads(cfg: ModelCfg, acts: ActBundle, params, batch,
                   ctx=None):
    """(loss, gradient tree) of :func:`~repro_torch.models.loss_fn` at
    ``params``, whose leaves it leaves untouched.  ``ctx``: a mesh (the
    params and batch DTensors), or None."""
    leaf = map_tree(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = loss_fn(leaf, cfg, batch, acts, ctx)
    with on_mesh(ctx):
        it = iter(torch.autograd.grad(loss, leaves(leaf)))
    return loss.detach(), map_tree(lambda _: next(it), leaf)


def make_train_step(cfg: ModelCfg, tcfg: TrainCfg,
                    acts: Optional[ActBundle] = None, device=None):
    """``train_step(params, tstate, batch) -> (params, tstate, metrics)``.
    ``acts`` defaults to the config's bundle on ``device`` (None: the
    card).  Params and optimizer state are updated in place; ``batch``
    holds (B, T) int tensors on the params' device; the metrics (loss,
    grad_norm, lr, param_norm) are 0-dim float32 CPU tensors."""
    acts = acts or make_acts(cfg.act_impl, cfg.act_backend, device)

    def train_step(params, tstate, batch):
        n = tcfg.accum_steps
        if n == 1:
            loss, grads = loss_and_grads(cfg, acts, params, batch)
        else:
            for v in batch.values():
                if v.shape[0] % n:
                    raise ValueError(f"batch {v.shape[0]} does not split "
                                     f"into {n} microbatches")
            g_sum = map_tree(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            l_sum = torch.zeros((), dtype=torch.float32,
                                device=tstate["step"].device)
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = loss_and_grads(cfg, acts, params, mb)
                g_sum = map_trees(lambda a, b: a + b.to(a.dtype), g_sum, g)
                l_sum = l_sum + l
            grads = map_tree(lambda g: g / n, g_sum)
            loss = l_sum / n

        grads, gnorm = clip_grads(grads, tcfg.grad_clip)
        # 1-indexed: lr_at(cfg, 0) == 0, so the update producing state
        # step+1 takes the step+1 rate -- the first step is never a zero-lr
        # no-op that only pollutes the optimizer moments.
        lr = lr_at(tcfg.sched, int(tstate["step"]) + 1)
        params, opt = opt_update(tcfg.opt, grads, tstate["opt"], params, lr)
        del grads
        tstate = {"step": tstate["step"] + 1, "opt": opt}
        vals = torch.stack([loss, gnorm, lr.to(loss.device),
                            global_norm(params)]).cpu()
        return params, tstate, dict(zip(_METRICS, vals.unbind()))

    return train_step
