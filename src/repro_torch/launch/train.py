"""Training driver with checkpoint/restart fault tolerance, on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --steps 200 --smoke            # reduced config
  ... --resume auto                  # restart from latest checkpoint
  ... --device cpu                   # the kernels' plain versions, on CPU

Counterpart of ``repro/launch/train.py``, with its flags:
  * deterministic synthetic data keyed by step (restart-exact)
  * atomic checkpoints of params + optimizer state + step
  * watchdog straggler/hang detection around every step
  * --simulate-crash-at N: hard-exit mid-run to prove restart works
Weights are random (seed 0), float32 master parameters
(``cfg.param_dtype``) computed in ``cfg.compute_dtype``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from ..checkpoint import latest_step, restore, save
from ..configs import get_config, get_smoke_config
from ..data import SyntheticLM
from ..device import resolve_device
from ..models import init_params, make_acts, param_specs
from ..models.transformer import dtype_of
from ..roofline import OpCosts
from ..runtime import MetricsLogger, Watchdog
from ..train import OptCfg, ScheduleCfg, TrainCfg, make_train_step, \
    train_init

__all__ = ["run_training", "main"]


def run_training(cfg, *, steps: int, ckpt_dir: str, resume: str = "auto",
                 ckpt_every: int = 50, batch_override: int = 0,
                 seq_override: int = 0, lr: float = 3e-4,
                 opt_kind: str = "adamw", accum: int = 1,
                 simulate_crash_at: int = -1, metrics_path=None,
                 log_every: int = 10, device=None, sched=None,
                 costs_step: Optional[int] = None):
    """Train ``cfg`` for ``steps`` steps on ``device`` (None: the card).
    ``sched`` overrides the schedule (default: the reference launcher's,
    peak ``lr``, 20 warmup steps).  Returns {"losses", "grad_norms",
    "param_norms", "stragglers", "final_loss", "step_s"} (``param_norms``:
    each step's after its update; ``step_s``: each step's
    seconds, measured around a step that ends with its metrics on the
    host).  ``costs_step``: a step run under an ``OpCosts`` counter (its
    time includes the counting), whose costs come back as "costs"."""
    dev = resolve_device(device)
    seq = seq_override or 512
    gbatch = batch_override or 8
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=gbatch)

    tcfg = TrainCfg(opt=OptCfg(kind=opt_kind),
                    sched=sched or ScheduleCfg(peak_lr=lr, warmup_steps=20,
                                               decay_steps=max(steps, 100)),
                    accum_steps=accum)
    params = init_params(param_specs(cfg), 0, dtype_of(cfg.param_dtype),
                         device=dev)
    tstate = train_init(tcfg, params)

    start = 0
    if resume == "auto":
        last = latest_step(ckpt_dir)
        if last is not None:
            (params, tstate), extra = restore(ckpt_dir, last,
                                              (params, tstate))
            start = int(extra["next_step"])
            print(f"[resume] from checkpoint step {last} -> step {start}")

    step_fn = make_train_step(cfg, tcfg, make_acts(cfg.act_impl,
                                                   cfg.act_backend, dev))
    wd = Watchdog(min_deadline_s=600.0)
    logger = MetricsLogger(metrics_path)
    losses, grad_norms, param_norms, step_s = [], [], [], []
    costs = None

    for step in range(start, steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch_at(step).items()}
        t0 = time.perf_counter()
        if step == costs_step:
            with OpCosts() as costs:
                params, tstate, metrics = wd.step(step_fn, params, tstate,
                                                  batch)
        else:
            params, tstate, metrics = wd.step(step_fn, params, tstate, batch)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        param_norms.append(float(metrics["param_norm"]))
        if step % log_every == 0 or step == steps - 1:
            logger.log(step, **metrics)
            # the metrics themselves: the logger's record holds None for a
            # value that is not finite
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} gnorm {grad_norms[-1]:.3f}")
        if simulate_crash_at == step:
            print(f"[crash] simulated crash at step {step} (post-update, "
                  "pre-checkpoint)")
            sys.exit(42)
        if ckpt_every and (step + 1) % ckpt_every == 0:
            save(ckpt_dir, step + 1, (params, tstate),
                 extra={"next_step": step + 1, "loss": losses[-1]})
    if steps > start and ckpt_dir:
        save(ckpt_dir, steps, (params, tstate),
             extra={"next_step": steps, "loss": losses[-1]})
    return {"losses": losses, "grad_norms": grad_norms,
            "param_norms": param_norms, "stragglers": wd.stragglers,
            "final_loss": losses[-1] if losses else None, "step_s": step_s,
            "costs": costs}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt", default="adamw",
                    choices=["sgdm", "adamw", "adamw8", "adafactor"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--act-impl", default=None,
                    choices=[None, "exact", "ppa", "ppa8"])
    ap.add_argument("--simulate-crash-at", type=int, default=-1)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.act_impl:
        cfg = cfg.replace(act_impl=args.act_impl)
    out = run_training(
        cfg, steps=args.steps, ckpt_dir=args.ckpt_dir, resume=args.resume,
        ckpt_every=args.ckpt_every, batch_override=args.batch,
        seq_override=args.seq, lr=args.lr, opt_kind=args.opt,
        accum=args.accum, simulate_crash_at=args.simulate_crash_at,
        metrics_path=args.metrics, device=device)
    print(f"done: final loss {out['final_loss']:.4f} "
          f"(stragglers: {out['stragglers']})")
    return out


if __name__ == "__main__":
    main()
