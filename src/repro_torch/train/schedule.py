"""Learning-rate schedule: a copy of ``repro/train/schedule.py``."""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ScheduleCfg", "lr_at"]


@dataclasses.dataclass(frozen=True)
class ScheduleCfg:
    """Warmup-then-cosine schedule.

    Defaults are sized for the substrate loop (tests, examples, smoke
    runs): the default config must actually learn within tens of steps,
    so warmup is short and the peak is toy-model-scale.  Production
    launches size their own schedule (see launch/train.py).
    """

    peak_lr: float = 3e-3
    warmup_steps: int = 5
    decay_steps: int = 10_000
    min_ratio: float = 0.1


def lr_at(cfg: ScheduleCfg, step) -> torch.Tensor:
    """The rate at ``step`` as a 0-dim float32 CPU tensor, computed in
    float32 in the reference's order.  The train step asks for
    ``step + 1``: ``lr_at(cfg, 0)`` is 0."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = s / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1.0, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_ratio + (1 - cfg.min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(s < cfg.warmup_steps, warm, cos)
