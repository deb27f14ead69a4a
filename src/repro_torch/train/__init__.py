"""repro_torch.train — optimizers, the schedule and the train step."""

from .optimizer import OptCfg, clip_grads, global_norm, opt_init, opt_update
from .schedule import ScheduleCfg, lr_at
from .train_step import TrainCfg, make_train_step, train_init

__all__ = ["OptCfg", "clip_grads", "global_norm", "opt_init", "opt_update",
           "ScheduleCfg", "lr_at", "TrainCfg", "make_train_step",
           "train_init"]
