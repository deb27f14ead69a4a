"""The training runner: one train step object, built once, driven from the
seed through its first ``check_steps`` steps in set-up (the check's steps,
which also warm up every shape), then through the measured window.

Each step is the program's ``train_step`` on the traffic's next batch; it
returns once its metrics are on the host, so the host clock around it
spans the device's work.  After the window the program is freed and the
reference follows the same first steps from the same weights and
batches.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from ..reference.model import Precision, strict_float32
from ..reference.train import follow
from .checks import train_numbers
from .program import check_tree, model_cfg
from .traffic import train_batch
from .weights import draw_leaf, draw_tree, get_path, tree_paths

__all__ = ["TrainRun"]


class TrainRun:
    kind = "train"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.model, self.traffic = cell.config["model"], cell.traffic
        self.i = 0                       # the next step's batch index
        self.steps: List[dict] = []
        self.losses: List[float] = []
        self.failed = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from repro_torch.models import make_acts
        from repro_torch.train import (OptCfg, ScheduleCfg, TrainCfg,
                                       make_train_step, train_init)

        conf, t = self.cell.config, self.traffic
        cfg = model_cfg(conf)
        check_tree(conf, cfg)
        o, s = t["optimizer"], t["schedule"]
        if o["kind"] != "adamw" or o["decay_min_rank"] != 2:
            raise ValueError("the program's optimizer is adamw, decaying "
                             "leaves of rank 2 and more")
        self.tcfg = TrainCfg(
            opt=OptCfg(kind="adamw", b1=o["b1"], b2=o["b2"], eps=o["eps"],
                       weight_decay=o["weight_decay"]),
            sched=ScheduleCfg(peak_lr=s["peak_lr"],
                              warmup_steps=s["warmup_steps"],
                              decay_steps=s["decay_steps"],
                              min_ratio=s["min_ratio"]),
            grad_clip=o["grad_clip"])
        acts = make_acts(cfg.act_impl, cfg.act_backend, self.device)
        self.params = draw_tree(self.model, self.seed, self.device)
        self.tstate = train_init(self.tcfg, self.params)
        self.step_fn = make_train_step(cfg, self.tcfg, acts, self.device)
        b1 = self.tcfg.opt.b1
        for k in range(t["check_steps"]):
            self.one()
            if k == 0:
                mu = self.tstate["opt"]["mu"]
                self.grad_norm = {
                    p: float(torch.linalg.vector_norm(
                        get_path(mu, p)["m"])) / (1 - b1)
                    for p in tree_paths(self.model)}
        self.change_norm = self._change()
        self.check_losses = list(self.losses)
        self.steps.clear()

    @torch.no_grad()
    def _change(self) -> Dict[str, float]:
        return {p: float(torch.linalg.vector_norm(
            get_path(self.params, p)
            - draw_leaf(self.model, p, self.seed, self.device)))
            for p in tree_paths(self.model)}

    def batch(self, i: int) -> dict:
        return train_batch(self.model, self.traffic, self.seed, i,
                           self.device)

    # ------------------------------------------------------------- steps
    def one(self) -> dict:
        """The next step: the window's call and feed."""
        t0 = time.perf_counter()
        batch = self.batch(self.i)
        self.params, self.tstate, met = self.step_fn(self.params,
                                                     self.tstate, batch)
        t1 = time.perf_counter()
        loss = float(met["loss"])
        if not torch.isfinite(met["loss"]):
            self.failed += 1
        self.losses.append(loss)
        self.i += 1
        rec = {"t0": t0, "t1": t1,
               "tokens": self.traffic["batch"] * self.traffic["seq"]}
        self.steps.append(rec)
        return rec

    def window(self, seconds: float) -> dict:
        self.steps.clear()
        t_open = time.perf_counter()
        while True:
            rec = self.one()
            if rec["t1"] - t_open >= seconds:
                break
        return {"t_open": t_open, "t_close": rec["t1"]}

    @property
    def attempted(self) -> int:
        return len(self.steps)

    def release(self) -> None:
        del self.params, self.tstate, self.step_fn

    # ------------------------------------------------------------- check
    def reference(self, prec: Precision = Precision(), rows=None) -> dict:
        """The reference's readings (the control's with ``prec``) of the
        check steps, from the same weights and batches (their first
        ``rows`` rows only: a fault planted in the reference)."""
        strict_float32()
        params = draw_tree(self.model, self.seed, self.device)

        def batch_at(i):
            return {k: v[:rows] for k, v in self.batch(i).items()}
        return follow(self.model, self.traffic, params, batch_at,
                      lambda p: draw_leaf(self.model, p, self.seed,
                                          self.device),
                      self.traffic["check_steps"], self.device, prec)

    def program_readings(self) -> dict:
        return {"loss": self.check_losses, "grad_norm": self.grad_norm,
                "change_norm": self.change_norm}

    def numbers(self) -> Dict[str, float]:
        return train_numbers(self.program_readings(), self.reference())

    def record(self) -> dict:
        return {"work": {"rows": self.traffic["batch"],
                         "seq": self.traffic["seq"],
                         "enc": self.traffic.get("enc_frames", 0)}}
