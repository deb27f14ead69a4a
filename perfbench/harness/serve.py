"""The serving runner: one ``ServeEngine`` on weights drawn in the served
dtype, a closed loop of ``clients`` clients, each sending its next request
as soon as its last one finished.

Set-up warms the engine's prefill at every prompt bucket the pool can
send and its decode step, then runs ``warmup_steps`` steps of the loop, so
the window opens on a full engine.  The harness stamps every token when
the ``step()`` that emitted it returns, and a request's submission when
it calls ``submit()``, on its own clock.  Requests submitted before the
window open enter no tail.  After the window it steps on until every
request submitted inside it has its first token.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference.serve import served_gaps
from ..reference.model import strict_float32
from .program import check_tree, model_cfg
from .traffic import length_pool, requests
from .weights import draw_tree

__all__ = ["ServeRun"]


class _Client:
    __slots__ = ("req", "stamps", "t_submit", "prompt_len", "n_seen")

    def __init__(self, req, t_submit):
        self.req, self.t_submit = req, t_submit
        self.prompt_len = len(req.prompt)
        self.stamps: List[float] = []
        self.n_seen = 0


class ServeRun:
    kind = "serve"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.model, self.traffic = cell.config["model"], cell.traffic
        self.steps: List[dict] = []
        self.done: List[_Client] = []
        self.failed = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from repro_torch.serve import Request, ServeEngine

        conf, t = self.cell.config, self.traffic
        cfg = model_cfg(conf)
        check_tree(conf, cfg)
        self.Request = Request
        self.weights = draw_tree(self.model, self.seed, self.device,
                                 dtype=torch.bfloat16)
        self.engine = ServeEngine(cfg, self.weights, n_slots=t["slots"],
                                  cache_len=t["cache_len"],
                                  device=self.device)
        prompts, _ = length_pool(t)
        self.engine.warmup(sorted({self.engine._bucket_len(int(n))
                                   for n in prompts}), batch=1)
        self.source = requests(self.model, t, self.seed)
        self.next_rid = 0
        self.live: List[_Client] = []
        for _ in range(t["clients"]):
            self._submit()
        for _ in range(t["warmup_steps"]):
            self.one()
        self.steps.clear()
        self.done.clear()

    def _submit(self) -> None:
        prompt, n_out = next(self.source)
        req = self.Request(rid=self.next_rid, prompt=prompt,
                           max_new_tokens=n_out)
        self.next_rid += 1
        c = _Client(req, time.perf_counter())
        req.t_submit = c.t_submit
        if not self.engine.submit(req):
            self.failed += 1
        self.live.append(c)

    # ------------------------------------------------------------- steps
    def one(self) -> dict:
        """One engine step, its tokens stamped, finished clients' next
        requests sent."""
        t0 = time.perf_counter()
        self.engine.step()
        t1 = time.perf_counter()
        prefill: List[int] = []
        decode: List[int] = []
        still: List[_Client] = []
        finished = 0
        for c in self.live:
            out = c.req.output
            for k in range(c.n_seen, len(out)):
                c.stamps.append(t1)
                if k == 0:
                    prefill.append(c.prompt_len)
                else:
                    decode.append(c.prompt_len + k)
            c.n_seen = len(out)
            if c.req.done:
                if c.req.rejected or c.req.timed_out:
                    self.failed += 1
                self.done.append(c)
                finished += 1
            else:
                still.append(c)
        self.live = still
        for _ in range(finished):
            self._submit()
        rec = {"t0": t0, "t1": t1, "prefill": prefill, "decode": decode,
               "admitted": len(prefill)}
        self.steps.append(rec)
        return rec

    def window(self, seconds: float) -> dict:
        self.steps.clear()
        self.done.clear()
        t_open = time.perf_counter()
        while True:
            rec = self.one()
            if rec["t1"] - t_open >= seconds:
                break
        t_close = rec["t1"]
        self.window_clients = [c for c in self.live + self.done
                               if t_open <= c.t_submit < t_close]
        self.finished = [c for c in self.done
                         if t_open <= c.stamps[-1] <= t_close]
        win_steps = list(self.steps)
        while any(not c.stamps for c in self.window_clients):
            self.one()
        self.steps = win_steps
        return {"t_open": t_open, "t_close": t_close}

    @property
    def attempted(self) -> int:
        return len(self.window_clients)

    def release(self) -> None:
        self.sample = self._sample()
        del self.engine

    def _sample(self) -> list:
        """A sample drawn from the seed of the requests the window
        finished, the longest among them."""
        fin = self.finished
        if not fin:
            return []
        n = min(self.traffic["sample_requests"], len(fin))
        longest = max(range(len(fin)), key=lambda j: (
            fin[j].prompt_len + len(fin[j].req.output), -j))
        rng = np.random.default_rng([int(self.seed), 3])
        rest = [j for j in rng.permutation(len(fin)) if j != longest]
        pick = [longest] + rest[:n - 1]
        return [(fin[j].req.prompt, list(fin[j].req.output)) for j in pick]

    # ------------------------------------------------------------- check
    def numbers(self, control: bool = False) -> Dict[str, Optional[float]]:
        strict_float32()
        if not self.sample:
            return {"served_gap": None}
        gap, n = served_gaps(self.model, self.weights, self.sample,
                             self.device, control=control)
        self.compared_tokens = n
        return {"served_gap": gap}

    def record(self) -> dict:
        return {"requests": [
            {"t_submit": c.t_submit, "stamps": c.stamps,
             "prompt_len": c.prompt_len} for c in self.window_clients]}
