"""Serving engine: slot-based continuous batching over prefill/decode.

Counterpart of ``repro/serve/engine.py``.  A fixed decode batch of
``n_slots`` sequences shares one cache; requests are admitted into free
slots, every ``step()`` decodes all active slots at once, and finished
sequences free their slot.

* **Coalesced prefill** — admission drains the queue up to the free-slot
  count, groups the drained requests by power-of-two prompt-length bucket
  (floor 8), right-pads each group to its bucket and runs ONE batched
  prefill per group (``last_idx`` picks each row's real last position),
  then scatters the cache rows into their slots with one batched insert.
  Pads sit after each prompt, so causal attention never shows them to a
  real token, and each decode step overwrites the one pad ring slot that
  would otherwise become visible.  A padded prompt never outgrows the
  shortest ring (a sliding window's).  Flash attention, whose chunking
  follows the sequence length, and the recurrent stages (``hyb``,
  ``rwkv``), whose state a pad would advance, group by exact length
  without padding.  Pads go through an MoE router like real tokens and
  take expert capacity, as in the reference.
* **Per-request inputs** — a request's ``extra`` ({"enc_feats"} for
  whisper's encoder, {"vision_embeds"} for internvl's prefix, numpy
  arrays without the batch axis) joins the group key by its sorted keys,
  so a group stacks the same extras; a vision prefix shifts each row's
  last position and the decode positions by ``vision_tokens``, and counts
  against the ring when the engine pads.
* **Batched sampling** — one argmax over all greedy rows and one Gumbel-max
  draw over all temperature rows: at most two device-to-host copies per
  step.  Each temperature sample draws one seed from the engine's host
  ``torch.Generator`` (in FIFO order at admission, slot order at decode —
  the order the serial path uses) and its noise from a device generator
  seeded with it, so the coalesced engine is token-identical to the serial
  (``coalesce=False``) one.

* **On a mesh** — given ``ctx`` (``distributed.make_ctx`` of a
  ``DeviceMesh``), every rank of the mesh runs an engine on the same
  parameters and requests.  Every parameter is a DTensor holding the
  rank's shard (``shard_params``, the "serve" rules), the cache is placed
  by ``cache_shardings`` (batch over the dp axes, heads over "model"),
  the dense layers run as DTensor ops between the reference's hints and
  the MoE layers compute on local shards with their own collectives, all
  over the mesh's process groups (NCCL on the card).  A slot write lands
  on the rank that holds the slot's rows; the logits are gathered whole
  before sampling, so every rank samples the same tokens.

The PPA activation tables come from the shipped JSON (``repro_torch.
tables``), or, given ``table_store=``, resolve through that
``TableStore`` (a table it lacks compiles on the engine's device, and a
tuned config persisted next to it is activated first); on the card the
activations run through the CUDA kernels.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..faults import failpoint
from ..models import (ModelCfg, decode_step, init_cache, make_acts, prefill,
                      prepare_params)
from ..models.common import ShardCtx
from ..models.transformer import RECURRENT_KINDS, ring_len, shard_params
from ..kernels.local import is_dtensor
from ..tree import leaves_with_path, map_trees

__all__ = ["Request", "ServeEngine"]

#: smallest prompt-length bucket; above it buckets double
_BUCKET_FLOOR = 8


def _bucket(n: int, lo: int = _BUCKET_FLOOR) -> int:
    """Smallest power of two >= n, floored at ``lo``."""
    b = lo
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (T,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    extra: Optional[dict] = None       # enc_feats / vision_embeds
    deadline_s: Optional[float] = None  # wall budget from submit()
    tenant: Optional[str] = None       # set by the multi-tenant front
    # filled by the engine:
    output: Optional[List[int]] = None
    done: bool = False
    timed_out: bool = False            # reaped past deadline_s
    rejected: Optional[str] = None     # shed reason ("queue_full")
    t_submit: Optional[float] = None   # perf_counter at submit()
    t_first: Optional[float] = None    # first token emitted (admission)
    t_done: Optional[float] = None     # last token emitted (or shed/reap)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (logits before sampling);
    a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _insert_rows(full, slots: Sequence[int], new, rows: Sequence[int]
                 ) -> None:
    """``full[:, slots] = new[:, rows]`` on a DTensor cache leaf (L, B,
    ...): ``new`` is gathered whole on its batch dim, cut as ``full`` is
    on the others, and each rank writes the slots whose rows it holds into
    its local shard."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, pls = full.device_mesh, full.placements
    if not is_dtensor(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = new.redistribute(mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 1 else p
        for p in pls]).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        full.shape, mesh, pls)
    lo, n = offset[1], shape[1]
    mine = [(s - lo, r) for s, r in zip(slots, rows) if lo <= s < lo + n]
    if not mine:
        return
    loc = full.to_local()
    dev = loc.device
    dst_i = torch.as_tensor([s for s, _ in mine], device=dev)
    src_i = torch.as_tensor([r for _, r in mine], device=src.device)
    loc[:, dst_i] = src[:, src_i].to(loc.dtype)


class ServeEngine:
    def __init__(self, cfg: ModelCfg, params, *, n_slots: int = 4,
                 cache_len: int = 256, ctx: Optional[ShardCtx] = None,
                 rng_seed: int = 0,
                 table_store=None, act_backend: Optional[str] = None,
                 coalesce: bool = True, max_queue: Optional[int] = None,
                 device=None):
        """``params``: the parameter tree (``init_params`` or
        ``params_from_jax``); it is cast to ``cfg.compute_dtype`` and moved
        to ``device`` (None: the card) once, here.  ``table_store``: a
        ``TableStore`` the PPA tables resolve through (None: the shipped
        JSON); the tuned config persisted next to it, if any, is activated
        first and kept as ``tuned``.  ``act_backend`` overrides
        ``cfg.act_backend``.  ``ctx``: a ``ShardCtx`` whose mesh the model
        is sharded over (``make_ctx``): the dense layers tensor-parallel
        (``tp_matmul``), the MoE layers' experts as DTensor shards; every
        rank of the mesh runs an engine on the same params and requests
        (None: one process)."""
        self.device = resolve_device(device)
        if act_backend is not None and act_backend != cfg.act_backend:
            cfg = dataclasses.replace(cfg, act_backend=act_backend)
        self.cfg = cfg
        self.ctx = ctx or ShardCtx()
        self.params = shard_params(prepare_params(params, cfg, self.device),
                                   cfg, self.ctx)
        self.table_store = table_store
        self.tuned = None
        if table_store is not None:
            from ..tune import activate_for_store
            self.tuned = activate_for_store(table_store)
        self.acts = make_acts(cfg.act_impl, cfg.act_backend, self.device,
                              store=table_store)
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.cache = self._place_cache(
            init_cache(cfg, n_slots, cache_len, device=self.device))
        self.pos = np.zeros((n_slots,), np.int32)
        self.cur_tok = np.zeros((n_slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.remaining = np.zeros((n_slots,), np.int32)
        self.rng = torch.Generator()
        self.rng.manual_seed(rng_seed)
        self.queue: Deque[Request] = collections.deque()
        self.max_queue = max_queue
        self.shed = 0                   # rejected at submit (queue_full)
        self.timed_out = 0              # reaped past deadline_s
        self._has_deadlines = False     # skip the reap scan when unused
        self.coalesce = coalesce
        self.prefill_shapes: set = set()    # distinct (len, batch) prefills
        # padding is sound only where no stage carries prompt-order state
        # past the pads (the SSM's conv window and h, RWKV's shifts and S)
        # and chunking does not follow the length (flash); otherwise groups
        # coalesce by exact prompt length, batched and never padded
        self._paddable = cfg.attn_impl == "dense" and not any(
            st.kind in RECURRENT_KINDS for st in cfg.stages)
        # pads must never enter a ring window: a padded prompt longer than
        # the shortest ring would evict real tokens in their favour
        self._min_eff = min(ring_len(st, cache_len) for st in cfg.stages)

    def _place_cache(self, cache: dict) -> dict:
        """The cache as DTensors on the mesh (``cache_shardings``); as it
        is off-mesh."""
        mesh = self.ctx.mesh
        if mesh is None:
            return cache
        from ..distributed.sharding import cache_specs, to_dtensor
        specs = cache_specs(mesh, cache, self.ctx.batch_sharded,
                            self.cfg.kv_shard)
        return map_trees(lambda t, spec: to_dtensor(t, mesh, spec), cache,
                         specs)

    # ----------------------------------------------------------- admission
    def submit(self, req: Request) -> bool:
        """Enqueue ``req``; returns False when load-shed (``max_queue``):
        the request is then finalised at once (``done``, empty output,
        ``rejected="queue_full"``)."""
        req.output = []
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.rejected = "queue_full"
            req.done = True
            req.t_done = time.perf_counter()
            self.shed += 1
            return False
        if req.deadline_s is not None:
            self._has_deadlines = True
        self.queue.append(req)
        return True

    def _reap_deadlines(self) -> int:
        """Expire requests past their deadline; queued ones are dropped,
        active ones free their slot (partial output is kept)."""
        now = time.perf_counter()

        def _expired(r: Request) -> bool:
            return (r.deadline_s is not None and r.t_submit is not None
                    and now - r.t_submit > r.deadline_s)

        n = 0
        if any(_expired(r) for r in self.queue):
            kept: Deque[Request] = collections.deque()
            for r in self.queue:
                if _expired(r):
                    r.timed_out = True
                    r.done = True
                    r.t_done = now
                    n += 1
                else:
                    kept.append(r)
            self.queue = kept
        for i, r in enumerate(self.slot_req):
            if r is not None and _expired(r):
                r.timed_out = True
                r.done = True
                r.t_done = now
                self.slot_req[i] = None
                self.remaining[i] = 0
                n += 1
        self.timed_out += n
        return n

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _bucket_len(self, prompt_len: int) -> int:
        """Padded token length for a prompt (== prompt_len when padding is
        unsound for this config or the bucket, after the vision prefix,
        would overflow a ring: pads must never evict real tokens)."""
        if not self._paddable:
            return prompt_len
        b = _bucket(prompt_len)
        return (prompt_len if self.cfg.vision_tokens + b > self._min_eff
                else b)

    def _draw_seed(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.rng))

    def _admit(self) -> None:
        free = self._free_slots()
        n = min(len(free), len(self.queue))
        if n == 0:
            return
        pairs = [(free[j], self.queue.popleft()) for j in range(n)]
        # seeds in FIFO order: the stream must not depend on grouping
        seeds: Dict[int, int] = {}
        for _, req in pairs:
            if req.temperature > 0:
                seeds[id(req)] = self._draw_seed()
        if not self.coalesce:
            for slot, req in pairs:
                self._admit_group(len(req.prompt), [(slot, req)], seeds)
            return
        groups: Dict[tuple, list] = {}
        for slot, req in pairs:
            sig = (self._bucket_len(len(req.prompt)),
                   tuple(sorted(req.extra)) if req.extra else ())
            groups.setdefault(sig, []).append((slot, req))
        for (blen, _), members in groups.items():
            self._admit_group(blen, members, seeds)

    def _admit_group(self, blen: int, members: Sequence[Tuple[int, Request]],
                     seeds: Dict[int, int]) -> None:
        """One batched prefill for every (slot, request) in ``members``,
        right-padded to ``blen`` tokens, with their extras stacked."""
        g = len(members)
        toks = np.zeros((g, blen), np.int32)
        last = np.zeros((g,), np.int64)
        for j, (_, req) in enumerate(members):
            lp = len(req.prompt)
            toks[j, :lp] = req.prompt
            last[j] = self.cfg.vision_tokens + lp - 1
        self.prefill_shapes.add((blen, g))
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        for k in members[0][1].extra or ():
            batch[k] = torch.as_tensor(
                np.stack([req.extra[k] for _, req in members]),
                device=self.device)
        logits, cache1 = prefill(self.params, self.cfg, batch,
                                 self.cache_len, self.acts,
                                 last_idx=torch.as_tensor(
                                     last, device=self.device),
                                 ctx=self.ctx)
        toks_out = self._sample_rows(
            _whole(logits), [req.temperature for _, req in members],
            [seeds.get(id(req)) for _, req in members])
        self._insert_cache([s for s, _ in members], cache1, range(g))
        for j, (slot, req) in enumerate(members):
            self._start_slot(slot, req, int(toks_out[j]))

    def _start_slot(self, slot: int, req: Request, tok: int) -> None:
        self.pos[slot] = len(req.prompt) + self.cfg.vision_tokens
        self.cur_tok[slot] = tok
        self.remaining[slot] = req.max_new_tokens - 1
        req.output.append(tok)
        req.t_first = time.perf_counter()
        self.slot_req[slot] = req

    def _insert_cache(self, slots: Sequence[int], cache1,
                      rows: Sequence[int]) -> None:
        """Scatter prefill cache rows into slot rows, one batched copy per
        cache leaf (K/V rings, SSM and RWKV states, cross K/V; layout (L, B,
        ...)), each in its own dtype: a reused slot keeps nothing of its
        last request."""
        sl = torch.as_tensor(list(slots), dtype=torch.long,
                             device=self.device)
        rw = torch.as_tensor(list(rows), dtype=torch.long,
                             device=self.device)
        new = dict(leaves_with_path(cache1))
        for path, full in leaves_with_path(self.cache):
            if is_dtensor(full):
                _insert_rows(full, list(slots), new[path], list(rows))
            else:
                full[:, sl] = new[path][:, rw].to(full.dtype)

    # ------------------------------------------------------------ sampling
    def _sample_rows(self, logits: torch.Tensor, temps: Sequence[float],
                     seeds: Sequence[Optional[int]]) -> np.ndarray:
        """One token per logits row (B, V) -> np (B,): greedy rows by one
        argmax, temperature rows by one Gumbel-max over per-row noise."""
        out = np.zeros((len(temps),), np.int64)
        t_rows = [j for j, s in enumerate(seeds) if s is not None]
        if len(t_rows) < len(temps):
            # the tokens must reach the host each step (the requests'
            # outputs, the next step's inputs): sync 1 of at most 2.
            # analysis: allow(host-sync)
            out[:] = torch.argmax(logits, dim=-1).cpu().numpy()
        if t_rows:
            noise = []
            for j in t_rows:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seeds[j])
                u = torch.rand(logits.shape[-1], generator=gen,
                               device=self.device)
                noise.append(-torch.log(-torch.log(u)))
            idx = torch.as_tensor(t_rows, device=self.device)
            tt = torch.as_tensor([temps[j] for j in t_rows],
                                 dtype=torch.float32, device=self.device)
            scores = (logits[idx].to(torch.float32) / tt[:, None]
                      + torch.stack(noise))
            # sync 2 of at most 2: every sampled row in one copy.
            # analysis: allow(host-sync)
            out[t_rows] = torch.argmax(scores, dim=-1).cpu().numpy()
        return out

    # ---------------------------------------------------------------- step
    def _no_grad(self):
        """``inference_mode``, or ``no_grad`` on a mesh: a DTensor view of
        a parameter made outside inference mode cannot be taken inside
        it."""
        return (torch.inference_mode() if self.ctx.mesh is None
                else torch.no_grad())

    def step(self) -> int:
        """Admit pending requests, decode one token for every active slot.
        Returns the number of active sequences stepped."""
        with self._no_grad():
            return self._step()

    def _step(self) -> int:
        failpoint("serve.decode.step")
        if self._has_deadlines:
            self._reap_deadlines()
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        toks = torch.as_tensor(self.cur_tok[:, None], device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.cache = decode_step(self.params, self.cfg, self.cache,
                                         toks, pos, self.acts, self.ctx)
        logits = _whole(logits)
        temps: List[float] = []
        seeds: List[Optional[int]] = []
        for i in active:
            t = self.slot_req[i].temperature
            temps.append(t)
            seeds.append(self._draw_seed() if t > 0 else None)
        sampled = self._sample_rows(
            logits[torch.as_tensor(active, device=self.device)], temps, seeds)
        nxt = np.zeros((self.n_slots,), np.int32)
        now = time.perf_counter()
        for j, i in enumerate(active):
            req = self.slot_req[i]
            tok = int(sampled[j])
            nxt[i] = tok
            req.output.append(tok)
            self.pos[i] += 1
            self.remaining[i] -= 1
            if self.remaining[i] <= 0:
                req.done = True
                req.t_done = now
                self.slot_req[i] = None
        self.cur_tok = nxt
        return len(active)

    # -------------------------------------------------------------- warmup
    def warmup(self, prompt_lens: Sequence[int] = (), *, batch: int = 1,
               decode: bool = True) -> int:
        """Run one prefill per bucketed prompt length (zero extras) and one
        decode step on scratch state (the engine's cache and queue are
        untouched), so first-use costs (kernel builds, library handles) are
        paid here.  Returns the number of runs."""
        with self._no_grad():
            return self._warmup(prompt_lens, batch, decode)

    def _warmup(self, prompt_lens, batch, decode) -> int:
        cfg, n = self.cfg, 0
        for lp in prompt_lens:
            blen = self._bucket_len(lp)
            feed = {"tokens": torch.zeros((batch, blen), dtype=torch.int32,
                                          device=self.device)}
            if cfg.enc_layers:
                feed["enc_feats"] = torch.zeros(
                    (batch, cfg.enc_seq, cfg.d_model), device=self.device)
            if cfg.vision_tokens:
                feed["vision_embeds"] = torch.zeros(
                    (batch, cfg.vision_tokens, cfg.d_model),
                    device=self.device)
            last = torch.full((batch,), cfg.vision_tokens + min(lp, blen) - 1,
                              dtype=torch.long, device=self.device)
            prefill(self.params, cfg, feed, self.cache_len, self.acts,
                    last_idx=last, ctx=self.ctx)
            n += 1
        if decode:
            scratch = self._place_cache(init_cache(
                self.cfg, self.n_slots, self.cache_len, device=self.device))
            decode_step(self.params, self.cfg, scratch,
                        torch.zeros((self.n_slots, 1), dtype=torch.int32,
                                    device=self.device),
                        torch.zeros((self.n_slots,), dtype=torch.int32,
                                    device=self.device), self.acts,
                        self.ctx)
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    def stats(self) -> Dict[str, int]:
        """Load and health counters."""
        return {
            "queue_depth": len(self.queue),
            "active_slots": sum(r is not None for r in self.slot_req),
            "n_slots": self.n_slots,
            "max_queue": self.max_queue if self.max_queue is not None else -1,
            "shed": self.shed,
            "timed_out": self.timed_out,
            "prefill_shapes": len(self.prefill_shapes),
        }

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                return
