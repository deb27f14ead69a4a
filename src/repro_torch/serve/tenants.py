"""Multi-tenant serving front: many deployments, one warm TableStore.

A copy of the JAX package's ``serve/tenants.py`` for the port.  The GRAU
view of the paper — one reconfigurable PPA unit serving many functions —
maps at the serving tier onto one :class:`TableStore` serving many tenant
NAF zoos.  A :class:`TenantSpec` names a deployment (model config +
activation impl/bit-widths + execution backend); admitting it through
:meth:`TenantFront.add_tenant` runs the warm-up step:

* every table in the tenant's NAF zoo (``repro_torch.models.
  ppa_table_jobs``) is resolved through the shared store via
  ``compile_or_load`` (a miss compiles on the front's device) and
  **pinned** — exempt from the memory-tier LRU, so other tenants' churn
  can never push a live deployment's tables out of the dict tier;
* the tenant's engine runs one prefill per warm prompt length and one
  decode step (``ServeEngine.warmup``), so the first request pays neither
  kernel builds nor table resolution.

A tenant admitted with ``warm=False`` is *cold*: nothing is built until
its first request is admitted, which then pays bundle construction (table
loads, packing) and first-use costs inline — the case warm admission is
measured against.

Requests enter through :meth:`submit` tagged by tenant and are
fair-shared: each scheduling pass hands every tenant with backlog one
admission in rotating round-robin order, bounded by the per-engine free
slots and the optional global ``max_active`` budget (tenants sharing one
card), so one chatty tenant cannot starve the rest.

**Fault isolation.**  A tenant whose warm-up or lazy engine build raises
is *degraded*, never fatal to the front: its partial table pins are
rolled back and — when the spec opts in via ``fallback_exact`` — it is
re-admitted on the float (``act_impl="exact"``) bundle, still serving;
otherwise its requests are rejected with ``rejected="tenant_degraded"``.
Either way the other tenants' engines, pins and RNG streams are never
touched, so their outputs stay token-identical to a fault-free run.  The
catch takes every exception, a failed kernel build included: a caller
that must not serve a tenant on exact floats unasked checks ``degraded``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

from ..compiler import CompileJob, TableStore
from ..core.searchspace import TorchSearchBackend
from ..device import resolve_device
from ..faults import failpoint
from ..models import ModelCfg, ppa_table_jobs

from .engine import Request, ServeEngine

__all__ = ["TenantSpec", "TenantFront"]


@dataclasses.dataclass
class TenantSpec:
    """One deployment: model + NAF zoo/bit-widths (via ``cfg.act_impl``)
    + activation execution backend, served from a shared table store."""

    name: str
    cfg: ModelCfg
    params: Any
    n_slots: int = 4
    cache_len: int = 256
    act_backend: Optional[str] = None
    rng_seed: int = 0
    #: prompt-length buckets to warm at admission (warm tenants)
    warm_prompt_lens: Sequence[int] = (8,)
    #: on warm/build failure, re-admit on the float (``act_impl="exact"``)
    #: bundle instead of rejecting the tenant's requests
    fallback_exact: bool = False


class TenantFront:
    def __init__(self, table_store: Optional[TableStore] = None, *,
                 max_active: Optional[int] = None, device=None):
        """``device``: where every tenant's engine runs and where a table
        missing from the store compiles (None: the card)."""
        self.store = table_store if table_store is not None else TableStore()
        self.max_active = max_active
        self.device = resolve_device(device)
        self.specs: Dict[str, TenantSpec] = {}
        self.engines: Dict[str, ServeEngine] = {}
        self.pending: Dict[str, Deque[Request]] = {}
        self.warmups: Dict[str, dict] = {}
        self._rr: List[str] = []        # rotating fair-share order
        self.degraded: Dict[str, str] = {}      # tenant -> reason
        # per-tenant pinned jobs, so degrade/remove roll back exactly the
        # pins THIS tenant holds (never another tenant's refcounts)
        self._pins: Dict[str, List[CompileJob]] = {}

    # ------------------------------------------------------------ tenants
    def add_tenant(self, spec: TenantSpec, *, warm: bool = True) -> dict:
        """Register a tenant; with ``warm`` run the warm-up step now.

        Returns the warm-up report: tables pinned, warm-up runs, and wall
        seconds spent — the cost the tenant's first request will NOT
        pay."""
        if spec.name in self.specs:
            raise ValueError(f"tenant {spec.name!r} already admitted")
        self.specs[spec.name] = spec
        self.pending[spec.name] = collections.deque()
        self._pins[spec.name] = []
        self._rr.append(spec.name)
        t0 = time.perf_counter()
        pinned = traces = 0
        if warm:
            try:
                failpoint("serve.tenant.warm", tenant=spec.name)
                for naf, fcfg, scheme in ppa_table_jobs(spec.cfg.act_impl):
                    self.store.compile_or_load(
                        naf, fcfg, scheme,
                        search_backend=TorchSearchBackend(self.device))
                    job = CompileJob(naf=naf, cfg=fcfg, scheme=scheme)
                    self.store.pin(job)
                    self._pins[spec.name].append(job)
                    pinned += 1
                eng = self._build_engine(spec)
                traces = eng.warmup(spec.warm_prompt_lens)
            except Exception as e:      # noqa: BLE001 — isolate, never fatal
                self._degrade(spec.name, f"warmup failed: {e!r}")
                pinned, traces = len(self._pins[spec.name]), 0
        report = {"tenant": spec.name, "warm": warm,
                  "tables_pinned": pinned, "warm_traces": traces,
                  "degraded": self.degraded.get(spec.name),
                  "warmup_s": round(time.perf_counter() - t0, 4)}
        self.warmups[spec.name] = report
        return report

    # -------------------------------------------------------- fault walls
    def _degrade(self, name: str, reason: str) -> None:
        """Wall off a failing tenant without disturbing its neighbours.

        Rolls back exactly the pins this tenant holds and drops its
        (possibly half-built) engine.  With ``fallback_exact`` the tenant
        is re-admitted on the float bundle — no PPA tables, no custom
        backend — and keeps serving; otherwise its queued requests are
        rejected and future submits bounce (``rejected="tenant_degraded"``).
        """
        spec = self.specs[name]
        for job in self._pins.pop(name, []):
            try:
                self.store.unpin(job)
            except Exception:           # noqa: BLE001 — best-effort rollback
                pass
        self._pins[name] = []
        self.engines.pop(name, None)
        if spec.fallback_exact and spec.cfg.act_impl != "exact":
            self.specs[name] = dataclasses.replace(
                spec, cfg=spec.cfg.replace(act_impl="exact",
                                           act_backend="ref"),
                act_backend=None, fallback_exact=False)
            self.degraded[name] = f"fallback-exact: {reason}"
            return
        self.degraded[name] = reason
        self._reject_pending(name)

    def _reject_pending(self, name: str) -> None:
        now = time.perf_counter()
        for req in self.pending[name]:
            req.output = req.output or []
            req.rejected = "tenant_degraded"
            req.done = True
            req.t_done = now
        self.pending[name].clear()

    def _serving(self, name: str) -> bool:
        """Degraded-without-fallback tenants are walled off; everyone
        else (healthy or serving on the exact fallback) admits work."""
        return not (name in self.degraded and
                    not self.degraded[name].startswith("fallback-exact"))

    def remove_tenant(self, name: str) -> None:
        """Retire a tenant: unpin its table set and drop its engine.

        Refuses while the tenant still has queued or in-flight work."""
        eng = self.engines.get(name)
        busy = bool(self.pending[name]) or (eng is not None and (
            eng.queue or any(r is not None for r in eng.slot_req)))
        if busy:
            raise RuntimeError(f"tenant {name!r} still has work in flight")
        for job in self._pins.pop(name, []):
            self.store.unpin(job)
        self.engines.pop(name, None)
        self.pending.pop(name)
        self.specs.pop(name)
        self.degraded.pop(name, None)
        self._rr.remove(name)

    def _build_engine(self, spec: TenantSpec) -> ServeEngine:
        failpoint("serve.tenant.build", tenant=spec.name)
        eng = ServeEngine(spec.cfg, spec.params, n_slots=spec.n_slots,
                          cache_len=spec.cache_len, table_store=self.store,
                          act_backend=spec.act_backend,
                          rng_seed=spec.rng_seed, device=self.device)
        self.engines[spec.name] = eng
        return eng

    def _engine(self, name: str) -> ServeEngine:
        """The tenant's engine — built on first touch for cold tenants
        (this is where a cold deployment pays its construction cost)."""
        eng = self.engines.get(name)
        if eng is None:
            eng = self._build_engine(self.specs[name])
        return eng

    # ----------------------------------------------------------- requests
    def submit(self, tenant: str, req: Request) -> bool:
        """Queue ``req`` for ``tenant``; False when the tenant is walled
        off (degraded without fallback) — the request is finalised with
        ``rejected="tenant_degraded"`` instead of hanging forever."""
        if tenant not in self.specs:
            raise KeyError(f"unknown tenant {tenant!r}")
        req.tenant = tenant
        req.t_submit = time.perf_counter()
        if not self._serving(tenant):
            req.output = req.output or []
            req.rejected = "tenant_degraded"
            req.done = True
            req.t_done = req.t_submit
            return False
        self.pending[tenant].append(req)
        return True

    def active_slots(self) -> int:
        """Occupied slots plus engine-queued requests across tenants."""
        return sum(sum(r is not None for r in e.slot_req) + len(e.queue)
                   for e in self.engines.values())

    def _fair_admit(self) -> None:
        """Move pending requests into tenant engines, one per tenant per
        pass in rotating round-robin order, bounded by each engine's free
        slots and the global ``max_active`` budget."""
        budget = (None if self.max_active is None
                  else self.max_active - self.active_slots())
        progressed = True
        while progressed and (budget is None or budget > 0):
            progressed = False
            for name in list(self._rr):
                if budget is not None and budget <= 0:
                    break
                q = self.pending[name]
                if not q:
                    continue
                try:
                    # where a cold tenant's lazy engine build can fail —
                    # degrade it (fallback or reject) and keep scheduling
                    # the other tenants untouched
                    eng = self._engine(name)
                except Exception as e:  # noqa: BLE001 — isolate, never fatal
                    self._degrade(name, f"engine build failed: {e!r}")
                    progressed = True   # pending changed (rejected/kept)
                    continue
                free = (eng.n_slots
                        - sum(r is not None for r in eng.slot_req)
                        - len(eng.queue))
                if free <= 0:
                    continue
                eng.submit(q.popleft())
                progressed = True
                if budget is not None:
                    budget -= 1
        if self._rr:                    # rotate first pick across calls
            self._rr.append(self._rr.pop(0))

    # --------------------------------------------------------------- step
    def step(self) -> int:
        """One scheduling pass: fair-share admission, then one decode
        step for every engine with work.  Returns sequences stepped."""
        self._fair_admit()
        total = 0
        for eng in self.engines.values():
            if eng.queue or any(r is not None for r in eng.slot_req):
                total += eng.step()
        return total

    def stats(self) -> Dict[str, Any]:
        """Front-wide health: per-tenant engine stats plus degradations."""
        return {
            "tenants": sorted(self.specs),
            "degraded": dict(self.degraded),
            "pending": {n: len(q) for n, q in self.pending.items()},
            "engines": {n: e.stats() for n, e in self.engines.items()},
        }

    @property
    def drained(self) -> bool:
        return (all(not q for q in self.pending.values()) and
                all(not e.queue and all(r is None for r in e.slot_req)
                    for e in self.engines.values()))

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            self.step()
            if self.drained:
                return
        raise RuntimeError("tenant front did not drain")
