"""Multi-config batch compilation driver.

Independent (naf, cfg, scheme) compile jobs have no shared state — the
paper's design-space sweeps (Tables I-VII), the model-activation warmup and
the FWL-search design points are all embarrassingly parallel — so the batch
driver fans them out across worker processes and lands every result in the
table store.  Jobs already present in the store are never recompiled.

Results cross the process boundary as ``PPATable.to_json`` strings (the
same serialization as the disk tier), so workers need nothing but the job
tuple.  The pool's workers are *spawned*, never forked: a child forked
after its parent touched CUDA cannot use the card, and each spawned worker
makes its own CUDA context when its job scans there.  Each job's worker
pid, the backend it compiled on, that backend's dispatch groups and the
compile's seconds are recorded in the store's ``compiled_by``.  Duplicate
jobs in one batch (same store key) compile once.  If the platform cannot
run a process pool (restricted environments, missing semaphores, workers
killed), ``compile_batch`` degrades to in-process serial compilation; a
*job's own* exception (e.g. an infeasible MAE_t) always propagates.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.schemes import PPATable
from ..core.searchspace import resolve_backend
from ..faults import failpoint

from .store import CompileJob, TableStore, default_store

__all__ = ["compile_batch"]


def _backend_label(backend) -> str:
    """``numpy``, or ``torch@<device>`` for a ``TorchSearchBackend``."""
    dev = getattr(backend, "device", None)
    return backend.name if dev is None else f"{backend.name}@{dev}"


def _compile_job_json(job: CompileJob) -> Tuple[str, Dict[str, object]]:
    """Worker entrypoint (top-level so it pickles): (table JSON, {"pid":
    this process's pid, "backend": the backend it compiled on,
    "dispatches": that backend's dispatch groups (0 on numpy), "seconds":
    the compile's wall time}).

    The ``compile.job`` failpoint fires at compile *start* (pool children
    inherit ``REPRO_TORCH_FAILPOINTS`` with their environment, so chaos arming
    reaches them) — the mid-compile crash site."""
    failpoint("compile.job", key=job.key())
    backend = resolve_backend(job.search_backend)
    before = getattr(backend, "counts", {}).get("dispatches", 0)
    t0 = time.perf_counter()
    table = dataclasses.replace(job, search_backend=backend).compile()
    return table.to_json(), {
        "pid": os.getpid(), "backend": _backend_label(backend),
        "dispatches": getattr(backend, "counts", {}).get("dispatches", 0)
        - before, "seconds": time.perf_counter() - t0}


def compile_batch(jobs: Sequence[CompileJob], *,
                  store: Optional[TableStore] = None,
                  processes: Optional[int] = None) -> List[PPATable]:
    """Compile every job, reusing the store; returns tables in job order.

    processes=None uses min(cpu_count, n_jobs); processes<=1 compiles
    serially in-process (deterministic, no pool).
    """
    store = store if store is not None else default_store()
    out: List[Optional[PPATable]] = [None] * len(jobs)
    todo: Dict[str, List[int]] = {}   # key -> job indices (dedup in-batch)
    for i, job in enumerate(jobs):
        tab = store.lookup(job)
        if tab is not None:
            out[i] = tab
        else:
            todo.setdefault(job.key(), []).append(i)
    if not todo:
        return out  # type: ignore[return-value]

    uniq = [idxs[0] for idxs in todo.values()]
    if processes is None:
        processes = min(os.cpu_count() or 1, len(uniq))
    results: Optional[List[str]] = None
    if processes > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        from concurrent.futures.process import BrokenProcessPool
        try:
            with ProcessPoolExecutor(
                    max_workers=processes,
                    mp_context=multiprocessing.get_context("spawn")) as ex:
                results = list(ex.map(_compile_job_json,
                                      [jobs[i] for i in uniq]))
        except (OSError, PermissionError, BrokenProcessPool):
            results = None  # pool unavailable here; fall back to serial
    if results is None:
        results = [_compile_job_json(jobs[i]) for i in uniq]

    for (key, idxs), (js, worker) in zip(todo.items(), results):
        tab = PPATable.from_json(js)
        store.misses += 1
        store.compiles += 1
        store.compiled_by[key] = worker
        store.put(jobs[idxs[0]], tab)
        # fires only after the durable publish (the chaos ledger's
        # exactly-once compile marker — see TableStore.compile_or_load);
        # its line names the process and backend that compiled the key
        failpoint("compile.job.done", key=key, pid=worker["pid"],
                  backend=worker["backend"])
        for i in idxs:
            out[i] = tab
    return out  # type: ignore[return-value]
