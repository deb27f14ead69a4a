"""Multi-host design-space sweep orchestration over the TableStore.

A copy of the JAX package's ``compiler/sweep.py`` for the port.  Its store
keys are byte-equal to the reference's, so both packages shard every key
alike.  The one addition is :func:`run_live_workers`, which spawns N live
workers on one machine (spawned, never forked: each makes its own CUDA
context when its scans run on the card).

The paper's full-space search is a design-space sweep: Tables I-VII walk
(naf x FWL x scheme x segment-budget) points, and every point is an
independent :class:`CompileJob`.  TBW tames the *per-point* cost; this
module scales the *sweep*: jobs are partitioned across hosts by
deterministic store-key hashing, each host runs its shard through
``compile_batch``'s process pool against its own (or a shared) store, and
the content-addressed on-disk tier is the rendezvous — shard directories
merge with :meth:`TableStore.merge` into a store bit-identical to a
single-host serial compile.

Two sweep modes share those primitives:

  * **Sharded** (``run_shard``) — jobs are pre-partitioned by
    deterministic key hashing (``shard_of``); each host owns a disjoint
    shard, typically against its *own* store directory, and shard
    directories are merged afterwards.  No host ever waits on another,
    but a slow or dead host strands its whole shard until an operator
    re-runs it.
  * **Live** (``run_live``) — N workers pull from ONE shared store
    directory with no partition at all: each worker walks the full grid
    claim-skip-retry style (``WorkQueue``), leasing keys as it goes, so
    fast workers naturally absorb slow workers' work and a final drain
    pass takes over (``claim_ttl_s``) the claims a dead worker orphaned.
    Requires a shared filesystem; no merge step.

Coordination primitives:

  * **Sharding** — ``shard_of(key, hosts)`` hashes the content address, so
    any host can compute the full partition with no coordinator and a key
    always lands on the same shard (resume a killed host by re-running its
    ``host_id``; already-stored keys are skipped by store lookup).
  * **Claim leasing** — before compiling, a host leases each key with a
    ``<key>.claim`` file (atomic O_EXCL).  Live claims defer the key
    (another host is compiling it — only possible on a shared store dir);
    claims staler than ``claim_ttl_s`` are taken over, which is how a
    surviving host finishes a dead host's keys.
  * **Manifests** — each shard run writes ``host<i>.manifest`` naming the
    keys it covered and the ``CompileJob.VERSION`` it compiled under;
    ``merge`` reconciles manifests first and refuses version mismatches.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import socket
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.datapath import FWLConfig
from ..core.functions import NAF_REGISTRY
from ..core.schemes import PPAScheme
from ..faults import failpoint

from .batch import compile_batch
from .store import CompileJob, TableStore, _content_sha, _tmp_name

__all__ = ["shard_of", "shard_jobs", "ShardReport", "run_shard",
           "WorkQueue", "LiveReport", "run_live", "run_live_workers",
           "merge_shards", "simulate_hosts", "default_owner", "paper_grid"]


def default_owner() -> str:
    return f"{socket.gethostname()}:{os.getpid()}"


# ------------------------------------------------------------- partitioning
def shard_of(key: str, hosts: int) -> int:
    """Deterministic shard for a store key (hex content address)."""
    return int(key, 16) % hosts


def shard_jobs(jobs: Sequence[CompileJob], hosts: int, host_id: int
               ) -> List[Tuple[str, CompileJob]]:
    """This host's (key, job) shard, deduplicated by key, order-stable.

    Every host computes the same partition from the job list alone —
    there is no coordinator to disagree with.
    """
    if not 0 <= host_id < hosts:
        raise ValueError(f"host_id {host_id} not in [0, {hosts})")
    mine: Dict[str, CompileJob] = {}
    for job in jobs:
        key = job.key()
        if shard_of(key, hosts) == host_id and key not in mine:
            mine[key] = job
    return list(mine.items())


# --------------------------------------------------------------- shard run
@dataclasses.dataclass
class ShardReport:
    """What one ``run_shard`` call did — also serialized as the manifest."""

    host_id: int
    hosts: int
    owner: str
    keys: Dict[str, str]                # key -> artifact filename (covered)
    compiled: List[str]                 # keys this run actually compiled
    loaded: List[str]                   # keys found in the store (resume)
    deferred: List[str]                 # keys under another host's live claim
    taken_over: List[str]               # stale claims this run took over
    wall_s: float
    #: key -> {"pid", "backend", "dispatches", "seconds"} of each key
    #: this run compiled (``TableStore.compiled_by``)
    compiled_by: Dict[str, Dict[str, object]] = dataclasses.field(
        default_factory=dict)

    @property
    def manifest_name(self) -> str:
        return f"host{self.host_id:03d}.manifest"


def run_shard(jobs: Sequence[CompileJob], *,
              hosts: int = 1,
              host_id: int = 0,
              store: Optional[TableStore] = None,
              processes: Optional[int] = None,
              claim_ttl_s: Optional[float] = None,
              owner: Optional[str] = None) -> ShardReport:
    """Compile this host's shard of ``jobs`` into ``store``; idempotent.

    Resume semantics: keys already in the store (memory or disk tier) are
    never recompiled, so re-running a killed shard only pays for what is
    missing.  Keys under another owner's live claim are *deferred* (listed
    in the report, not compiled — re-run to pick them up once the claim is
    released or goes stale); claims staler than ``claim_ttl_s`` are taken
    over.  Compiles run in pool-width waves: each key's lease is refreshed
    before its wave starts and released (ownership-checked) as soon as its
    wave lands, so ``claim_ttl_s`` needs to cover one *wave* of compiles,
    not the whole shard.  A manifest covering every key this shard now has
    in the store is written for :meth:`TableStore.merge` to reconcile.
    """
    store = store if store is not None else TableStore()
    owner = owner or default_owner()
    t0 = time.monotonic()
    mine = shard_jobs(jobs, hosts, host_id)

    loaded: List[str] = []
    deferred: List[str] = []
    taken_over: List[str] = []
    to_compile: List[Tuple[str, CompileJob]] = []
    for key, job in mine:
        if store.contains(job):
            loaded.append(key)
            continue
        had_claim = store.claim_info(key) is not None
        if not store.try_claim(key, owner=owner, ttl_s=claim_ttl_s):
            deferred.append(key)
            continue
        if had_claim:
            taken_over.append(key)
        to_compile.append((key, job))

    width = processes if processes and processes > 0 else \
        (os.cpu_count() or 1)
    released: set = set()
    try:
        for i in range(0, len(to_compile), width):
            # refresh every lease this run still holds: the timestamp
            # tracks this host being alive, not the shard's start time
            for key, _ in to_compile[i:]:
                store.try_claim(key, owner=owner, ttl_s=claim_ttl_s)
            wave = to_compile[i:i + width]
            compile_batch([job for _, job in wave], store=store,
                          processes=processes)
            for key, _ in wave:
                store.release_claim(key, owner=owner)
                released.add(key)
    finally:
        for key, _ in to_compile:
            if key not in released:
                store.release_claim(key, owner=owner)

    covered = {key: store._path(job.resolved(), key).name
               for key, job in mine
               if key not in deferred}
    report = ShardReport(
        host_id=host_id, hosts=hosts, owner=owner, keys=covered,
        compiled=[k for k, _ in to_compile], loaded=loaded,
        deferred=deferred, taken_over=taken_over,
        wall_s=time.monotonic() - t0,
        compiled_by={k: store.compiled_by[k] for k, _ in to_compile
                     if k in store.compiled_by})
    if store.persist:
        _write_manifest(store, report)
    return report


def _write_manifest(store: TableStore, report: ShardReport) -> Path:
    path = store.root / report.manifest_name
    man = {
        "v": CompileJob.VERSION,
        "host_id": report.host_id, "hosts": report.hosts,
        "owner": report.owner, "written": time.time(),
        "keys": report.keys,
        "stats": {"compiled": len(report.compiled),
                  "loaded": len(report.loaded),
                  "deferred": len(report.deferred),
                  "taken_over": len(report.taken_over),
                  "wall_s": report.wall_s},
    }
    man["sha"] = _content_sha(man)      # merge() verifies and refuses torn
    tmp = _tmp_name(path)
    tmp.write_text(json.dumps(man, sort_keys=True))
    failpoint("store.put.before_rename", name=path.name)
    os.replace(tmp, path)
    return path


# ------------------------------------------------------------ live mode
class WorkQueue:
    """One worker's claim-coordinated, work-stealing view of a job list.

    Every live worker builds the same queue from the same job list; the
    shared store directory is the only coordination channel.  A worker
    repeatedly claims a *wave* of unstored, unleased keys — skipping keys
    another worker holds (claim-skip) and re-probing them on later passes
    (retry) — compiles the wave, publishes, releases.  There is no
    partition: whichever worker gets to a key first compiles it, so fast
    workers drain slow workers' share of the grid, and once ``claim_ttl_s``
    ages out a dead worker's leases its keys become claimable again
    (takeover).

    Scan order is rotated by a hash of the owner tag so N workers starting
    together probe different ends of the grid instead of racing for the
    same first key — pure contention avoidance; correctness never depends
    on the order.
    """

    def __init__(self, jobs: Sequence[CompileJob], store: TableStore, *,
                 owner: str, claim_ttl_s: Optional[float] = None):
        self.store = store
        self.owner = owner
        self.claim_ttl_s = claim_ttl_s
        uniq: Dict[str, CompileJob] = {}
        for job in jobs:
            job = job.resolved()
            uniq.setdefault(job.key(), job)
        entries = list(uniq.items())
        if entries:
            off = int(hashlib.sha1(owner.encode()).hexdigest(), 16) \
                % len(entries)
            entries = entries[off:] + entries[:off]
        self.entries: List[Tuple[str, CompileJob]] = entries
        self.done: set = set()              # keys verified in the store
        self.loaded: List[str] = []         # found stored (any compiler)
        self.compiled: List[str] = []       # compiled by THIS worker
        self.taken_over: List[str] = []     # leases stolen from the dead

    def pending(self) -> List[Tuple[str, CompileJob]]:
        """Keys not yet verified stored (claimable or under a live lease)."""
        return [(k, j) for k, j in self.entries if k not in self.done]

    def claim_wave(self, width: int) -> List[Tuple[str, CompileJob]]:
        """Lease up to ``width`` compilable keys; classify the rest.

        Keys found stored are marked done (another worker — or a previous
        sweep — already published them).  Keys under a live foreign lease
        are skipped, to be re-probed on the next pass.  An empty return
        with non-empty :meth:`pending` means everything left is being
        compiled by someone else right now.
        """
        wave: List[Tuple[str, CompileJob]] = []
        for key, job in self.pending():
            status = self.store.claim_for_compile(
                job, owner=self.owner, ttl_s=self.claim_ttl_s)
            if status == "stored":
                self.done.add(key)
                self.loaded.append(key)
            elif status == "busy":
                continue
            else:
                if status == "stolen":
                    self.taken_over.append(key)
                wave.append((key, job))
                if len(wave) >= width:
                    break
        return wave

    def refresh(self, wave: Sequence[Tuple[str, CompileJob]]) -> None:
        """Re-stamp this worker's leases so their age tracks the wave
        start, not the claim scan — the per-wave heartbeat that keeps a
        *live* worker's keys from being stolen mid-compile."""
        for key, _ in wave:
            self.store.try_claim(key, owner=self.owner,
                                 ttl_s=self.claim_ttl_s)

    def release(self, wave: Sequence[Tuple[str, CompileJob]]) -> None:
        for key, _ in wave:
            self.store.release_claim(key, owner=self.owner)

    def mark_compiled(self, wave: Sequence[Tuple[str, CompileJob]]) -> None:
        for key, _ in wave:
            self.done.add(key)
            self.compiled.append(key)


@dataclasses.dataclass
class LiveReport(ShardReport):
    """ShardReport plus live-mode bookkeeping.  ``host_id``/``hosts`` are
    informational worker labels — live mode has no partition."""

    passes: int = 0                     # claim-scan passes over the grid
    waited_s: float = 0.0               # time parked waiting on live leases

    @property
    def manifest_name(self) -> str:
        # keyed on the owner tag, not host_id: the documented live-mode
        # invocation is the SAME command on every host (nobody passes
        # --host-id), and all workers share one directory — id-keyed
        # names would clobber each other's stats.  The default owner
        # (host:pid) is unique per worker.
        safe = re.sub(r"[^A-Za-z0-9._-]+", "-", self.owner)
        return f"live-{safe}.manifest"


def run_live(jobs: Sequence[CompileJob], *,
             store: Optional[TableStore] = None,
             workers: int = 1,
             worker_id: int = 0,
             processes: Optional[int] = None,
             claim_ttl_s: Optional[float] = None,
             owner: Optional[str] = None,
             drain: bool = True,
             poll_s: float = 0.05,
             max_wait_s: Optional[float] = 600.0) -> LiveReport:
    """Work-steal the whole grid from ONE shared store directory.

    Run the same call on N workers pointing at the same ``store`` root
    (shared filesystem): each worker claims keys as it reaches them
    (claim -> re-check -> compile -> publish -> release, via
    :meth:`TableStore.claim_for_compile`), so the grid is compiled exactly
    once with no pre-partition and no post-merge — a straggler holds up at
    most the keys it is actively leasing.

    The loop ends with a **drain pass**: when every remaining key is under
    another worker's live lease, this worker parks (``poll_s``) until the
    keys either appear in the store (the other worker published) or their
    leases go stale (the other worker died) and get taken over — so a
    crashed host never leaves the grid incomplete as long as one worker
    survives.  ``claim_ttl_s`` must be set for takeover; with it unset, a
    dead worker's keys stay deferred and the call returns after
    ``max_wait_s`` (report.deferred non-empty, CLI exit 3).

    ``claim_ttl_s`` needs to outlive one *wave* (≤ ``processes`` compiles),
    not the sweep: leases are re-stamped per wave (`WorkQueue.refresh`).
    """
    store = store if store is not None else TableStore()
    owner = owner or default_owner()
    t0 = time.monotonic()
    q = WorkQueue(jobs, store, owner=owner, claim_ttl_s=claim_ttl_s)
    width = processes if processes and processes > 0 else \
        (os.cpu_count() or 1)
    passes = 0
    waited = 0.0            # parked time since the grid last made progress
    total_waited = 0.0
    last_done = -1
    deferred: List[str] = []
    while True:
        passes += 1
        wave = q.claim_wave(width)
        # any progress — a wave we claimed OR keys other workers published
        # (claim_wave marks them stored) — resets the give-up clock, so a
        # parked worker never defers while the sweep is visibly advancing
        if len(q.done) != last_done:
            last_done = len(q.done)
            waited = 0.0
        if wave:
            # chaos crash sites: after the lease lands but before compile
            # (claims left for TTL takeover) and after durable publish but
            # before release (survivors see stored keys under a dead lease)
            failpoint("sweep.wave.claimed", n=len(wave))
            try:
                q.refresh(wave)
                compile_batch([job for _, job in wave], store=store,
                              processes=processes)
                q.mark_compiled(wave)
                failpoint("sweep.wave.published", n=len(wave))
            finally:
                q.release(wave)
            continue
        remaining = q.pending()
        if not remaining:
            break
        if not drain or (max_wait_s is not None and waited >= max_wait_s):
            deferred = [k for k, _ in remaining]
            break
        time.sleep(poll_s)
        waited += poll_s
        total_waited += poll_s
    covered = {key: store._path(job, key).name
               for key, job in q.entries if key in q.done}
    report = LiveReport(
        host_id=worker_id, hosts=workers, owner=owner, keys=covered,
        compiled=q.compiled, loaded=q.loaded, deferred=deferred,
        taken_over=q.taken_over, wall_s=time.monotonic() - t0,
        compiled_by={k: store.compiled_by[k] for k in q.compiled
                     if k in store.compiled_by},
        passes=passes, waited_s=total_waited)
    if store.persist:
        _write_manifest(store, report)
    return report


def _live_worker(jobs, root, worker_id, workers, processes, claim_ttl_s,
                 max_wait_s):
    """One spawned live worker (top-level so it pickles)."""
    return run_live(jobs, store=TableStore(root), workers=workers,
                    worker_id=worker_id, processes=processes,
                    claim_ttl_s=claim_ttl_s, owner=f"live-w{worker_id}",
                    max_wait_s=max_wait_s)


def run_live_workers(jobs: Sequence[CompileJob], root: "str | Path", *,
                     workers: int = 2, processes: Optional[int] = 1,
                     claim_ttl_s: Optional[float] = None,
                     max_wait_s: Optional[float] = 600.0
                     ) -> List[LiveReport]:
    """Run ``workers`` live workers on one machine over ONE shared store
    directory, each a spawned process calling :func:`run_live` (owner
    ``live-w<i>``, ``processes`` compiles a wave).  Returns their reports
    in worker order; every worker has ended on return."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = [ex.submit(_live_worker, list(jobs), str(root), i, workers,
                          processes, claim_ttl_s, max_wait_s)
                for i in range(workers)]
        return [f.result() for f in futs]


# -------------------------------------------------------------- rendezvous
def merge_shards(target: TableStore,
                 shard_dirs: Sequence["str | Path"],
                 *, require_manifest: bool = False) -> Dict[str, int]:
    """Union every shard directory into ``target`` (summed merge stats)."""
    total: Dict[str, int] = {}
    for d in shard_dirs:
        for k, v in target.merge(d, require_manifest=require_manifest
                                 ).items():
            total[k] = total.get(k, 0) + v
    return total


def simulate_hosts(jobs: Sequence[CompileJob], *,
                   hosts: int,
                   root: "str | Path",
                   processes: Optional[int] = None,
                   claim_ttl_s: Optional[float] = None
                   ) -> Tuple[TableStore, List[ShardReport], Dict[str, int]]:
    """Run an N-host sweep on one machine: per-host store dirs + merge.

    Each simulated host gets its own store directory under ``root`` (the
    separate-filesystems case — the hard one for rendezvous), runs its
    shard, and the shard dirs are merged into ``root/merged``.  Returns
    (merged store, per-host reports, merge stats).  Used by the tests.
    """
    root = Path(root)
    reports: List[ShardReport] = []
    shard_dirs: List[Path] = []
    for i in range(hosts):
        d = root / f"host{i}"
        shard_dirs.append(d)
        reports.append(run_shard(
            jobs, hosts=hosts, host_id=i, store=TableStore(d),
            processes=processes, claim_ttl_s=claim_ttl_s,
            owner=f"sim-host{i}"))
    merged = TableStore(root / "merged")
    stats = merge_shards(merged, shard_dirs)
    return merged, reports, stats


# ------------------------------------------------------------- paper grid
#: Per-table (scheme, FWL) templates applied across the NAF zoo.  Tables
#: VI/VII are the ASIC deployment sweeps: the full zoo at the 8- and
#: 16-bit datapaths priced by the cost model.  The "smoke" preset is the
#: same shape at 7-bit precision (seconds, used by the tests).
_F, _S = FWLConfig, PPAScheme
_TABLE_TEMPLATES: Dict[str, List[Tuple[PPAScheme, FWLConfig]]] = {
    "t1": [(_S(1, None, "fqa"), _F(8, 8, (8,), (8,), 8))],
    "t2": [(_S(1, None, "fqa"), _F(8, 8, (7,), (8,), 8)),
           (_S(1, None, "qpa"), _F(8, 8, (8,), (8,), 8)),
           (_S(1, None, "plac", segmenter="bisection"),
            _F(8, 8, (8,), (8,), 8))],
    "t3": [(_S(2, None, "fqa"), _F(8, 8, (8, 8), (8, 8), 8))],
    "t4": [(_S(1, m, "fqa"), _F(8, 8, (8,), (8,), 8)) for m in (2, 3, 4)],
    "t5": [(_S(2, 4, "fqa"), _F(8, 8, (8, 8), (8, 8), 8))],
    "t6": [(_S(1, None, "fqa"), _F(8, 8, (8,), (8,), 8)),
           (_S(1, 4, "fqa"), _F(8, 8, (8,), (8,), 8))],
    "t7": [(_S(1, None, "fqa"), _F(8, 16, (16,), (16,), 14)),
           (_S(1, None, "qpa"), _F(8, 16, (16,), (16,), 16))],
}
_SMOKE_TEMPLATES: List[Tuple[PPAScheme, FWLConfig]] = [
    (_S(1, None, "fqa"), _F(7, 7, (7,), (7,), 7)),
    (_S(1, None, "qpa"), _F(7, 7, (7,), (7,), 7)),
    (_S(1, 3, "fqa"), _F(7, 7, (7,), (7,), 7)),
]
_SMOKE_NAFS = ("sigmoid", "tanh", "gelu_inner", "exp2_frac")


def paper_grid(preset: str = "paper", *,
               nafs: Optional[Sequence[str]] = None,
               tables: Optional[Sequence[str]] = None
               ) -> List[CompileJob]:
    """Enumerate the Tables I-VII x NAF-zoo sweep as ``CompileJob``s.

    ``preset="paper"`` is the full grid (16-bit and order-2 points are
    minutes each); ``preset="smoke"`` is the 7-bit shape for tests.  Duplicate
    design points across tables collapse to one job (same store key).
    """
    if preset == "smoke":
        if tables is not None:
            raise ValueError("tables only applies to preset='paper' "
                             "(the smoke preset is one fixed template set)")
        templates = _SMOKE_TEMPLATES
        zoo = nafs or _SMOKE_NAFS
    elif preset == "paper":
        wanted = tables or sorted(_TABLE_TEMPLATES)
        unknown = set(wanted) - set(_TABLE_TEMPLATES)
        if unknown:
            raise ValueError(f"unknown tables {sorted(unknown)}; "
                             f"available: {sorted(_TABLE_TEMPLATES)}")
        templates = [tpl for t in wanted for tpl in _TABLE_TEMPLATES[t]]
        zoo = nafs or sorted(NAF_REGISTRY)
    else:
        raise ValueError(f"unknown preset {preset!r} (paper|smoke)")
    unknown_nafs = set(zoo) - set(NAF_REGISTRY)
    if unknown_nafs:
        raise ValueError(f"unknown NAFs {sorted(unknown_nafs)}")

    jobs: List[CompileJob] = []
    seen = set()
    for naf in zoo:
        for scheme, cfg in templates:
            job = CompileJob(naf=naf, cfg=cfg, scheme=scheme)
            key = job.key()
            if key not in seen:
                seen.add(key)
                jobs.append(job)
    return jobs
