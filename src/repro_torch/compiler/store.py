"""Content-addressed cross-compile table store.

A compiled :class:`~repro_torch.core.schemes.PPATable` is a deployment artifact —
the reconfigurable-unit view of Flex-SFU/GRAU — not a throwaway search
result.  The store makes it first-class: tables are addressed by the full
compile request (naf x interval x FWLConfig x PPAScheme x mae_t/tseg),
kept in an in-memory tier for the process and a JSON-on-disk tier (reusing
``PPATable.to_json``) shared across processes, benchmarks, tests and the
serving engine.

``compile_or_load`` is the one entrypoint consumers use: a memory hit costs
a dict lookup, a disk hit costs one JSON parse, and only a full miss runs
the compiler — with zero segment evaluations on any hit (asserted by
the tests).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import time
from pathlib import Path
from typing import ClassVar, Dict, List, Optional, Tuple

from ..core.datapath import FWLConfig
from ..core.schemes import PPAScheme, PPATable
from ..core.searchspace import (BACKEND_ENV, SearchBackend,
                                TorchSearchBackend)
from ..faults import failpoint

from .compile import CompilerSession, compile_table, resolve_defaults

__all__ = ["CompileJob", "TableStore", "cache_dir", "default_store",
           "set_default_store", "compile_or_load"]


#: Process-wide tmp-name uniquifier.  Live-mode workers may be threads of
#: one process (tests) or forked children (benchmarks); pid alone is not a
#: unique tmp suffix, so every tmp file also takes a counter tick.
_TMP_TICK = itertools.count()


def _tmp_name(path: Path, kind: str = "tmp") -> Path:
    return path.with_suffix(f".{os.getpid()}.{next(_TMP_TICK)}.{kind}")


# -- content checksums ---------------------------------------------------------
# Every JSON the store publishes (artifact, certificate, shard manifest)
# carries a "sha" field: a truncated sha256 over the canonical
# (sort_keys) serialization of the blob WITHOUT that field.  Readers
# verify it when present and treat a mismatch exactly like torn JSON —
# quarantine (own store) or skip-and-report (foreign dirs).  Blobs with
# no "sha" (pre-checksum artifacts, incl. the repo's committed tables)
# still load: the stamp is tamper/truncation *detection*, not a gate.

def _content_sha(blob: Dict) -> str:
    body = {k: v for k, v in blob.items() if k != "sha"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()[:16]


def _sha_ok(blob) -> bool:
    if not isinstance(blob, dict) or "sha" not in blob:
        return True         # unstamped legacy blob: nothing to verify
    return blob["sha"] == _content_sha(blob)


#: env var naming the on-disk tier's root; the default,
#: ``artifacts/ppa_tables_torch/``, is the port's own, apart from the
#: JAX package's ``artifacts/ppa_tables/``
CACHE_ENV = "REPRO_TORCH_TABLE_CACHE"


def cache_dir() -> Path:
    """Root of the on-disk tier (``$REPRO_TORCH_TABLE_CACHE`` overrides)."""
    d = os.environ.get(CACHE_ENV)
    if d:
        p = Path(d)
    else:
        p = (Path(__file__).resolve().parents[3] / "artifacts"
             / "ppa_tables_torch")
    p.mkdir(parents=True, exist_ok=True)
    return p


@dataclasses.dataclass(frozen=True)
class CompileJob:
    """One independent compile request — the store's addressing unit."""

    #: Compile-semantics version, baked into every store key and every
    #: sweep-shard manifest.  Bump it whenever compile *results* can change
    #: (key-version sweeping); merge() refuses manifests written
    #: at a different version, so a cross-host rendezvous never mixes
    #: artifacts from incompatible compilers.
    VERSION: ClassVar[int] = 3

    naf: str
    cfg: FWLConfig
    scheme: PPAScheme = PPAScheme()
    mae_t: Optional[float] = None
    interval: Optional[Tuple[float, float]] = None
    tseg: Optional[int] = None
    final_mode: str = "best"
    #: execution knobs, NOT part of the address (``key`` excludes them):
    #: the search backend and TBW speculation depth change how fast a job
    #: compiles, never what it compiles (asserted by the search-smoke CI
    #: tier), so two hosts running different backends still rendezvous on
    #: one artifact per key.  A backend of None defers to a tuned config
    #: (``TableStore._apply_tuned``), then to $REPRO_TORCH_SEARCH_BACKEND on
    #: the compiling host; it may also be an instance
    #: (``TorchSearchBackend("cpu")``).  A speculation depth of None is
    #: the tuned config's, else 0.
    search_backend: "Optional[str | SearchBackend]" = None
    speculate: Optional[int] = None

    def resolved(self) -> "CompileJob":
        """Fill in the defaults the compiler would use (one shared
        resolver, compile.resolve_defaults), so equivalent requests share
        one address and a key always describes the actual compile."""
        spec, interval, mae_t = resolve_defaults(
            self.naf, self.cfg, self.mae_t, self.interval)
        if (self.naf, self.interval, self.mae_t) == (spec.name, interval,
                                                     mae_t):
            return self     # already resolved (idempotent, no realloc)
        return dataclasses.replace(self, naf=spec.name, interval=interval,
                                   mae_t=mae_t)

    def key(self) -> str:
        job = self.resolved()
        blob = json.dumps({
            "naf": job.naf, "cfg": job.cfg.as_dict(),
            "scheme": dataclasses.asdict(job.scheme),
            "mae_t": job.mae_t, "interval": list(job.interval),
            "tseg": job.tseg, "final_mode": job.final_mode,
            "v": self.VERSION,
        }, sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def compile(self, session: Optional[CompilerSession] = None) -> PPATable:
        job = self.resolved()   # compile exactly what the key describes
        return compile_table(job.naf, job.cfg, job.scheme,
                             mae_t=job.mae_t, interval=job.interval,
                             tseg=job.tseg, final_mode=job.final_mode,
                             session=session,
                             search_backend=job.search_backend,
                             speculate=job.speculate or 0)


class TableStore:
    """Two-tier (memory + JSON disk) content-addressed PPATable store.

    ``max_entries`` bounds the memory tier: the least-recently-*accessed*
    table is evicted when the cap is exceeded (a dict re-insertion on every
    hit keeps insertion order == access order).  Eviction only drops the
    in-process copy — the disk tier still holds the artifact, so a re-access
    costs one JSON parse, never a recompile.  The disk tier is bounded
    separately and explicitly via :meth:`prune`.

    **Pinning** (the multi-tenant serving contract): :meth:`pin` marks a
    key exempt from memory-tier eviction — pinned entries neither count
    against ``max_entries`` nor are ever chosen as eviction victims, so a
    tenant's warmed table set stays a dict lookup away no matter how many
    other tenants churn the tier.  :meth:`unpin` returns the entry to
    normal LRU life.
    """

    #: transient-I/O read policy: a read that raises OSError or parses as
    #: torn JSON is retried up to IO_RETRIES more times with linear
    #: backoff before the store gives up on it (class attrs so tests and
    #: operators can tune them store-wide).
    IO_RETRIES: ClassVar[int] = 2
    IO_BACKOFF_S: ClassVar[float] = 0.02

    def __init__(self, root: "Optional[str | Path]" = None,
                 *, persist: bool = True,
                 max_entries: Optional[int] = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError("max_entries must be >= 1 (or None = unbounded)")
        self._root = Path(root) if root is not None else None
        self.persist = persist
        self.max_entries = max_entries
        self._mem: Dict[str, PPATable] = {}
        self._pinned: Dict[str, int] = {}   # key -> pin refcount
        self.hits_mem = 0
        self.hits_disk = 0
        self.misses = 0
        self.evictions = 0
        self.compiles = 0       # actual compiler runs charged to this store
        #: key -> {"pid", "backend", "dispatches", "seconds"} of each
        #: compile_batch job: the worker process, the search backend it
        #: compiled on, that backend's dispatch groups and the wall time
        self.compiled_by: Dict[str, Dict[str, object]] = {}
        self.tuned_applied = 0  # compiles that picked up a tuned config
        self.certs_checked = 0  # certificate staleness checks performed
        self.certs_stale = 0    # stale certificates retired on load
        self._cert_seen: set = set()    # keys staleness-checked this process
        self.io_retries = 0             # transient read errors retried
        self.corrupt_quarantined = 0    # corrupt/torn files moved aside
        self.quarantined: List[Tuple[str, str]] = []    # (name, reason)

    @property
    def root(self) -> Path:
        if self._root is None:
            self._root = cache_dir()
        self._root.mkdir(parents=True, exist_ok=True)
        return self._root

    def _path(self, job: CompileJob, key: str) -> Path:
        return self.root / f"{job.naf}-{job.scheme.tag}-{key}.json"

    # -- torn/corrupt file handling --------------------------------------------
    @property
    def quarantine_dir(self) -> Path:
        return self.root / "quarantine"

    def _quarantine(self, path: Path, reason: str) -> None:
        """Move a corrupt/torn file out of the store (never delete it: an
        operator may want the bytes for forensics).
        The quarantine dir is a subdirectory, so store globs (lookup,
        merge, prune, version_sweep) never see quarantined files again."""
        try:
            self.quarantine_dir.mkdir(exist_ok=True)
            os.replace(path, self.quarantine_dir /
                       f"{path.name}.{os.getpid()}.{next(_TMP_TICK)}")
        except OSError:
            return      # raced with another process's quarantine/prune
        self.corrupt_quarantined += 1
        self.quarantined.append((path.name, reason))
        # a certificate companion of a corrupt artifact proves nothing
        cert = path.with_suffix(".cert.json")
        if cert != path:
            cert.unlink(missing_ok=True)

    def _read_json(self, path: Path, *, what: str = "file"
                   ) -> Optional[Dict]:
        """Read+parse+checksum-verify a store JSON, with bounded retry.

        Transient failures (``OSError``) and torn reads
        (``JSONDecodeError`` / checksum mismatch) are retried
        ``IO_RETRIES`` times with linear backoff; a file that stays torn
        is **quarantined** and reported.  Returns the parsed blob or
        None (missing / still unreadable / quarantined) — this method
        never raises, which is what makes every read path crash-safe.
        """
        reason = None
        for attempt in range(self.IO_RETRIES + 1):
            if attempt:
                self.io_retries += 1
                time.sleep(self.IO_BACKOFF_S * attempt)
            try:
                failpoint("store.load.read", path=path.name)
                blob = json.loads(path.read_text())
            except FileNotFoundError:
                return None     # pruned/quarantined concurrently: a miss
            except json.JSONDecodeError as e:
                reason = f"torn {what}: {e}"
                continue
            except OSError as e:
                reason = f"io error: {e}"
                continue
            if not _sha_ok(blob):
                reason = f"checksum mismatch on {what}"
                continue
            return blob
        if reason and not reason.startswith("io error") and path.exists():
            self._quarantine(path, reason)
        return None

    # -- bit-width certificates ------------------------------------------------
    # The analysis layer's overflow-freedom proof (repro_torch.analysis.certify)
    # lives next to each artifact as <artifact>.cert.json, stamped with the
    # certificate schema version, the CompileJob.VERSION and the store key.
    # compile_or_load retires mismatched-stamp certificates (once per key
    # per process — the hot path stays a dict lookup); it never *requires*
    # one, so certification stays an explicit, separately-gated step.

    def cert_path(self, job: CompileJob) -> Path:
        job = job.resolved()
        return self._path(job, job.key()).with_suffix(".cert.json")

    def certify(self, job: CompileJob, table: Optional[PPATable] = None):
        """Prove (exact, per-segment) bit-width safety of ``job``'s table
        and persist the stamped certificate next to the artifact.

        Compiles/loads the table if not supplied.  Returns the
        :class:`repro_torch.analysis.certify.Certificate` (check ``cert.ok``)."""
        from ..analysis.certify import certify_table
        job = job.resolved()
        key = job.key()
        if table is None:
            table = self.compile_or_load(
                job.naf, job.cfg, job.scheme, mae_t=job.mae_t,
                interval=job.interval, tseg=job.tseg,
                final_mode=job.final_mode)
        cert = certify_table(table)
        cert.meta = {"v": CompileJob.VERSION, "key": key}
        if self.persist:
            path = self.cert_path(job)
            blob = json.loads(cert.to_json())
            blob["sha"] = _content_sha(blob)
            tmp = _tmp_name(path)
            tmp.write_text(json.dumps(blob, sort_keys=True))
            failpoint("store.put.before_rename", name=path.name)
            os.replace(tmp, path)   # atomic publish, like _put
        self._cert_seen.add(key)
        return cert

    def _load_cert_file(self, path: Path):
        """Parse + checksum-verify a stored certificate (sha stripped
        before schema load).  Raises on torn/corrupt files — callers
        classify that as stale/absent."""
        from ..analysis.certify import Certificate
        blob = json.loads(path.read_text())
        if not _sha_ok(blob):
            raise ValueError(f"checksum mismatch on certificate {path.name}")
        if isinstance(blob, dict):
            blob.pop("sha", None)
        return Certificate.from_json(json.dumps(blob))

    def load_certificate(self, job: CompileJob):
        """The stored certificate for ``job`` (stamps verified), or None."""
        from ..analysis.certify import CERT_VERSION
        job = job.resolved()
        if not self.persist:
            return None
        path = self.cert_path(job)
        try:
            cert = self._load_cert_file(path)
        except (OSError, ValueError, KeyError, TypeError):
            return None
        if cert.cert_version != CERT_VERSION \
                or cert.meta.get("v") != CompileJob.VERSION \
                or cert.meta.get("key") != job.key():
            return None
        return cert

    def _check_cert(self, job: CompileJob, key: str) -> None:
        """Retire a stale certificate (mismatched version/key stamps) the
        first time ``key`` is served this process."""
        if key in self._cert_seen or not self.persist:
            return
        self._cert_seen.add(key)
        path = self._path(job, key).with_suffix(".cert.json")
        if not path.exists():
            return
        self.certs_checked += 1
        from ..analysis.certify import CERT_VERSION
        try:
            cert = self._load_cert_file(path)
            fresh = (cert.cert_version == CERT_VERSION
                     and cert.meta.get("v") == CompileJob.VERSION
                     and cert.meta.get("key") == key)
        except (OSError, ValueError, KeyError, TypeError):
            fresh = False       # torn cert companion: retire, never raise
        if not fresh:
            path.unlink(missing_ok=True)
            self.certs_stale += 1

    # -- tiers -----------------------------------------------------------------
    def _remember(self, key: str, table: PPATable) -> None:
        """Insert/refresh ``key`` as the most-recently-accessed memory entry,
        evicting the least-recently-accessed *unpinned* entries beyond
        ``max_entries`` (pinned entries are exempt and uncounted)."""
        self._mem.pop(key, None)
        self._mem[key] = table
        if self.max_entries is not None:
            unpinned = [k for k in self._mem if k not in self._pinned]
            excess = len(unpinned) - self.max_entries
            for victim in unpinned[:max(excess, 0)]:
                self._mem.pop(victim)
                self.evictions += 1

    def _lookup(self, job: CompileJob, key: str) -> Optional[PPATable]:
        """Memory then disk for an already-resolved job; no compile."""
        tab = self._mem.get(key)
        if tab is not None:
            self.hits_mem += 1
            self._remember(key, tab)        # refresh LRU position
            return tab
        if self.persist:
            path = self._path(job, key)
            if path.exists():
                blob = self._read_json(path, what="artifact")
                if blob is None:
                    return None     # torn/quarantined: fall through, recompile
                try:
                    tab = PPATable.from_json(json.dumps(blob))
                except Exception:
                    # parses as JSON but not as a table: corrupt payload
                    self._quarantine(path, "invalid artifact schema")
                    return None
                self.hits_disk += 1
                try:                    # refresh last-access for prune()
                    os.utime(path)
                except OSError:
                    pass
                self._remember(key, tab)
                return tab
        return None

    def _put(self, job: CompileJob, key: str, table: PPATable) -> None:
        self._remember(key, table)
        if self.persist:
            path = self._path(job, key)
            # stamp the compile-semantics version into the artifact so a
            # long-lived store can be version-swept after a VERSION bump.
            # Key order is preserved (load -> append), so every writer of a
            # given table produces byte-identical files — the bit-identity
            # guarantee the sweep modes are checked against.
            blob = json.loads(table.to_json())
            blob["v"] = CompileJob.VERSION
            blob["sha"] = _content_sha(blob)
            tmp = _tmp_name(path)
            tmp.write_text(json.dumps(blob))
            failpoint("store.put.before_rename", name=path.name)
            os.replace(tmp, path)  # atomic publish

    def lookup(self, job: CompileJob) -> Optional[PPATable]:
        """Memory then disk; None on a full miss (no compile)."""
        job = job.resolved()
        return self._lookup(job, job.key())

    def contains(self, job: CompileJob) -> bool:
        """Existence probe: no JSON parse, no memory-tier insertion.

        For callers that only classify keys (sweep resume) — a stored
        paper-grid shard would otherwise be fully parsed and pinned in
        the memory tier just to be counted.
        """
        job = job.resolved()
        key = job.key()
        if key in self._mem:
            return True
        return self.persist and self._path(job, key).exists()

    def put(self, job: CompileJob, table: PPATable) -> None:
        job = job.resolved()
        self._put(job, job.key(), table)

    # -- pinning ---------------------------------------------------------------
    def pin(self, job: CompileJob) -> str:
        """Exempt ``job``'s table from memory-tier eviction.

        Pins are *ref-counted* per key: two tenants sharing one NAF zoo
        each pin the same keys, and the entry stays exempt until every
        pinner has unpinned.  The entry itself need not be resident yet —
        pinning is a property of the key, applied whenever the table is
        (re)membered.  Returns the pinned store key.
        """
        key = job.resolved().key()
        self._pinned[key] = self._pinned.get(key, 0) + 1
        return key

    def unpin(self, job: CompileJob) -> str:
        """Drop one pin on ``job``'s table; at refcount zero the entry
        returns to normal LRU residency (and the cap re-applies now)."""
        key = job.resolved().key()
        n = self._pinned.get(key, 0) - 1
        if n > 0:
            self._pinned[key] = n
            return key
        self._pinned.pop(key, None)
        # re-apply the cap now that this entry counts against it again
        if self._mem:
            last = next(reversed(self._mem))
            self._remember(last, self._mem[last])
        return key

    def pinned_keys(self) -> frozenset:
        return frozenset(self._pinned)

    # -- the entrypoint --------------------------------------------------------
    def compile_or_load(self, naf: str, cfg: FWLConfig,
                        scheme: PPAScheme = PPAScheme(), *,
                        mae_t: Optional[float] = None,
                        interval: Optional[Tuple[float, float]] = None,
                        tseg: Optional[int] = None,
                        final_mode: str = "best",
                        session: Optional[CompilerSession] = None,
                        search_backend: "str | SearchBackend | None" = None
                        ) -> PPATable:
        """The table of this compile request: from memory, from disk, or
        compiled (on ``search_backend``, which the key leaves out) and
        published."""
        job = CompileJob(naf=naf, cfg=cfg, scheme=scheme, mae_t=mae_t,
                         interval=interval, tseg=tseg,
                         final_mode=final_mode,
                         search_backend=search_backend).resolved()
        key = job.key()
        tab = self._lookup(job, key)
        if tab is not None:
            self._check_cert(job, key)
            return tab
        self.misses += 1
        self.compiles += 1
        failpoint("compile.job", key=key)
        tab = self._apply_tuned(job).compile(session)
        self._put(job, key, tab)
        # fires only once the artifact is durably published — the ledger
        # line the chaos harness counts compiles by (a kill between
        # compile start and here must be recompiled, and is not counted)
        failpoint("compile.job.done", key=key)
        self._check_cert(job, key)
        return tab

    def _apply_tuned(self, job: CompileJob) -> CompileJob:
        """Fill the job's *execution* knobs from the tuned config
        persisted next to this store (``<root>/tune/``), when one exists
        for this device.  Only fields the caller left None are filled,
        and ``$REPRO_TORCH_SEARCH_BACKEND`` still wins over the tuned file
        (see :mod:`repro_torch.tune.config` for the precedence order).
        The key was computed before this call and excludes these fields,
        so tuning can never move an artifact's address, and the compiled
        table is the untuned compile's (``table_identity``; a speculation
        depth moves only the effort counters in its stats)."""
        if not self.persist:
            return job
        try:
            from ..tune import activate, resolve_tuned
            tuned = resolve_tuned(self.root)
        except Exception:
            return job
        if tuned is None:
            return job
        activate(tuned)     # the torch backend's floors (idempotent)
        updates: Dict[str, object] = {}
        if job.search_backend is None and not os.environ.get(BACKEND_ENV):
            if tuned.search_backend == "torch":
                # a config measured on the card scans there; one measured
                # on the host (key cpu/host) scans on the host's torch
                updates["search_backend"] = TorchSearchBackend(
                    None if tuned.device.startswith("cuda/") else "cpu")
            elif tuned.search_backend:
                updates["search_backend"] = tuned.search_backend
        if job.speculate is None:
            updates["speculate"] = int(tuned.speculate)
        if not updates:
            return job
        self.tuned_applied += 1
        return dataclasses.replace(job, **updates)

    # -- claim-file leasing ----------------------------------------------------
    # Hosts racing on one key (a shared store directory, or a takeover of a
    # dead host's shard) coordinate through <key>.claim files next to the
    # artifacts.  A claim is a lease, not a lock: acquisition is atomic
    # (O_EXCL), but a claim older than the caller's ttl is considered
    # abandoned and may be taken over.  Two hosts may both win a takeover
    # race in pathological cases — that costs one duplicate compile, never
    # correctness, because puts are content-addressed and idempotent.

    def _claim_path(self, key: str) -> Path:
        return self.root / f"{key}.claim"

    def claim_info(self, key: str) -> Optional[Dict]:
        """The current claim on ``key`` (owner/pid/time), or None."""
        try:
            return json.loads(self._claim_path(key).read_text())
        except (OSError, ValueError):
            return None

    def try_claim(self, key: str, *, owner: str,
                  ttl_s: Optional[float] = None) -> bool:
        """Acquire (or refresh) the compile lease on ``key``.

        Returns True if this caller now holds the claim (fresh acquisition,
        refresh of its own claim, or takeover of a claim staler than
        ``ttl_s``).  Returns False while another owner's claim is live.
        Acquisition is name+content atomic (hard-link of a fully-written
        tmp file), so a concurrent reader never observes a half-written
        claim it could misjudge as abandoned.
        """
        path = self._claim_path(key)
        blob = json.dumps({"key": key, "owner": owner, "pid": os.getpid(),
                           "time": time.time()})
        tmp = _tmp_name(path, "claimtmp")
        tmp.write_text(blob)
        try:
            os.link(tmp, path)
        except FileExistsError:
            cur = self.claim_info(key)
            if cur is not None and cur.get("owner") == owner:
                pass        # our own claim: refresh the lease timestamp
            elif cur is not None and (
                    ttl_s is None
                    or time.time() - cur.get("time", 0.0) <= ttl_s):
                tmp.unlink(missing_ok=True)
                return False    # live claim held by someone else
            elif cur is None:
                # unreadable claim: only age it by file mtime, never
                # steal it outright (ttl_s=None means never take over)
                try:
                    age = time.time() - path.stat().st_mtime
                except OSError:
                    age = float("inf")      # vanished: fall through, retake
                if ttl_s is None or age <= ttl_s:
                    tmp.unlink(missing_ok=True)
                    return False
            os.replace(tmp, path)   # stale: take the lease over atomically
            return True
        tmp.unlink(missing_ok=True)
        return True

    def release_claim(self, key: str, *, owner: Optional[str] = None) -> None:
        """Drop the lease on ``key``.

        With ``owner`` given, only a claim still held by that owner is
        removed — a host whose lease was taken over must not delete the
        new holder's live claim.
        """
        if owner is not None:
            cur = self.claim_info(key)
            if cur is not None and cur.get("owner") != owner:
                return
        self._claim_path(key).unlink(missing_ok=True)

    def claim_status(self, key: str, *, ttl_s: Optional[float] = None) -> str:
        """Operator-readable lease state for ``key``.

        ``"free"`` (no claim file), ``"claimed-by-<owner>"`` (live lease)
        or ``"stale(<owner>, <age>s)"`` once the lease is older than
        ``ttl_s`` — i.e. the next ``try_claim(ttl_s=...)`` would take it
        over.  An unreadable claim file reports its owner as
        ``unreadable`` and ages by file mtime, mirroring ``try_claim``.
        """
        info = self.claim_info(key)
        if info is not None:
            age = time.time() - float(info.get("time", 0.0))
            label = str(info.get("owner", "?"))
        else:
            try:
                age = time.time() - self._claim_path(key).stat().st_mtime
            except OSError:
                return "free"
            label = "unreadable"
        if ttl_s is not None and age > ttl_s:
            return f"stale({label}, {age:.0f}s)"
        return f"claimed-by-{label}"

    def claim_for_compile(self, job: CompileJob, *, owner: str,
                          ttl_s: Optional[float] = None) -> str:
        """Atomic front half of the live-sweep pipeline: claim, then
        re-check the store *under the claim* before any compile starts.

        The ordering matters — between a worker's "is it stored?" probe
        and its claim acquisition, another worker may have compiled,
        published and released the same key.  Re-checking after the claim
        is held closes that window: once this returns ``"claimed"`` the
        key is both unstored and exclusively leased, so the caller's
        compile -> publish (atomic ``_put``) -> release sequence runs
        exactly once per key grid-wide.

        Returns ``"stored"`` (present, nothing to do — any claim we took
        was released), ``"busy"`` (another owner's live lease; skip and
        retry later), ``"claimed"`` (we hold a fresh lease) or
        ``"stolen"`` (we hold the lease by taking over a stale one).
        """
        job = job.resolved()
        key = job.key()
        if self.contains(job):
            return "stored"
        # read-only liveness probe first: a parked worker polls every
        # pending key each drain tick, and attempting try_claim against a
        # known-live lease would cost a tmp write + link per key per tick
        # on the shared filesystem.  Mirrors try_claim's staleness rules
        # (claim time for readable claims, file mtime for unreadable
        # ones); the subsequent try_claim re-arbitrates atomically anyway.
        prior = self.claim_info(key)
        path = self._claim_path(key)
        had_other = False
        if prior is not None and prior.get("owner") != owner:
            age = time.time() - float(prior.get("time", 0.0))
            if ttl_s is None or age <= ttl_s:
                return "busy"
            had_other = True
        elif prior is None and path.exists():
            try:
                age = time.time() - path.stat().st_mtime
            except OSError:
                age = float("inf")
            if ttl_s is None or age <= ttl_s:
                return "busy"
            had_other = True
        if not self.try_claim(key, owner=owner, ttl_s=ttl_s):
            return "busy"
        if self.contains(job):      # published while we raced for the lease
            self.release_claim(key, owner=owner)
            return "stored"
        return "stolen" if had_other else "claimed"

    # -- cross-host rendezvous -------------------------------------------------
    def merge(self, other_dir: "str | Path", *,
              require_manifest: bool = False) -> Dict[str, int]:
        """Import a foreign store directory (a sweep shard's rendezvous).

        Shard manifests (``*.manifest``, written by
        :func:`repro_torch.compiler.sweep.run_shard` and ``run_live``) are
        reconciled first: a
        manifest names the keys its shard produced and the
        ``CompileJob.VERSION`` it compiled under — entries from a different
        version are refused (``skipped_version``), so stores never mix
        artifacts with incompatible compile semantics.  Artifact files not
        covered by any manifest are imported by filename-parsed key unless
        ``require_manifest`` is set.  Keys already present locally are
        skipped; copies are atomic and byte-identical (content-addressed
        keys make this a true union).  Returns counters.
        """
        other = Path(other_dir)
        stats = {"imported": 0, "skipped_present": 0, "skipped_version": 0,
                 "skipped_invalid": 0, "skipped_unmanifested": 0}
        manifested: Dict[str, str] = {}     # filename -> key
        refused: set = set()                # filenames under a refused manifest
        for mpath in sorted(other.glob("*.manifest")):
            try:
                man = json.loads(mpath.read_text())
            except (OSError, ValueError):
                stats["skipped_invalid"] += 1
                continue
            # the version check precedes the integrity check: a manifest
            # declaring a foreign compile-semantics version refuses its
            # keys outright, intact or not
            if man.get("v") != CompileJob.VERSION:
                refused.update(man.get("keys", {}).values())
                continue
            if not _sha_ok(man):
                # torn/tampered manifest: refuse its vouching, but its
                # artifacts may still import unmanifested (each is
                # checksum-verified on its own below)
                stats["skipped_invalid"] += 1
                continue
            for key, fname in man.get("keys", {}).items():
                manifested[fname] = key
        # a file vouched for by a current-version manifest stays importable
        # even if some other (refused) manifest also names it
        refused -= set(manifested)
        for path in sorted(other.glob("*.json")):
            if path.name.endswith(".cert.json"):
                continue    # certificates travel with their artifact's key
            if path.name in manifested:
                key = manifested[path.name]
            elif path.name in refused:
                # compiled under a different CompileJob.VERSION: never
                # imported, manifest required or not — mixed-version
                # stores would break the bit-identity guarantee
                stats["skipped_version"] += 1
                continue
            elif require_manifest:
                stats["skipped_unmanifested"] += 1
                continue
            else:
                key = path.stem.rsplit("-", 1)[-1]
            if (self.root / path.name).exists():
                stats["skipped_present"] += 1
                continue
            failpoint("store.merge.file", name=path.name)
            try:
                text = path.read_text()
                blob = json.loads(text)
                PPATable.from_json(text)    # refuse corrupt artifacts
            except (OSError, ValueError, KeyError, TypeError,
                    AttributeError):        # incl. JSON that isn't a dict
                stats["skipped_invalid"] += 1
                continue
            # artifacts stamped with a foreign compile-semantics version
            # are refused even without a manifest vouching for them; the
            # version check precedes the integrity check since refusal
            # does not depend on the rest of the blob being intact
            if isinstance(blob, dict) and blob.get("v", CompileJob.VERSION) \
                    != CompileJob.VERSION:
                stats["skipped_version"] += 1
                continue
            if not _sha_ok(blob):           # truncation/bit-rot in transit
                stats["skipped_invalid"] += 1
                continue
            dst = self.root / path.name
            tmp = _tmp_name(dst)
            tmp.write_text(text)
            os.replace(tmp, dst)            # atomic, like _put
            self._mem.pop(key, None)        # force re-read if cached stale
            stats["imported"] += 1
        return stats

    # -- disk-tier GC ----------------------------------------------------------
    def prune(self, *, max_files: Optional[int] = None,
              max_age_s: Optional[float] = None) -> List[Path]:
        """Bound the append-only disk tier, keyed on last access.

        Last access is the file mtime — refreshed by ``os.utime`` on every
        disk-tier hit, so it tracks reads, not just writes.  Removes
        artifacts older than ``max_age_s`` and/or the least-recently-
        accessed files beyond ``max_files``; with neither given this is a
        no-op.  Returns the removed paths.  Memory-tier entries are
        untouched (they are bounded by ``max_entries`` instead).
        """
        if not self.persist or (max_files is None and max_age_s is None):
            return []
        entries = []                        # stat once, tolerate other
        # entries are sorted by mtime just below; filesystem order never
        # reaches keys or results.  analysis: allow(nondet-iter)
        for p in self.root.glob("*.json"):  # processes pruning concurrently
            if p.name.endswith(".cert.json"):
                continue        # certs are pruned with their artifact below
            try:
                entries.append((p, p.stat().st_mtime))
            except OSError:
                continue
        entries.sort(key=lambda e: e[1])
        doomed = []
        if max_age_s is not None:
            cutoff = time.time() - max_age_s
            doomed += [p for p, mtime in entries if mtime < cutoff]
        if max_files is not None and len(entries) > max_files:
            doomed += [p for p, _ in entries[:len(entries) - max_files]]
        removed = []
        for p in dict.fromkeys(doomed):     # dedup, keep LRU order
            try:
                p.unlink()
            except OSError:
                continue
            # an orphaned certificate proves nothing anyone can load
            p.with_suffix(".cert.json").unlink(missing_ok=True)
            removed.append(p)
        return removed

    def version_sweep(self, *, keep_unversioned: bool = False) -> List[Path]:
        """Retire disk entries whose ``CompileJob.VERSION`` no longer
        matches the running compiler's (the key-version sweep).

        After a ``VERSION`` bump, old artifacts are unreachable through
        normal lookups (the version is baked into every store key) but
        still occupy the disk tier and still surface in ``--list`` /
        ``merge`` bookkeeping.  This removes:

          * artifacts stamped with a different ``"v"`` (every artifact
            written since the stamp landed carries one),
          * artifacts with no stamp at all — written by a pre-stamp
            compiler, so their version is unknowable; pass
            ``keep_unversioned=True`` to spare them,
          * unreadable artifacts (they can never load), and
          * shard manifests recorded at a different version (``merge``
            refuses them anyway).

        Memory-tier copies of retired keys are dropped too.  Returns the
        removed paths.  Current-version entries are never touched.
        """
        if not self.persist:
            return []

        def stamped_version(p: Path):
            try:
                blob = json.loads(p.read_text())
            except (OSError, ValueError):
                return None                 # unreadable: unknown version
            return blob.get("v") if isinstance(blob, dict) else None

        removed: List[Path] = []
        for path in sorted(self.root.glob("*.json")):
            if path.name.endswith(".cert.json"):
                # certificates carry their own stamps, checked (and stale
                # ones retired) on compile_or_load rather than swept here
                continue
            v = stamped_version(path)
            if v == CompileJob.VERSION or (v is None and keep_unversioned):
                continue
            self._mem.pop(path.stem.rsplit("-", 1)[-1], None)
            try:
                path.unlink()
            except OSError:
                continue
            path.with_suffix(".cert.json").unlink(missing_ok=True)
            removed.append(path)
        for man in sorted(self.root.glob("*.manifest")):
            if stamped_version(man) == CompileJob.VERSION:
                continue
            try:
                man.unlink()
            except OSError:
                continue
            removed.append(man)
        return removed

    def stats(self) -> Dict[str, int]:
        return {"hits_mem": self.hits_mem, "hits_disk": self.hits_disk,
                "misses": self.misses, "in_memory": len(self._mem),
                "evictions": self.evictions, "compiles": self.compiles,
                "pinned": len(self._pinned),
                "certs_checked": self.certs_checked,
                "certs_stale": self.certs_stale,
                "io_retries": self.io_retries,
                "corrupt_quarantined": self.corrupt_quarantined}


_DEFAULT: Optional[TableStore] = None


def default_store() -> TableStore:
    """The process-wide store every inline consumer (models, serving,
    benchmarks) resolves tables through."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = TableStore()
    return _DEFAULT


def set_default_store(store: Optional[TableStore]) -> Optional[TableStore]:
    """Swap the process-wide store (e.g. the serving engine pinning its own
    artifact directory).  Returns the previous store."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, store
    return prev


def compile_or_load(naf: str, cfg: FWLConfig, scheme: PPAScheme = PPAScheme(),
                    *, mae_t: Optional[float] = None,
                    interval: Optional[Tuple[float, float]] = None,
                    tseg: Optional[int] = None, final_mode: str = "best",
                    store: Optional[TableStore] = None,
                    session: Optional[CompilerSession] = None,
                    search_backend: "str | SearchBackend | None" = None
                    ) -> PPATable:
    """Module-level convenience over :meth:`TableStore.compile_or_load`."""
    return (store or default_store()).compile_or_load(
        naf, cfg, scheme, mae_t=mae_t, interval=interval, tseg=tseg,
        final_mode=final_mode, session=session,
        search_backend=search_backend)
