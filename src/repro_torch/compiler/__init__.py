"""repro_torch.compiler — the PPA table compiler.

Decouples *search* (fit -> quantize -> segment, with memoized window
evaluation) from *execution* (the packed :class:`PPATable` the CUDA
kernels and the serving engine consume).  A copy of the JAX package's
``compiler/``:

  * :class:`MemoizedSegmentEvaluator` — interval cache + monotone pruning +
    warm starts + batched speculative prefetch over ``SegmentEvaluator``.
  * :class:`CompilerSession` / :func:`compile_table` — the one canonical
    compile path; search loops share a session to reuse fits.
  * :class:`TableStore` / :func:`compile_or_load` — content-addressed
    memory+disk artifact store, byte-compatible with the JAX package's.
  * :func:`compile_batch` — fan-out of independent jobs over spawned
    worker processes.
  * :mod:`sweep` — multi-host design-space sweeps: deterministic key-hash
    sharding (``run_shard`` + :meth:`TableStore.merge` rendezvous) or live
    work-stealing over one shared store directory (``run_live`` /
    ``WorkQueue``; ``run_live_workers`` spawns N on one machine).
"""

from .batch import compile_batch
from .compile import (EFFORT_STAT_KEYS, CompilerSession, compile_table,
                      resolve_defaults, table_identity)
from .memo import MemoizedSegmentEvaluator
from .store import (CompileJob, TableStore, cache_dir, compile_or_load,
                    default_store, set_default_store)
from .sweep import (LiveReport, ShardReport, WorkQueue, merge_shards,
                    paper_grid, run_live, run_live_workers, run_shard,
                    shard_jobs, shard_of, simulate_hosts)

__all__ = [
    "MemoizedSegmentEvaluator",
    "CompilerSession", "compile_table", "resolve_defaults",
    "EFFORT_STAT_KEYS", "table_identity",
    "CompileJob", "TableStore", "cache_dir", "compile_or_load",
    "default_store", "set_default_store",
    "compile_batch",
    "ShardReport", "merge_shards", "paper_grid", "run_shard",
    "shard_jobs", "shard_of", "simulate_hosts",
    "LiveReport", "WorkQueue", "run_live", "run_live_workers",
]
