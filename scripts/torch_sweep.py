#!/usr/bin/env python
"""Multi-host design-space sweep CLI of the PyTorch port, over its
TableStore rendezvous.

Enumerates the paper's Tables I-VII x NAF-zoo grid as ``CompileJob``s and
runs it in one of two modes (``--mode``); the flags, modes and exit codes
are those of ``scripts/sweep.py``:

**sharded** (default) — runs *this host's* key-hash shard.  N hosts each
running

    python scripts/torch_sweep.py --hosts N --host-id i --store /shard/i

cover the grid exactly once with no coordinator, each against its own
store directory; ``--merge-from`` reconciles the shard manifests
afterwards:

    python scripts/torch_sweep.py --store /merged --merge-from /shard/0 /shard/1

**live** — no partition: N workers point at ONE shared store directory
and steal work key by key via claim leases, so a slow host's keys are
absorbed by fast hosts and a dead host's stale claims are taken over
(``--claim-ttl``, required for takeover).  No merge step:

    python scripts/torch_sweep.py --mode live --claim-ttl 300 --store /nfs/grid

Both modes are resumable (store lookup before compile; re-run after a
kill and only missing keys compile) and exit 3 when keys were deferred
under another host's live claim.

``--backend numpy|torch`` / ``--speculate DEPTH`` pick how THIS host runs
the candidate scan: ``torch`` is ``TorchSearchBackend``, on the card
unless ``--device`` names another device (``--device cpu`` scans with
torch on the host).  Execution-only: store keys and artifacts are
bit-identical across backends, so mixed fleets share one store.  Without
a flag, ``$REPRO_TORCH_SEARCH_BACKEND`` and then the tuned config next to
the store (``--retune`` writes it) decide, as in ``TableStore``.

Examples:
    scripts/torch_sweep.py --list                   # grid + claim status
    scripts/torch_sweep.py --preset smoke --hosts 2 --host-id 0 --store /tmp/s0
    scripts/torch_sweep.py --tables t1 t2 --nafs sigmoid tanh --store /tmp/g
    scripts/torch_sweep.py --tables t3 t7 --backend torch --speculate 3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.compiler import (TableStore, merge_shards,  # noqa: E402
                                  paper_grid, run_live, run_shard)
from repro_torch.compiler.sweep import shard_jobs  # noqa: E402
from repro_torch.core.searchspace import (SEARCH_BACKENDS,  # noqa: E402
                                          TorchSearchBackend)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", choices=("paper", "smoke"), default="paper")
    p.add_argument("--tables", nargs="*", default=None, metavar="tN",
                   help="restrict to table templates (t1..t7)")
    p.add_argument("--nafs", nargs="*", default=None,
                   help="restrict the NAF zoo")
    p.add_argument("--limit", type=int, default=None,
                   help="truncate the grid (debugging)")
    p.add_argument("--mode", choices=("sharded", "live"), default="sharded",
                   help="sharded: key-hash partition, own store dir per "
                   "host, merge afterwards; live: work-stealing over one "
                   "shared store dir, no merge")
    p.add_argument("--hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0,
                   help="shard selector (sharded) / worker label (live)")
    p.add_argument("--poll", type=float, default=0.5, metavar="SEC",
                   help="live mode: drain-pass poll interval")
    p.add_argument("--max-wait", type=float, default=600.0, metavar="SEC",
                   help="live mode: give up on foreign live claims after "
                   "SEC of waiting (deferred keys, exit 3)")
    p.add_argument("--no-drain", action="store_true",
                   help="live mode: defer foreign-claimed keys immediately "
                   "instead of waiting them out")
    p.add_argument("--store", type=Path, default=None,
                   help="store directory (default: "
                   "$REPRO_TORCH_TABLE_CACHE)")
    p.add_argument("--backend", choices=sorted(SEARCH_BACKENDS),
                   default=None,
                   help="search backend for THIS host's compiles (numpy "
                   "golden / torch; default $REPRO_TORCH_SEARCH_BACKEND, "
                   "then the tuned config, then numpy).  Execution-only")
    p.add_argument("--device", default=None,
                   help="where the torch backend scans and --retune tunes "
                   "(default: the card; 'cpu' for the host)")
    p.add_argument("--speculate", type=int, default=None, metavar="DEPTH",
                   help="TBW speculative probe batching depth for this "
                   "host (default: the tuned config's, then 0 = off); "
                   "execution-only, like --backend")
    p.add_argument("--processes", type=int, default=None,
                   help="compile_batch pool size (1 = serial)")
    p.add_argument("--claim-ttl", type=float, default=None, metavar="SEC",
                   help="take over claims staler than SEC (default: defer)")
    p.add_argument("--owner", default=None,
                   help="claim owner tag (default host:pid)")
    p.add_argument("--retune", action="store_true",
                   help="run the per-device autotuner (smoke shape) "
                   "against --store before sweeping; the persisted winner "
                   "then drives this and every later sweep on this device")
    p.add_argument("--merge-from", nargs="*", type=Path, default=None,
                   metavar="DIR", help="merge shard dirs into --store "
                   "instead of compiling")
    p.add_argument("--list", action="store_true",
                   help="print this host's shard of the grid and exit")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    store = TableStore(args.store) if args.store else TableStore()

    if args.merge_from is not None:     # merge needs no grid enumeration
        stats = merge_shards(store, args.merge_from)
        out = {"mode": "merge", "store": str(store.root), "stats": stats}
        print(json.dumps(out) if args.as_json else
              f"[sweep] merged {len(args.merge_from)} shard dir(s) into "
              f"{store.root}: {stats}")
        return 0

    if args.retune:
        from repro_torch.tune import autotune
        if not store.persist:
            print("[sweep] --retune on a memory-only store: measuring "
                  "without persisting", file=sys.stderr)
        autotune(store.root if store.persist else None, smoke=True,
                 device=args.device)

    jobs = paper_grid(args.preset, nafs=args.nafs, tables=args.tables)
    if args.limit is not None:
        jobs = jobs[:args.limit]
    # execution-knob precedence: flag > $REPRO_TORCH_SEARCH_BACKEND > the
    # tuned config next to the store > built-in defaults.  The flags are
    # stamped first; the store then fills what they left None from its
    # tuned config (and activates its process-level floors and launch).
    # Execution knobs only — job.key() ignores them, so the shard
    # partition and the store rendezvous are unchanged.
    stamp = {}
    if args.backend == "torch" and args.device is not None:
        stamp["search_backend"] = TorchSearchBackend(args.device)
    elif args.backend is not None:
        stamp["search_backend"] = args.backend
    if args.speculate is not None:
        stamp["speculate"] = args.speculate
    jobs = [store._apply_tuned(dataclasses.replace(j, **stamp))
            for j in jobs]
    tuned = None
    if store.persist:
        from repro_torch.tune import resolve_tuned
        tuned = resolve_tuned(store.root)

    if args.list:
        # live mode has no partition: list the whole grid
        mine = (shard_jobs(jobs, args.hosts, args.host_id)
                if args.mode == "sharded"
                else [(j.key(), j.resolved()) for j in
                      dict((j.key(), j) for j in jobs).values()])
        rows = []
        for key, job in mine:
            # claim status makes a wedged sweep visible without reading
            # lease files by hand: free / claimed-by-<owner> / stale(...)
            state = ("stored" if store.contains(job) else
                     store.claim_status(key, ttl_s=args.claim_ttl))
            rows.append({"key": key, "naf": job.naf,
                         "scheme": job.scheme.tag,
                         "w_in": job.cfg.w_in, "w_out": job.cfg.w_out,
                         "state": state})
        if args.as_json:
            print(json.dumps({"mode": args.mode, "store": str(store.root),
                              "tuned": (dataclasses.asdict(tuned)
                                        if tuned else None),
                              "jobs": rows}))
        else:
            for r in rows:
                print(f"{r['key']}  {r['naf']:<12} {r['scheme']:<14} "
                      f"w{r['w_in']}->w{r['w_out']}  {r['state']}")
            scope = (f"shard {args.host_id}/{args.hosts}"
                     if args.mode == "sharded" else "live grid")
            print(f"[sweep] {scope}: {len(mine)} of {len(jobs)} unique "
                  f"jobs on {store.root}")
            print(f"[sweep] tuned config: "
                  f"{tuned.summary() if tuned else 'none for this device'}")
        return 0

    if args.mode == "live":
        report = run_live(jobs, store=store, workers=args.hosts,
                          worker_id=args.host_id, processes=args.processes,
                          claim_ttl_s=args.claim_ttl, owner=args.owner,
                          drain=not args.no_drain, poll_s=args.poll,
                          max_wait_s=args.max_wait)
        if args.as_json:
            print(json.dumps(dataclasses.asdict(report)))
        else:
            print(f"[sweep] live worker {report.host_id} on {store.root}: "
                  f"{len(report.compiled)} compiled, "
                  f"{len(report.loaded)} found stored, "
                  f"{len(report.taken_over)} stale claims taken over, "
                  f"{len(report.deferred)} deferred, "
                  f"{report.passes} passes "
                  f"({report.waited_s:.1f}s parked) "
                  f"in {report.wall_s:.1f}s -> {report.manifest_name}")
        return 0 if not report.deferred else 3

    report = run_shard(jobs, hosts=args.hosts, host_id=args.host_id,
                       store=store, processes=args.processes,
                       claim_ttl_s=args.claim_ttl, owner=args.owner)
    if args.as_json:
        print(json.dumps(dataclasses.asdict(report)))
    else:
        print(f"[sweep] shard {report.host_id}/{report.hosts} on "
              f"{store.root}: {len(report.compiled)} compiled, "
              f"{len(report.loaded)} resumed from store, "
              f"{len(report.deferred)} deferred (live claims), "
              f"{len(report.taken_over)} stale claims taken over "
              f"in {report.wall_s:.1f}s -> {report.manifest_name}")
    # deferred keys mean the sweep is not complete from this host's view
    return 0 if not report.deferred else 3


if __name__ == "__main__":
    sys.exit(main())
