#!/usr/bin/env python3
"""How the six 8-bit deployment tables compile on the card as the sweep
spreads them over processes.

  python3 scripts/torch_sweep_study.py [--arms serial shard2 shard3
                                               live1 live2]

Each arm compiles ``ppa_table_jobs("ppa8")`` on ``TorchSearchBackend`` into
fresh stores under ``build/sweep_study`` and prints one JSON object: its
wall seconds, and for each key the worker's pid, dispatches, compile
seconds and milliseconds a dispatch.  ``serial``: one spawned process
compiles the six in turn (``compile_batch(processes=1)`` inside
``run_live_workers(workers=1)``, so the study's own process holds no CUDA
context); ``shardP``: ``run_shard`` on two simulated hosts at once (two
threads), each with a pool of P spawned processes; ``liveP``: two spawned
``run_live`` workers on one directory, P compile processes each.  Every
arm's tables must be the serial arm's (``table_identity``).  Then the
card's name and power limit.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def workers_of(reports, jobs):
    naf = {j.key(): j.naf for j in jobs}
    out = []
    for r in reports:
        for key, w in r.compiled_by.items():
            out.append({"owner": r.owner, "naf": naf[key], **w,
                        "ms_a_dispatch": 1e3 * w["seconds"]
                        / max(w["dispatches"], 1)})
    return sorted(out, key=lambda w: (w["owner"], w["naf"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", nargs="+",
                    default=["serial", "shard2", "shard3", "live1",
                             "live2"])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_sweep_study: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.compiler import (CompileJob, TableStore, merge_shards,
                                      run_live_workers, run_shard,
                                      table_identity)
    from repro_torch.models import ppa_table_jobs

    jobs = [CompileJob(naf, cfg, scheme, search_backend="torch")
            for naf, cfg, scheme in ppa_table_jobs("ppa8")]
    root = ROOT / "build" / "sweep_study"
    shutil.rmtree(root, ignore_errors=True)
    want = None
    for arm in args.arms:
        d = root / arm
        t0 = time.perf_counter()
        if arm == "serial" or arm.startswith("live"):
            n, p = (1, 1) if arm == "serial" else (2, int(arm[4:]))
            reports = run_live_workers(jobs, d, workers=n, processes=p,
                                       claim_ttl_s=900.0)
            store = TableStore(d)
        else:
            p = int(arm[5:])

            def host(i, p=p, d=d):
                return run_shard(jobs, hosts=2, host_id=i,
                                 store=TableStore(d / f"host{i}"),
                                 processes=p, owner=f"host{i}")

            with ThreadPoolExecutor(2) as ex:
                reports = list(ex.map(host, range(2)))
            store = TableStore(d / "merged")
            merge_shards(store, [d / "host0", d / "host1"])
        wall = time.perf_counter() - t0
        tabs = {j.naf: table_identity(store.lookup(j)) for j in jobs}
        if want is None:
            want = tabs
        elif tabs != want:
            raise AssertionError(f"{arm}: tables differ from the first "
                                 "arm's")
        print(json.dumps({"arm": arm, "wall_s": wall,
                          "workers": workers_of(reports, jobs)}),
              flush=True)
    shutil.rmtree(root, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
