#!/usr/bin/env python
"""Chaos harness of the PyTorch port: crash-inject its sweep, store and
serve tiers, and prove they recover.

  python scripts/torch_chaos.py --smoke [--backend numpy|torch]
      [--device cpu] [--arch ARCH] [--layers N] [--serve-store DIR]
      [--root DIR]

runs the three legs of ``scripts/chaos.py`` against the port, arming the
port's failpoints (``REPRO_TORCH_FAILPOINTS``, ``REPRO_TORCH_FAULTS_LEDGER``,
``REPRO_TORCH_FAULTS_SEED`` in each worker's environment):

**Live-sweep leg** — the work-stealing sweep under worker murder.  A
serial baseline compiles the smoke grid (sigmoid and tanh, six keys) into
one store on the numpy backend; then three *crash workers* run the live
sweep against a second (shared) store, each a fresh interpreter armed to
die by ``os._exit(86)`` at a distinct point of the claim -> compile ->
publish -> release pipeline:

* ``compile.job:after=1:exit``        mid-compile (claim held, nothing
  published — the takeover-and-recompile case)
* ``sweep.wave.claimed:every=2:exit`` after the lease lands, before any
  compile (a claim with no work behind it)
* ``sweep.wave.published:once:exit``  after the durable publish, before
  the release (a stored key under a dead lease)

A survivor, a fresh interpreter too, then drains the grid (stale-claim
takeover via the claim TTL).  Every worker scans on ``--backend`` (on
``--device``; ``torch`` with no device is the card).  The harness asserts
the grid is complete, every artifact byte-identical to the serial
baseline, nothing quarantined, and — via a ledger ``count`` arm on
``compile.job.done``, which fires only *after* a durable publish, and
whose line names the compiling process and backend — that every key was
compiled exactly once, by a worker process on the asked-for backend.

**Merge leg** — a merge worker dies mid-import (``store.merge.file``); a
clean re-merge must finish the union with the same bytes.

**Serve leg** — one tenant's warm-up is made to fail
(``serve.tenant.warm``) and a request on another expires its deadline;
the healthy tenant's greedy tokens must equal a fault-free run's, the
degraded tenant's submits must reject (not hang), only it may degrade,
and the expired request must be reaped with its partial output kept.
The model is ``--arch``'s smoke config on the CPU and its published width
on the card (``--layers`` cuts the depth; bf16), with ``act_impl="ppa"``;
its tables come from ``--serve-store``, or from a store seeded with the
shipped tables (nothing compiles).

Internal re-exec modes (armed via the environment): ``--worker`` runs one
live-sweep worker; ``--merge-worker`` runs one store merge.  The legs are
also functions (``sweep_leg``, ``merge_leg``, ``serve_leg``) for a caller
that loads this file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch import faults  # noqa: E402
from repro_torch.compiler import (CompileJob, TableStore,  # noqa: E402
                                  compile_batch, paper_grid, run_live)

#: fixed smoke slice — every process re-derives the identical grid
_NAFS = ("sigmoid", "tanh")
_TTL = 2.0
#: the exit code of an ``exit`` failpoint
_CRASH_RC = 86
#: each worker's time limit (a hung worker fails the leg, not the caller)
_WORKER_TIMEOUT_S = 600
CRASHES = (
    ("crash-midcompile", "compile.job:after=1:exit"),
    ("crash-postclaim", "sweep.wave.claimed:every=2:exit"),
    ("crash-postpublish", "sweep.wave.published:once:exit"),
)


def _grid():
    return paper_grid("smoke", nafs=_NAFS)


def backend_label(backend: str, device) -> str:
    """The ``compiled_by`` label a worker on ``backend``/``device`` gives."""
    if backend != "torch":
        return backend
    import torch
    dev = torch.device(device) if device is not None else torch.device(
        "cuda")
    return f"torch@{dev}"


def _stamped(jobs, backend: str, device):
    """The jobs with this process's search backend stamped in."""
    if backend == "torch":
        from repro_torch.core import TorchSearchBackend
        be = TorchSearchBackend(device)
    else:
        be = backend
    return [dataclasses.replace(j, search_backend=be) for j in jobs]


def _worker_env(spec: str, ledger: Path) -> dict:
    env = dict(os.environ)
    env[faults.ENV] = ",".join(
        s for s in (spec, "compile.job.done:always:count") if s)
    env[faults.LEDGER_ENV] = str(ledger)
    env.setdefault(faults.SEED_ENV, "0")
    env["PYTHONPATH"] = str(REPO / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _spawn(argv, env) -> int:
    return subprocess.run([sys.executable, __file__, *argv], env=env,
                          cwd=REPO, timeout=_WORKER_TIMEOUT_S).returncode


def _run_worker(args) -> int:
    jobs = _stamped(_grid(), args.backend, args.device)
    report = run_live(jobs, store=TableStore(args.store), processes=1,
                      claim_ttl_s=args.ttl, owner=args.owner,
                      drain=args.drain,
                      max_wait_s=None if args.drain else 0.5)
    return 3 if report.deferred else 0


def _run_merge_worker(args) -> int:
    TableStore(args.dst).merge(args.src)
    return 0


# ------------------------------------------------------------ sweep leg
def sweep_leg(root: Path, *, backend: str = "numpy", device=None,
              log=print) -> dict:
    """The live sweep under three worker crashes and a survivor, every
    worker a fresh interpreter on ``backend``/``device``.  Returns the
    leg's figures (keys, workers, seconds)."""
    t0 = time.perf_counter()
    jobs = _grid()
    log(f"chaos[sweep]: grid = {len(jobs)} jobs, workers on "
        f"{backend_label(backend, device)}")
    serial_dir, live_dir = root / "serial", root / "live"
    ledger = root / "compiles.ledger"
    compile_batch(jobs, store=TableStore(serial_dir), processes=1)

    where = ["--backend", backend] + (
        ["--device", str(device)] if device is not None else [])
    for owner, spec in CRASHES:
        rc = _spawn(["--worker", "--store", str(live_dir), "--owner", owner,
                     "--ttl", str(_TTL), *where], _worker_env(spec, ledger))
        if rc != _CRASH_RC:
            raise AssertionError(
                f"{owner} should die at its failpoint (exit {_CRASH_RC}), "
                f"got {rc} — the injected crash never fired")
        log(f"chaos[sweep]: {owner} died as armed ({spec})")
    # the survivor: ledger-armed, drains and takes over the dead leases
    rc = _spawn(["--worker", "--store", str(live_dir), "--owner", "survivor",
                 "--ttl", str(_TTL), "--drain", *where],
                _worker_env("", ledger))
    if rc != 0:
        raise AssertionError(f"the survivor exited {rc}: work left behind")

    live = TableStore(live_dir)
    stored_names = {}
    for job in jobs:
        j = job.resolved()
        key = j.key()
        if not live.contains(j):
            raise AssertionError(f"grid incomplete: {key} missing")
        stored_names[key] = live._path(j, key).name
    for key, name in stored_names.items():
        if (serial_dir / name).read_bytes() != (live_dir / name).read_bytes():
            raise AssertionError(f"artifact {name} differs from the serial "
                                 "baseline")
    if live.quarantine_dir.exists() and any(live.quarantine_dir.iterdir()):
        raise AssertionError("the chaos run quarantined files")
    # orphan leases on *stored* keys are harmless (a worker that died
    # between publish and release); a lease on a missing key is not
    for c in sorted(live_dir.glob("*.claim")):
        if c.name[:-len(".claim")] not in stored_names:
            raise AssertionError(f"leftover claim on an unstored key: "
                                 f"{c.name}")
    lines = [json.loads(ln) for ln in
             ledger.read_text().strip().splitlines()]
    done = [ln for ln in lines if ln["fp"] == "compile.job.done"]
    keys = [ln["key"] for ln in done]
    if len(keys) != len(set(keys)):
        raise AssertionError("a key compiled twice: " + str(sorted(
            k for k in set(keys) if keys.count(k) > 1)))
    if set(keys) != set(stored_names):
        raise AssertionError(
            "the ledger does not cover the grid exactly once: missing="
            f"{set(stored_names) - set(keys)} extra="
            f"{set(keys) - set(stored_names)}")
    label = backend_label(backend, device)
    pids = {ln["pid"] for ln in done}
    if any(ln["backend"] != label for ln in done) or os.getpid() in pids:
        raise AssertionError(f"not every key was compiled on {label} by a "
                             f"worker process: {done}")
    sec = time.perf_counter() - t0
    log(f"chaos[sweep]: ok — {len(jobs)} keys, 3 injected crashes, "
        f"bit-identical to serial, exactly-once ledger; each key compiled "
        f"on {label} by one of {len(pids)} worker processes; {sec:.3f} s")
    return {"keys": len(jobs), "workers": len(pids), "backend": label,
            "seconds": sec}


# ------------------------------------------------------------ merge leg
def merge_leg(root: Path, *, log=print) -> dict:
    """A merge worker killed after two files; a clean re-merge finishes
    the union with the source's bytes.  Needs ``sweep_leg``'s serial
    store under ``root`` (or compiles it)."""
    t0 = time.perf_counter()
    jobs = _grid()
    src, dst = root / "serial", root / "merged"
    if not src.exists():
        compile_batch(jobs, store=TableStore(src), processes=1)
    dst.mkdir(parents=True, exist_ok=True)
    rc = _spawn(["--merge-worker", "--src", str(src), "--dst", str(dst)],
                _worker_env("store.merge.file:after=2:exit",
                            root / "m.ledger"))
    if rc != _CRASH_RC:
        raise AssertionError(f"the merge worker should die mid-merge, got "
                             f"{rc}")
    stats = TableStore(dst).merge(src)    # clean retry finishes the union
    n = stats["imported"] + stats["skipped_present"]
    if n != len({j.resolved().key() for j in jobs}):
        raise AssertionError(f"re-merge incomplete: {stats}")
    for job in jobs:
        j = job.resolved()
        name = TableStore(dst)._path(j, j.key()).name
        if (dst / name).read_bytes() != (src / name).read_bytes():
            raise AssertionError(f"merged artifact {name} differs from "
                                 "the source")
    sec = time.perf_counter() - t0
    log(f"chaos[merge]: ok — worker died after 2 files, clean re-merge "
        f"finished the union ({stats}); {sec:.3f} s")
    return {"stats": stats, "seconds": sec}


# ------------------------------------------------------------ serve leg
def seeded_store(root: Path, impl: str = "ppa") -> TableStore:
    """A store under ``root`` holding the shipped tables of ``impl``."""
    from repro_torch.models import ppa_table_jobs
    from repro_torch.tables import load_table

    store = TableStore(root)
    for naf, cfg, scheme in ppa_table_jobs(impl):
        job = CompileJob(naf, cfg, scheme)
        if store.lookup(job) is None:
            store.put(job, load_table(naf, cfg.w_out))
    return store


def _default_requests(cfg, start_rid=0, deadline_s=None, n=3, max_new=3):
    """``n`` requests of 8 prompt tokens from a seeded generator, each with
    the extras ``cfg``'s model takes (``launch.serve.request_extras``)."""
    import numpy as np
    from repro_torch.launch.serve import request_extras
    from repro_torch.serve import Request

    rng = np.random.default_rng(11)
    return [Request(rid=start_rid + i,
                    prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                    max_new_tokens=max_new, deadline_s=deadline_s,
                    extra=request_extras(cfg, rng) or None)
            for i in range(n)]


def serve_leg(store: TableStore, cfg, params, *, device=None,
              requests=None, n_slots: int = 2, cache_len: int = 48,
              hook=None, log=print) -> dict:
    """Tenant ``a`` fault-free, then beside ``b`` (its warm-up armed to
    fail) and ``c`` (a request whose deadline passes).  ``requests()``
    makes a's requests afresh (default: three of 8 tokens); ``hook(front)``
    runs before the fault run's requests are submitted.  Returns a's
    tokens, the doomed request and the fault run's front."""
    from repro_torch.serve import TenantFront, TenantSpec

    t0 = time.perf_counter()
    make = requests or (lambda: _default_requests(cfg))
    spec_a = TenantSpec(name="a", cfg=cfg, params=params, n_slots=n_slots,
                        cache_len=cache_len)

    base = TenantFront(store, device=device)
    base.add_tenant(spec_a)
    base_reqs = make()
    for r in base_reqs:
        base.submit("a", r)
    base.run_until_drained()
    if base.degraded:
        raise AssertionError(f"the fault-free run degraded {base.degraded}")
    base_out = [list(r.output) for r in base_reqs]
    del base

    # fault run: b's warm-up dies, c loses a request to its deadline — a
    # must not notice either
    front = TenantFront(store, device=device)
    faults.arm("serve.tenant.warm", "once")
    try:
        rep = front.add_tenant(TenantSpec(name="b", cfg=cfg, params=params,
                                          n_slots=n_slots,
                                          cache_len=cache_len))
    finally:
        faults.reset()
    if not rep["degraded"]:
        raise AssertionError("the injected warm-up failure did not degrade "
                             "b")
    front.add_tenant(spec_a)
    front.add_tenant(TenantSpec(name="c", cfg=cfg, params=params, n_slots=1,
                                cache_len=cache_len))
    bounced = _default_requests(cfg, start_rid=90, n=1)[0]
    if front.submit("b", bounced) is not False or not (
            bounced.done and bounced.rejected == "tenant_degraded"):
        raise AssertionError("a submit to the degraded tenant did not "
                             "reject")
    doomed = _default_requests(cfg, start_rid=80, deadline_s=1e-6, n=1,
                               max_new=4)[0]
    front.submit("c", doomed)
    if hook is not None:
        hook(front)
    fault_reqs = make()
    for r in fault_reqs:
        front.submit("a", r)
    front.run_until_drained()
    if not (doomed.timed_out and doomed.done and doomed.output is not None):
        raise AssertionError("the deadline request was not reaped")
    out = [list(r.output) for r in fault_reqs]
    if out != base_out:
        raise AssertionError("the healthy tenant's tokens drifted under "
                             "neighbouring faults")
    if front.stats()["degraded"] != {"b": rep["degraded"]}:
        raise AssertionError(f"degraded tenants {front.degraded}: only b "
                             "was armed")
    sec = time.perf_counter() - t0
    log(f"chaos[serve]: ok — tenant b degraded, deadline reaped on c "
        f"({len(doomed.output)} tokens kept), tenant a token-identical to "
        f"the fault-free run ({sum(map(len, out))} tokens); {sec:.3f} s")
    return {"tokens": out, "doomed": doomed, "front": front,
            "seconds": sec}


def _serve_model(arch: str, layers, device):
    """``arch`` at act_impl="ppa": its smoke config in float32 on the CPU,
    its published width in bf16 on the card (``layers`` cuts every
    stage); random weights from seed 0."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params, param_specs

    dev = resolve_device(device)
    if dev.type == "cpu":
        cfg, dtype = get_smoke_config(arch), torch.float32
    else:
        cfg = get_config(arch).replace(compute_dtype="bfloat16")
        dtype = torch.bfloat16
    if layers is not None:
        cfg = cfg.replace(stages=tuple(
            dataclasses.replace(st, n_layers=layers) for st in cfg.stages),
            enc_layers=min(cfg.enc_layers, layers))
    cfg = cfg.replace(act_impl="ppa")
    return cfg, init_params(param_specs(cfg), 0, dtype=dtype, device=dev), \
        dev


def _smoke(args) -> int:
    root = Path(args.root) if args.root else Path(tempfile.mkdtemp(
        prefix="torch-chaos-"))
    root.mkdir(parents=True, exist_ok=True)
    print(f"chaos: scratch dir {root}")
    sweep_leg(root, backend=args.backend, device=args.device)
    merge_leg(root)
    cfg, params, dev = _serve_model(args.arch, args.layers, args.device)
    store = TableStore(args.serve_store) if args.serve_store \
        else seeded_store(root / "serve_store")
    serve_leg(store, cfg, params, device=dev)
    print("chaos: all legs ok")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--smoke", action="store_true",
                      help="run the three legs")
    mode.add_argument("--worker", action="store_true",
                      help="internal: one live-sweep worker (armed via env)")
    mode.add_argument("--merge-worker", action="store_true",
                      help="internal: one store merge (armed via env)")
    ap.add_argument("--root", default=None,
                    help="scratch dir for --smoke (default: mkdtemp)")
    ap.add_argument("--backend", choices=("numpy", "torch"),
                    default="numpy",
                    help="the sweep workers' search backend")
    ap.add_argument("--device", default=None,
                    help="where torch scans and the serve leg runs "
                         "(default: the card; 'cpu' for the host)")
    ap.add_argument("--arch", default="internlm2-1.8b",
                    help="the serve leg's model")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the serve leg's model to N layers a stage")
    ap.add_argument("--serve-store", default=None,
                    help="the serve leg's table store (default: one seeded "
                         "with the shipped tables)")
    ap.add_argument("--store", default=None, help="store dir (--worker)")
    ap.add_argument("--owner", default=None, help="claim owner (--worker)")
    ap.add_argument("--ttl", type=float, default=_TTL,
                    help="claim takeover TTL seconds (--worker)")
    ap.add_argument("--drain", action="store_true",
                    help="--worker: wait out live claims and take over "
                         "stale ones (the survivor)")
    ap.add_argument("--src", default=None, help="merge source dir")
    ap.add_argument("--dst", default=None, help="merge target dir")
    args = ap.parse_args(argv)
    if args.worker:
        return _run_worker(args)
    if args.merge_worker:
        return _run_merge_worker(args)
    return _smoke(args)


if __name__ == "__main__":
    raise SystemExit(main())
