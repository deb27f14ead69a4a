"""The port's multi-host sweep against the JAX package's, on the CPU.

* ``shard_of`` and ``shard_jobs`` put every key on the reference's shard
  (the small grid, the smoke preset and the whole paper grid);
* a two-host ``run_shard`` plus merge and a two-worker spawned
  ``run_live`` give stores bit-identical to a serial compile, each key
  compiled once, with artifacts byte-equal to the reference's sweep of the
  same grid;
* the batch pool runs in spawned workers and records each job's pid and
  backend;
* a stale claim is taken over, a killed shard resumes, and a manifest of
  another compile version is refused, as in the reference.

Stores are written only under ``tmp_path``."""

import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import repro.compiler as RC  # noqa: E402
import repro.core as RK  # noqa: E402
from repro_torch.compiler import (CompileJob, TableStore,  # noqa: E402
                                  compile_batch, paper_grid, run_shard,
                                  run_live_workers, shard_jobs, shard_of,
                                  simulate_hosts)
from repro_torch.core import FWLConfig, PPAScheme  # noqa: E402

CFG = (7, 7, (7,), (7,), 7)
#: two quick NAFs x two quantizers: four keys, on both shards of two hosts
NAFS = ("tanh", "exp2_frac")


def _jobs():
    """Small mixed grid, with a duplicate design point (same store key)."""
    out = [CompileJob(naf=n, cfg=FWLConfig(*CFG),
                      scheme=PPAScheme(1, None, q))
           for n in NAFS for q in ("fqa", "qpa")]
    out.append(out[0])
    return out


def _ref_jobs():
    out = [RC.CompileJob(naf=n, cfg=RK.FWLConfig(*CFG),
                         scheme=RK.PPAScheme(1, None, q))
           for n in NAFS for q in ("fqa", "qpa")]
    out.append(out[0])
    return out


def _files(root):
    return {p.name: p.read_bytes() for p in sorted(root.glob("*.json"))}


@pytest.fixture(scope="module")
def ref_serial(tmp_path_factory):
    """The reference's serial compile of the small grid: its files."""
    root = tmp_path_factory.mktemp("ref_serial")
    RC.compile_batch(_ref_jobs(), store=RC.TableStore(root), processes=1)
    return _files(root)


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    """The port's serial compile of the small grid: its store."""
    store = TableStore(tmp_path_factory.mktemp("serial"))
    compile_batch(_jobs(), store=store, processes=1)
    return store


@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
def test_shards_agree_with_reference(hosts):
    grids = [(_jobs(), _ref_jobs()),
             (paper_grid("smoke"), RC.paper_grid("smoke")),
             (paper_grid("paper"), RC.paper_grid("paper"))]
    for ours, ref in grids:
        assert [j.key() for j in ours] == [j.key() for j in ref]
        for i in range(hosts):
            got = [k for k, _ in shard_jobs(ours, hosts, i)]
            assert got == [k for k, _ in RC.shard_jobs(ref, hosts, i)]
            assert all(shard_of(k, hosts) == RC.shard_of(k, hosts) == i
                       for k in got)
    with pytest.raises(ValueError):
        shard_jobs(_jobs(), 2, 2)


def test_two_host_shard_merge_is_serial_and_reference(tmp_path, serial,
                                                      ref_serial):
    jobs = _jobs()
    n_unique = len({j.key() for j in jobs})
    assert serial.compiles == n_unique
    merged, reports, stats = simulate_hosts(jobs, hosts=2,
                                            root=tmp_path / "sim",
                                            processes=1)
    assert sum(len(r.compiled) for r in reports) == n_unique
    assert all(r.compiled for r in reports)       # both hosts had work
    assert not any(r.deferred for r in reports)
    assert stats["imported"] == n_unique
    assert _files(merged.root) == _files(serial.root) == ref_serial
    # the reference's own two-host sweep of the grid, file for file
    rmerged, _, _ = RC.simulate_hosts(_ref_jobs(), hosts=2,
                                      root=tmp_path / "ref_sim",
                                      processes=1)
    assert _files(rmerged.root) == _files(merged.root)
    for host in ("host0", "host1"):
        assert _files(tmp_path / "sim" / host) == \
            _files(tmp_path / "ref_sim" / host)
    again = TableStore(merged.root)
    assert all(again.lookup(j) is not None for j in jobs)
    assert again.compiles == 0


def test_two_spawned_live_workers_are_serial(tmp_path, ref_serial):
    """Two spawned workers (each its own process, as on the card) steal
    from one shared directory: every key compiled once grid-wide, no
    claim left, the store the serial one."""
    jobs = _jobs()
    keys = {j.key() for j in jobs}
    shared = tmp_path / "shared"
    reports = run_live_workers(jobs, shared, workers=2, processes=1,
                               claim_ttl_s=3600.0)
    compiled = [k for r in reports for k in r.compiled]
    assert sorted(compiled) == sorted(keys)
    assert not any(r.deferred or r.taken_over for r in reports)
    workers = [w for r in reports for w in r.compiled_by.values()]
    assert len(workers) == len(keys)
    assert os.getpid() not in {w["pid"] for w in workers}
    assert {(w["backend"], w["dispatches"]) for w in workers} == {
        ("numpy", 0)}
    for r in reports:
        assert set(r.keys) == keys
        assert (shared / r.manifest_name).exists()
    assert _files(shared) == ref_serial
    assert not list(shared.glob("*.claim"))


def test_batch_pool_is_spawned_and_logs_workers(tmp_path, serial):
    """``compile_batch`` over two worker processes: each job's worker pid
    (never this process's) and backend are recorded, and the tables are
    the serial ones."""
    store = TableStore(tmp_path / "pool")
    jobs = _jobs()
    compile_batch(jobs, store=store, processes=2)
    assert len(store.compiled_by) == len({j.key() for j in jobs})
    workers = list(store.compiled_by.values())
    assert os.getpid() not in {w["pid"] for w in workers}
    assert {w["backend"] for w in workers} == {"numpy"}
    assert _files(store.root) == _files(serial.root)


def _age_claim(store, key):
    claim = store._claim_path(key)
    blob = json.loads(claim.read_text())
    blob["time"] = time.time() - 1000.0
    claim.write_text(json.dumps(blob))


def test_stale_claim_is_taken_over(tmp_path):
    jobs = _jobs()[:2]
    store = TableStore(tmp_path / "shared")
    dead = jobs[1].key()
    assert store.try_claim(dead, owner="dead-host")
    _age_claim(store, dead)
    report = run_shard(jobs, hosts=1, host_id=0, store=store, processes=1,
                       claim_ttl_s=1.0, owner="survivor")
    assert dead in report.taken_over and dead in report.compiled
    assert not report.deferred
    assert store.claim_info(dead) is None
    assert store.lookup(jobs[1]) is not None
    # without a ttl a live foreign claim defers the key instead
    other = TableStore(tmp_path / "other")
    assert other.try_claim(jobs[0].key(), owner="busy-host")
    rep = run_shard(jobs[:1], store=other, processes=1, owner="me")
    assert rep.deferred == [jobs[0].key()] and not rep.compiled


def test_killed_shard_resumes(tmp_path):
    jobs = _jobs()
    mine = shard_jobs(jobs, 1, 0)
    first = run_shard([job for _, job in mine[:3]], store=TableStore(
        tmp_path / "h0"), processes=1)
    assert len(first.compiled) == 3
    store = TableStore(tmp_path / "h0")
    report = run_shard(jobs, store=store, processes=1)
    assert set(report.loaded) == set(first.compiled)
    assert len(report.compiled) == store.compiles == len(mine) - 3
    man = json.loads((store.root / report.manifest_name).read_text())
    assert set(man["keys"]) == {k for k, _ in mine}
    assert man["v"] == CompileJob.VERSION


def test_manifest_of_another_version_is_refused(tmp_path):
    """Both packages refuse the same foreign-version shard with the same
    merge stats, and import nothing from it."""
    jobs = _jobs()[:2]
    src = TableStore(tmp_path / "src")
    run_shard(jobs, store=src, processes=1)
    n = len({j.key() for j in jobs})
    man_path = next(src.root.glob("*.manifest"))
    man = json.loads(man_path.read_text())
    man["v"] = CompileJob.VERSION + 1
    man_path.write_text(json.dumps(man))
    for require in (False, True):
        ours = TableStore(tmp_path / f"dst{require}")
        ref = RC.TableStore(tmp_path / f"ref{require}")
        stats = ours.merge(src.root, require_manifest=require)
        assert stats == ref.merge(src.root, require_manifest=require)
        assert stats["imported"] == 0 and stats["skipped_version"] == n
        assert not list(ours.root.glob("*.json"))
