"""The port's sweep CLI (``scripts/torch_sweep.py``) on the CPU.

* two hosts of the smoke grid (one on numpy, one on ``torch`` scanning on
  the CPU) plus ``--merge-from`` give, byte for byte, the host stores and
  the merged store that the reference's CLI (``scripts/sweep.py``) gives
  with the same arguments, and ``run_shard``'s serial store;
* a key under another host's live claim is deferred, and the CLI exits 3
  in sharded and live mode as the reference's does, with the same report
  and the same ``--list`` rows;
* ``--retune`` runs the port's tuner, and the tuned config (its
  ``fused_launch`` included) is listed and drives the compiles;
* the backend that compiles follows the reference CLI's precedence:
  ``--backend``, then ``$REPRO_TORCH_SEARCH_BACKEND``, then the tuned
  file.

Stores are written only under ``tmp_path``; only 7-bit tables compile."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.compiler import (CompileJob, TableStore,  # noqa: E402
                                  paper_grid, run_shard)
from repro_torch.core import FWLConfig, PPAScheme  # noqa: E402
from repro_torch.core.searchspace import BACKEND_ENV  # noqa: E402
from repro_torch.kernels import fused  # noqa: E402
from repro_torch.tune import config as tune_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "torch_sweep.py"
#: the smoke preset cut to two NAFs: six keys, on both shards of two hosts
NAFS = ("tanh", "exp2_frac")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cli = _load("torch_sweep", SCRIPT)
#: the reference's CLI, the JAX package's ``scripts/sweep.py``
ref_cli = _load("ref_sweep", ROOT / "scripts" / "sweep.py")


@pytest.fixture(autouse=True)
def _restore(monkeypatch):
    """``--retune`` and a tuned store activate process defaults: put them
    back."""
    from repro_torch.core import TorchSearchBackend
    floors = {k: getattr(TorchSearchBackend, k)
              for k in ("K_FLOOR", "G_FLOOR", "BATCH_ELEMS")}
    launch = fused.default_launch()
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    yield
    for k, v in floors.items():
        setattr(TorchSearchBackend, k, v)
    fused.set_default_launch(launch)
    tune_config._ACTIVE = None
    tune_config._RESOLVE_CACHE.clear()


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _artifacts(root):
    return {p.name: p.read_bytes() for p in sorted(root.glob("*.json"))}


def _report(r):
    """A shard report without what differs from run to run."""
    return {k: v for k, v in r.items()
            if k not in ("compiled_by", "wall_s", "owner")}


def test_two_hosts_and_merge_equal_the_serial_store(tmp_path, capsys):
    smoke = ["--preset", "smoke", "--nafs", *NAFS, "--hosts", "2",
             "--processes", "1", "--json"]
    assert cli.main([*smoke, "--host-id", "0", "--backend", "numpy",
                     "--store", str(tmp_path / "h0")]) == 0
    r0 = _json(capsys)
    assert cli.main([*smoke, "--host-id", "1", "--backend", "torch",
                     "--device", "cpu", "--store", str(tmp_path / "h1")]) == 0
    r1 = _json(capsys)
    assert {w["backend"] for w in r0["compiled_by"].values()} == {"numpy"}
    assert {w["backend"] for w in r1["compiled_by"].values()} == {
        "torch@cpu"}
    assert cli.main(["--store", str(tmp_path / "merged"), "--merge-from",
                     str(tmp_path / "h0"), str(tmp_path / "h1"),
                     "--json"]) == 0
    merge = _json(capsys)
    assert merge["stats"]["imported"] == 6
    # the reference's CLI, the same arguments (its hosts on numpy)
    ref = []
    for i in (0, 1):
        assert ref_cli.main([*smoke, "--host-id", str(i), "--backend",
                             "numpy", "--store",
                             str(tmp_path / f"ref_h{i}")]) == 0
        ref.append(_json(capsys))
    assert ref_cli.main(["--store", str(tmp_path / "ref_merged"),
                         "--merge-from", str(tmp_path / "ref_h0"),
                         str(tmp_path / "ref_h1"), "--json"]) == 0
    assert merge["stats"] == _json(capsys)["stats"]
    for ours, theirs, i in ((r0, ref[0], 0), (r1, ref[1], 1)):
        assert ours["compiled"] and _report(ours) == _report(theirs)
        assert _artifacts(tmp_path / f"h{i}") == _artifacts(
            tmp_path / f"ref_h{i}")
    assert _artifacts(tmp_path / "merged") == _artifacts(
        tmp_path / "ref_merged")
    jobs = paper_grid("smoke", nafs=NAFS)
    serial = run_shard(jobs, store=TableStore(tmp_path / "serial"),
                       processes=1)
    assert sorted(r0["compiled"] + r1["compiled"]) == sorted(serial.compiled)
    assert _artifacts(tmp_path / "merged") == _artifacts(tmp_path / "serial")
    # a re-run resumes: nothing compiles
    assert cli.main([*smoke, "--host-id", "0", "--store",
                     str(tmp_path / "h0")]) == 0
    again = _json(capsys)
    assert again["compiled"] == [] and sorted(again["loaded"]) == sorted(
        r0["compiled"])


@pytest.mark.parametrize("mode", ["sharded", "live"])
def test_a_deferred_key_exits_3(tmp_path, capsys, mode):
    """A key under another host's live claim (no TTL: never taken over)
    is deferred; the rest compiles, ``--list`` shows the claim, and the
    exit code is 3 — through the script's own entry point too."""
    store = TableStore(tmp_path)
    job = CompileJob("tanh", FWLConfig(7, 7, (7,), (7,), 7),
                     PPAScheme(1, None, "fqa"))
    assert store.try_claim(job.key(), owner="other-host")
    args = ["--preset", "smoke", "--nafs", "tanh", "--mode", mode,
            "--store", str(tmp_path), "--processes", "1", "--json"]
    if mode == "live":
        args.append("--no-drain")
    assert cli.main(args) == 3
    report = _json(capsys)
    assert report["deferred"] == [job.key()]
    assert len(report["compiled"]) == 2
    listing = ["--preset", "smoke", "--nafs", "tanh", "--mode", mode,
               "--list", "--json"]
    assert cli.main([*listing, "--store", str(tmp_path)]) == 0
    rows = _json(capsys)["jobs"]
    states = {r["key"]: r["state"] for r in rows}
    assert states.pop(job.key()) == "claimed-by-other-host"
    assert set(states.values()) == {"stored"}
    # the reference's CLI on the same claim: the same exit code, report
    # and listing
    import repro.compiler as RC
    import repro.core as RK
    ref_store = tmp_path / "ref"
    assert RC.TableStore(ref_store).try_claim(RC.CompileJob(
        "tanh", RK.FWLConfig(7, 7, (7,), (7,), 7),
        RK.PPAScheme(1, None, "fqa")).key(), owner="other-host")
    ref_args = [*args[:args.index("--store")], "--store", str(ref_store),
                *args[args.index("--store") + 2:]]
    assert ref_cli.main(ref_args) == 3
    ref_report = _json(capsys)
    assert sorted(ref_report["compiled"]) == sorted(report["compiled"])
    assert ref_report["deferred"] == report["deferred"]
    assert _artifacts(ref_store) == _artifacts(tmp_path)
    assert ref_cli.main([*listing, "--store", str(ref_store)]) == 0
    assert _json(capsys)["jobs"] == rows
    if mode == "sharded":
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop(BACKEND_ENV, None)
        out = subprocess.run([sys.executable, str(SCRIPT), *args], env=env,
                             cwd=tmp_path, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 3, out.stderr
        assert json.loads(out.stdout)["deferred"] == [job.key()]


def test_retune_persists_and_drives_the_sweep(tmp_path, capsys):
    """``--retune --device cpu`` runs the tuner (stage 3 records the
    default launch off a card) and persists it next to the store; the
    listing shows it, and an explicit ``--backend`` still wins."""
    assert cli.main(["--preset", "smoke", "--nafs", "tanh", "--store",
                     str(tmp_path), "--retune", "--device", "cpu",
                     "--list", "--json"]) == 0
    listed = _json(capsys)
    tuned = listed["tuned"]
    assert tuned["device"] == "cpu/host"
    assert tuned["fused_launch"] == list(fused.DEFAULT_LAUNCH)
    assert fused.default_launch() == fused.DEFAULT_LAUNCH
    assert {r["state"] for r in listed["jobs"]} == {"free"}
    assert cli.main(["--preset", "smoke", "--nafs", "tanh", "--store",
                     str(tmp_path), "--backend", "numpy", "--processes",
                     "1", "--json"]) == 0
    report = _json(capsys)
    assert {w["backend"] for w in report["compiled_by"].values()} == {
        "numpy"}


@pytest.mark.parametrize("flag, env, want", [
    (None, None, "torch@cpu"),            # the tuned file
    (None, "numpy", "numpy"),             # the variable beats the file
    ("torch", "numpy", "torch@cpu"),      # the flag beats the variable
    ("numpy", None, "numpy"),             # the flag beats the file
])
def test_knob_precedence_flag_env_tuned(tmp_path, capsys, monkeypatch,
                                        flag, env, want):
    """Which backend compiles: ``--backend`` over
    ``$REPRO_TORCH_SEARCH_BACKEND`` over the tuned file next to the store
    (here one that names ``torch`` on the host), as in the reference's
    CLI."""
    tune_config.save_tuned(tune_config.TunedConfig(
        device="cpu/host", search_backend="torch", speculate=0), tmp_path)
    if env is not None:
        monkeypatch.setenv(BACKEND_ENV, env)
    args = ["--preset", "smoke", "--nafs", "tanh", "--store", str(tmp_path),
            "--processes", "1", "--json"]
    if flag is not None:
        args += ["--backend", flag, "--device", "cpu"]
    assert cli.main(args) == 0
    report = _json(capsys)
    assert len(report["compiled"]) == 3
    assert {w["backend"] for w in report["compiled_by"].values()} == {want}
