"""The port's chaos harness (``scripts/torch_chaos.py``) on the CPU.

``--smoke --device cpu`` runs its three legs at the smoke size: the live
sweep under three armed crash workers and a survivor (each a fresh
interpreter armed through ``REPRO_TORCH_FAILPOINTS``, the exactly-once
ledger through ``REPRO_TORCH_FAULTS_LEDGER``), the killed merge, and the
serve leg on internlm2-1.8b's smoke config.  The serve leg's gates are
shown to fire: a second degraded tenant fails it.  The live sweep's and
the merge's stores are held, file for file, to the reference's serial
compile of the same grid (``repro.compiler.compile_batch``), so the
harness's own serial baseline is not the only witness.  Stores are written
only under ``tmp_path``; only 7-bit tables compile, and the serve leg's
tables are the shipped ones."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import faults  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "torch_chaos.py"


def _load():
    spec = importlib.util.spec_from_file_location("torch_chaos", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chaos = _load()


@pytest.fixture(autouse=True)
def _disarmed():
    faults.reset()
    yield
    faults.reset()


def test_smoke_runs_every_leg_on_the_cpu(tmp_path, capsys):
    assert chaos.main(["--smoke", "--device", "cpu", "--backend", "torch",
                       "--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for leg in ("sweep", "merge", "serve"):
        assert f"chaos[{leg}]: ok" in out
    assert "each key compiled on torch@cpu by one of 4 worker processes" \
        in out
    assert "chaos: all legs ok" in out
    assert not faults.snapshot()
    # every worker's compile is in the ledger once, on the asked backend
    lines = (tmp_path / "compiles.ledger").read_text().splitlines()
    assert len(lines) == 6 and all('"torch@cpu"' in ln for ln in lines)
    # the reference's serial compile of the same grid, byte for byte
    import repro.compiler as RC
    ref = tmp_path / "reference"
    RC.compile_batch(RC.paper_grid("smoke", nafs=chaos._NAFS),
                     store=RC.TableStore(ref), processes=1)
    want = _artifacts(ref)
    assert len(want) == 6
    for leg in ("serial", "live", "merged"):
        assert _artifacts(tmp_path / leg) == want, leg


def _artifacts(root):
    return {p.name: p.read_bytes() for p in sorted(root.glob("*.json"))}


@pytest.fixture(scope="module")
def model():
    return chaos._serve_model("internlm2-1.8b", 1, "cpu")


def test_serve_leg_keeps_the_tokens_and_reaps(tmp_path, model):
    cfg, params, dev = model
    store = chaos.seeded_store(tmp_path)
    seen = []
    out = chaos.serve_leg(store, cfg, params, device=dev,
                          hook=lambda front: seen.append(sorted(
                              front.engines)), log=lambda _: None)
    assert seen == [["a", "c"]]
    assert len(out["tokens"]) == 3 and all(len(t) == 3
                                           for t in out["tokens"])
    assert out["doomed"].timed_out and out["doomed"].output == []
    assert set(out["front"].degraded) == {"b"}


def test_serve_leg_fails_when_another_tenant_degrades(tmp_path, model):
    """Only the armed tenant may degrade: a second degradation (as a
    failed kernel build would cause) fails the leg."""
    from repro_torch.serve import TenantSpec
    cfg, params, dev = model
    store = chaos.seeded_store(tmp_path)

    def hook(front):
        front.add_tenant(TenantSpec("d", cfg, params), warm=False)
        front._degrade("d", "injected")

    with pytest.raises(AssertionError, match="only b was armed"):
        chaos.serve_leg(store, cfg, params, device=dev, hook=hook,
                        log=lambda _: None)
