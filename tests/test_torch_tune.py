"""The port's per-device tuner on the CPU: the ``TunedConfig`` record and
its file (apart from the JAX package's), the knob precedence of
``TableStore._apply_tuned`` (argument, then environment, then file, then
default), artifacts equal with and without a tuned config,
``autotune(smoke=True)`` with every candidate's tables equal, and the
fused kernel's launch shape (``fused_launch``: its round trip, a file
written before the field existed, the default recorded off a card).
Stores are written only under ``tmp_path``; the class-level floors and
the fused kernel's default launch a tuned config sets are restored after
every test."""

import json

import pytest

torch = pytest.importorskip("torch")

import repro.tune.config as ref_tune  # noqa: E402
from repro_torch.compiler import (CompileJob, TableStore,  # noqa: E402
                                  table_identity)
from repro_torch.core import (FWLConfig, PPAScheme,  # noqa: E402
                              TorchSearchBackend)
from repro_torch.core.searchspace import BACKEND_ENV  # noqa: E402
from repro_torch.kernels import fused  # noqa: E402
from repro_torch.tune import (TUNE_ENV, TunedConfig, activate,  # noqa: E402
                              autotune, config, device_key, load_tuned,
                              resolve_tuned, save_tuned, tuned_path)

CFG = FWLConfig(7, 7, (7,), (7,), 7)
SCHEME = PPAScheme(1, None, "fqa")
FLOORS = ("K_FLOOR", "G_FLOOR", "BATCH_ELEMS")


@pytest.fixture(autouse=True)
def _restore_tuning(monkeypatch):
    """Every floor a tuned config sets on ``TorchSearchBackend`` (class
    attributes, shared by the whole process) is put back, with the fused
    kernel's default launch, the module's active config and resolve
    cache."""
    saved = {k: getattr(TorchSearchBackend, k) for k in FLOORS}
    launch = fused.default_launch()
    active = config._ACTIVE
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    monkeypatch.delenv(TUNE_ENV, raising=False)
    yield
    for k, v in saved.items():
        setattr(TorchSearchBackend, k, v)
    fused.set_default_launch(launch)
    config._ACTIVE = active
    config._RESOLVE_CACHE.clear()


def _tuned(**kw):
    base = dict(device=device_key(), search_backend="torch", speculate=3,
                k_floor=32, g_floor=16, batch_elems=1 << 21,
                fused_launch=(256, 2),
                score={"compile_s/torch/spec3": 0.5,
                       "fused_ms/256x2/decode": 0.0026})
    return TunedConfig(**{**base, **kw})


def test_tuned_config_round_trips(tmp_path):
    cfg = _tuned()
    assert TunedConfig.from_json(cfg.to_json()) == cfg
    path = save_tuned(cfg, tmp_path)
    assert path.parent == tmp_path / "tune"
    assert load_tuned(tmp_path) == cfg == resolve_tuned(tmp_path)
    assert device_key() == "cpu/host"       # no card here
    assert load_tuned(tmp_path, "cuda/NVIDIA H100 80GB HBM3") is None
    # a config of another version is ignored, not misread
    path.write_text(json.dumps({**json.loads(cfg.to_json()), "version": 0}))
    assert load_tuned(tmp_path) is None


def test_fused_launch_round_trips_and_old_files_load(tmp_path):
    """``fused_launch`` is written as a list and read back as the tuple; a
    file written before the field existed loads with the default launch,
    and activating it puts the default in force."""
    cfg = _tuned()
    blob = json.loads(cfg.to_json())
    assert blob["fused_launch"] == [256, 2]
    save_tuned(cfg, tmp_path)
    assert load_tuned(tmp_path).fused_launch == (256, 2)
    del blob["fused_launch"]
    tuned_path(tmp_path).write_text(json.dumps(blob))
    old = load_tuned(tmp_path)
    assert old.fused_launch == fused.DEFAULT_LAUNCH == (128, 4)
    assert old == _tuned(fused_launch=(128, 4))
    fused.set_default_launch((512, 2))
    assert activate(old)["fused_launch"] == (128, 4)
    assert fused.default_launch() == (128, 4)


@pytest.mark.parametrize("launch", [(0, 4), (100, 4), (1024, 1), (512, 8),
                                    (128, 0)])
def test_fused_launch_is_checked(launch):
    """A launch the kernel cannot take is refused before any launch."""
    with pytest.raises(ValueError, match="fused launch"):
        fused.set_default_launch(launch)
    assert fused.default_launch() == fused.DEFAULT_LAUNCH
    with pytest.raises(ValueError, match="fused launch"):
        activate(_tuned(fused_launch=launch))
    assert fused.default_launch() == fused.DEFAULT_LAUNCH


def test_plain_version_ignores_the_launch():
    """On the CPU every launch shape gives the plain version's output."""
    from repro_torch.kernels.ops import pack_table
    from repro_torch.tables import load_table
    tc = pack_table(load_table("sigmoid_wide", 16), "cpu")
    x = torch.linspace(-9.0, 9.0, 4099)
    want = fused.ppa_fused_plain(tc, x, True)
    for launch in fused.LAUNCH_CANDIDATES:
        fused.set_default_launch(launch)
        assert torch.equal(fused.ppa_fused_apply(tc, x, True), want)


def _sums(default, other):
    return {fused.DEFAULT_LAUNCH: default, (256, 4): other}


@pytest.mark.parametrize("default, other, winner", [
    # a candidate that wins within the noise does not displace the default
    ([3.0, 3.2, 3.4], [2.9, 3.1, 3.3], fused.DEFAULT_LAUNCH),
    # nor one whose margin is inside its own spread, the default's narrow
    ([3.0, 3.0, 3.0], [2.0, 2.5, 3.2], fused.DEFAULT_LAUNCH),
    # a margin beyond either spread wins
    ([3.0, 3.1, 3.2], [2.0, 2.1, 2.2], (256, 4)),
    # a slower candidate never does
    ([2.0, 2.1, 2.2], [3.0, 3.1, 3.2], fused.DEFAULT_LAUNCH),
])
def test_stage3_keeps_the_default_within_the_noise(default, other, winner):
    """Stage 3's pick from summed times a repeat: the least median wins
    only by more than the spread of its repeats and the default's."""
    from repro_torch.tune.autotune import pick_launch
    got, margin, spread = pick_launch(_sums(default, other))
    assert got == winner
    assert margin == pytest.approx(default[1] - min(default[1], other[1]))
    assert spread >= max(default) - min(default)


def test_stage3_pick_on_a_tie_is_the_default():
    from repro_torch.tune.autotune import pick_launch
    assert pick_launch({(256, 4): [1.0, 1.0], fused.DEFAULT_LAUNCH:
                        [1.0, 1.0]}) == (fused.DEFAULT_LAUNCH, 0.0, 0.0)


def test_tuned_file_never_collides_with_the_reference(tmp_path):
    """Both packages may share one store root: each writes its own file
    and reads only its own."""
    ours = tuned_path(tmp_path, "cpu/host")
    ref = ref_tune.tuned_path(tmp_path, "cpu/host")
    assert ours.parent == ref.parent and ours.name != ref.name
    assert ours.name.startswith("torch-tuned-")
    save_tuned(_tuned(device="cpu/host"), tmp_path)
    ref_tune.save_tuned(ref_tune.TunedConfig(device="cpu/host",
                                             search_backend="jax"), tmp_path)
    assert load_tuned(tmp_path, "cpu/host").search_backend == "torch"
    assert ref_tune.load_tuned(tmp_path,
                               "cpu/host").search_backend == "jax"


def test_activate_sets_the_torch_backend_floors():
    out = activate(_tuned())
    assert out == {"k_floor": 32, "g_floor": 16, "batch_elems": 1 << 21,
                   "fused_launch": (256, 2)}
    assert fused.default_launch() == (256, 2)
    assert (TorchSearchBackend.K_FLOOR, TorchSearchBackend.G_FLOOR,
            TorchSearchBackend.BATCH_ELEMS) == (32, 16, 1 << 21)
    own = TorchSearchBackend("cpu", k_floor=128)
    assert (own.K_FLOOR, own.G_FLOOR) == (128, 16)
    assert config.active_config() == _tuned()


def test_precedence_argument_env_file_default(tmp_path, monkeypatch):
    store = TableStore(tmp_path)
    bare = CompileJob("sigmoid", CFG, SCHEME)
    # default: no file, the job is compiled as it is
    assert store._apply_tuned(bare) is bare and store.tuned_applied == 0
    save_tuned(_tuned(), tmp_path)
    # file: both knobs filled; a host-keyed torch config scans on the CPU
    job = store._apply_tuned(bare)
    assert isinstance(job.search_backend, TorchSearchBackend)
    assert job.search_backend.device.type == "cpu"
    assert job.speculate == 3 and store.tuned_applied == 1
    assert job.key() == bare.key()
    assert TorchSearchBackend.K_FLOOR == 32
    # environment: the backend variable beats the file's backend
    monkeypatch.setenv(BACKEND_ENV, "numpy")
    job = store._apply_tuned(bare)
    assert job.search_backend is None and job.speculate == 3
    monkeypatch.delenv(BACKEND_ENV)
    # argument: explicit knobs beat both
    explicit = CompileJob("sigmoid", CFG, SCHEME, search_backend="numpy",
                          speculate=0)
    assert store._apply_tuned(explicit) is explicit
    # the opt-out variable ignores the file
    monkeypatch.setenv(TUNE_ENV, "0")
    assert store._apply_tuned(bare) is bare
    # a memory-only store has no file to read
    assert TableStore(tmp_path, persist=False)._apply_tuned(bare) is bare


@pytest.mark.parametrize("speculate", [0, 3])
def test_tuned_compile_leaves_the_artifact(tmp_path, speculate):
    """The same keys and file names with and without a tuned config; with
    the tuned backend alone the artifact bytes are equal, and with a
    speculation depth the table is (``table_identity``): speculation
    changes only the effort counters in its stats, as in the reference."""
    tuned, plain = TableStore(tmp_path / "t"), TableStore(tmp_path / "p")
    save_tuned(_tuned(speculate=speculate), tmp_path / "t")
    for naf in ("sigmoid", "tanh"):
        a = tuned.compile_or_load(naf, CFG, SCHEME)
        b = plain.compile_or_load(naf, CFG, SCHEME)
        assert table_identity(a) == table_identity(b)
    assert tuned.tuned_applied == 2 and plain.tuned_applied == 0
    names = sorted(p.name for p in (tmp_path / "t").glob("*.json"))
    assert names == sorted(p.name for p in (tmp_path / "p").glob("*.json"))
    same = [(tmp_path / "t" / n).read_bytes() == (tmp_path / "p" / n
                                                  ).read_bytes()
            for n in names]
    assert all(same) if speculate == 0 else not any(same)


def test_autotune_smoke_on_cpu(tmp_path):
    """Stage 1 times numpy and torch (on the CPU) at speculation 0 and 3,
    stage 2 the floors if torch wins; every candidate's tables are equal
    (autotune raises otherwise), and the winner persists and is picked
    up.  Stage 3 has no kernel to time on the CPU: it records the default
    launch and says so."""
    from repro_torch.tune.autotune import verify
    logs = []
    cfg = autotune(tmp_path, smoke=True, device="cpu", log=logs.append)
    assert cfg.device == "cpu/host"
    assert {"compile_s/numpy/spec0", "compile_s/numpy/spec3",
            "compile_s/torch/spec0", "compile_s/torch/spec3"} <= set(cfg.score)
    assert cfg.search_backend in ("numpy", "torch")
    assert cfg.fused_launch == fused.DEFAULT_LAUNCH
    assert not any(k.startswith("fused_ms/") for k in cfg.score)
    assert any("stage 3: no card" in line for line in logs)
    assert load_tuned(tmp_path) == cfg
    verify(tmp_path, cfg, log=logs.append)
    assert any("verify OK" in line for line in logs)
