"""TunedConfig: the persisted per-device execution config.

A copy of the JAX package's ``tune/config.py`` for the port.  One JSON per
device, content-addressed by that device's key the same way artifacts are
addressed by their compile request, living in ``<store root>/tune/`` —
*next to* the ``TableStore`` but in a subdirectory, so store-directory
operations (``merge``, ``prune``, ``version_sweep``, which glob
``<root>/*.json``) never see it.  The file is
``torch-tuned-<sha1>.json``: the JAX package writes ``tuned-<sha1>.json``
into the same directory, and both packages may share one store root.
Tuned values are execution knobs only: they never enter a store key, and
artifacts compiled with and without them are byte-identical.

The port's knobs are the search backend (``numpy`` | ``torch``), the TBW
speculation depth, ``TorchSearchBackend``'s padding floors and the fused
kernel's launch shape (``fused_launch``: threads a block, blocks an SM at
most), the counterpart of the reference's Pallas ``block``.  A file
written before ``fused_launch`` existed loads with its default.

Resolution order for a knob (highest wins):

  1. an explicit argument (``compile_table(speculate=...)``,
     ``compile_or_load(search_backend=...)``, a ``CompileJob`` field;
     the fused launch shape has no per-call argument: it is the process
     default, which ``activate`` sets through ``set_default_launch``)
  2. the operator env var ``$REPRO_TORCH_SEARCH_BACKEND`` — a host-level
     override beats a stale tuning file without a re-tune
  3. the persisted TunedConfig for this device
  4. the built-in defaults
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

from ..kernels.fused import DEFAULT_LAUNCH, set_default_launch

__all__ = ["TUNE_DIR", "TUNE_ENV", "TUNE_VERSION", "TunedConfig",
           "activate", "activate_for_store", "active_config", "device_key",
           "load_tuned", "resolve_tuned", "save_tuned", "tuned_path"]

#: subdirectory of the store root holding tuned configs
TUNE_DIR = "tune"

#: set to ``0`` to ignore persisted tuned configs (diagnosis escape hatch)
TUNE_ENV = "REPRO_TORCH_TUNE"

#: bump when TunedConfig semantics change — old files are then ignored
#: (different digest), not misread.
TUNE_VERSION = 1

#: the file-name prefix, apart from the JAX package's ``tuned-``
_PREFIX = "torch-tuned"


def device_key() -> str:
    """``cuda/<device name>`` on a card, else ``cpu/host`` — the identity
    tuned configs are addressed by."""
    try:
        import torch
        if torch.cuda.is_available():
            return f"cuda/{torch.cuda.get_device_name()}"
    except Exception:
        pass
    return "cpu/host"


@dataclasses.dataclass
class TunedConfig:
    """The winning execution config for one device, as measured by
    :func:`repro_torch.tune.autotune.autotune`."""

    #: the device key this config was measured on (stamped, and part of
    #: the file digest — a config never applies to a different device)
    device: str
    #: candidate-search backend ("numpy" | "torch")
    search_backend: str = "numpy"
    #: TBW speculative prefetch depth (0 = off)
    speculate: int = 0
    #: TorchSearchBackend padding floors / fused-dispatch element budget
    k_floor: int = 64
    g_floor: int = 32
    batch_elems: int = 1 << 23
    #: the fused kernel's launch shape (threads a block, blocks an SM)
    fused_launch: Tuple[int, int] = DEFAULT_LAUNCH
    #: measurement evidence (wall seconds or device ms per candidate) —
    #: documentation for operators, never read back programmatically
    score: Dict[str, float] = dataclasses.field(default_factory=dict)
    version: int = TUNE_VERSION

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2,
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TunedConfig":
        blob = json.loads(text)
        if "fused_launch" in blob:
            blob["fused_launch"] = tuple(blob["fused_launch"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in blob.items() if k in known})

    def summary(self) -> str:
        return (f"device={self.device} backend={self.search_backend} "
                f"speculate={self.speculate} floors=(K{self.k_floor}/"
                f"G{self.g_floor}/B{self.batch_elems}) fused_launch="
                f"{self.fused_launch[0]}x{self.fused_launch[1]}")


def tuned_path(root: "str | Path", device: Optional[str] = None) -> Path:
    """Where the tuned config for ``device`` lives under a store root."""
    device = device or device_key()
    digest = hashlib.sha1(
        f"v{TUNE_VERSION}|{device}".encode()).hexdigest()[:16]
    return Path(root) / TUNE_DIR / f"{_PREFIX}-{digest}.json"


def save_tuned(cfg: TunedConfig, root: "str | Path") -> Path:
    """Persist ``cfg`` under ``root`` (atomic rename, content-addressed by
    device key) and invalidate the resolve cache."""
    path = tuned_path(root, cfg.device)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(cfg.to_json())
    os.replace(tmp, path)
    _RESOLVE_CACHE.pop(str(path), None)
    return path


def load_tuned(root: "str | Path",
               device: Optional[str] = None) -> Optional[TunedConfig]:
    """The persisted config for this (or the given) device, or None."""
    path = tuned_path(root, device)
    try:
        cfg = TunedConfig.from_json(path.read_text())
    except (OSError, ValueError, TypeError, KeyError):
        return None
    if cfg.version != TUNE_VERSION:
        return None
    return cfg


# (path) -> (mtime_ns, config-or-None); a per-process memo so the hot
# compile_or_load path costs one stat, not a read+parse, per miss.
_RESOLVE_CACHE: Dict[str, Tuple[int, Optional[TunedConfig]]] = {}


def resolve_tuned(root: "str | Path") -> Optional[TunedConfig]:
    """The active tuned config for this device under ``root`` — cached,
    mtime-invalidated, disabled entirely by ``REPRO_TORCH_TUNE=0``."""
    if os.environ.get(TUNE_ENV, "1") in ("0", "off", "false"):
        return None
    path = tuned_path(root)
    try:
        mtime = path.stat().st_mtime_ns
    except OSError:
        return None
    cached = _RESOLVE_CACHE.get(str(path))
    if cached is not None and cached[0] == mtime:
        return cached[1]
    cfg = load_tuned(root)
    _RESOLVE_CACHE[str(path)] = (mtime, cfg)
    return cfg


_ACTIVE: Optional[TunedConfig] = None


def active_config() -> Optional[TunedConfig]:
    """The last config applied by :func:`activate` in this process."""
    return _ACTIVE


def activate(cfg: TunedConfig) -> Dict[str, object]:
    """Apply ``cfg``'s process-level knobs and remember it as active.

    Sets ``TorchSearchBackend``'s class-level floors (new and existing
    instances without their own floors read them; the floors only change
    padding, never results) and the fused kernel's default launch shape
    (every shape gives the same output).  The per-job knobs — search
    backend choice and speculation depth — are NOT applied here; they are
    filled in where jobs are built (``TableStore``) so explicit arguments
    and the env override keep precedence.
    """
    global _ACTIVE
    from ..core.searchspace import TorchSearchBackend

    TorchSearchBackend.K_FLOOR = int(cfg.k_floor)
    TorchSearchBackend.G_FLOOR = int(cfg.g_floor)
    TorchSearchBackend.BATCH_ELEMS = int(cfg.batch_elems)
    launch = set_default_launch(cfg.fused_launch)
    _ACTIVE = cfg
    return {"k_floor": cfg.k_floor, "g_floor": cfg.g_floor,
            "batch_elems": cfg.batch_elems, "fused_launch": launch}


def activate_for_store(store) -> Optional[TunedConfig]:
    """Resolve + activate the tuned config persisted next to ``store``
    (a ``TableStore``).  Returns the config, or None when the store is
    memory-only, tuning is disabled, or no config exists for this device.
    Never raises — serving must start with or without one."""
    try:
        if not getattr(store, "persist", False):
            return None
        cfg = resolve_tuned(store.root)
        if cfg is not None:
            activate(cfg)
        return cfg
    except Exception:
        return None
