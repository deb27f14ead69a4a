"""Per-device autotuning: persisted execution configs for the compiler.

A copy of the JAX package's ``tune/`` for the port.  The execution knobs —
search-backend choice, TBW speculation depth and ``TorchSearchBackend``'s
padding floors (``K_FLOOR``/``G_FLOOR``/``BATCH_ELEMS``) — change how
fast a table compiles, never what it compiles, and the fused kernel's
launch shape how fast an activation runs, never what it returns, so they
are safe to tune per device and apply silently.

:mod:`repro_torch.tune.config` defines the :class:`TunedConfig` record,
its device-keyed persistence next to a ``TableStore`` (``<root>/tune/
torch-tuned-<sha1>.json``) and :func:`activate`, the one place tuned
values are applied to process defaults.  :mod:`repro_torch.tune.autotune`
measures the candidates and writes the winner.  ``TableStore.
compile_or_load`` and ``ServeEngine(table_store=...)`` resolve the active
config; ``REPRO_TORCH_TUNE=0`` ignores persisted configs.
"""

from .autotune import autotune
from .config import (TUNE_DIR, TUNE_ENV, TunedConfig, activate,
                     activate_for_store, active_config, device_key,
                     load_tuned, resolve_tuned, save_tuned, tuned_path)

__all__ = [
    "TUNE_DIR", "TUNE_ENV", "TunedConfig", "activate", "activate_for_store",
    "active_config", "autotune", "device_key", "load_tuned", "resolve_tuned",
    "save_tuned", "tuned_path",
]
