"""repro_torch.checkpoint — atomic, resumable checkpoints in the JAX
package's layout."""

from .checkpoint import gc_old, latest_step, restore, save

__all__ = ["save", "restore", "latest_step", "gc_old"]
