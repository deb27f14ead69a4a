"""repro_torch.runtime — watchdog + metrics."""

from .metrics import MetricsLogger
from .watchdog import StepHang, Watchdog

__all__ = ["MetricsLogger", "StepHang", "Watchdog"]
