"""Append-only JSONL metrics logger (one line per step): a copy of
``repro/runtime/metrics.py`` that takes torch tensors as the reference
takes jax arrays.

Hardened for the training hot loop: a bad metric value (NaN/inf, a
string, a whole array) or a full disk must never kill the step loop, so
:meth:`MetricsLogger.log` coerces values into strict JSON and swallows
(and counts) append failures instead of raising.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Optional

__all__ = ["MetricsLogger"]


def _safe(v):
    """Coerce a metric value into strict-JSON territory.

    Finite numerics become float; non-finite become None (valid JSON,
    unlike NaN/Infinity literals); everything else is stringified rather
    than rejected — a mislabelled metric should show up in the log, not
    take down the run."""
    try:
        f = float(v)        # a 0-dim tensor becomes its float
    except (TypeError, ValueError, RuntimeError):   # torch: many elements
        return str(v)
    return f if math.isfinite(f) else None


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self.coerced = 0        # values that were not plain finite floats
        self.write_errors = 0   # appends lost to OSError (disk full, ...)

    def log(self, step: int, **metrics):
        rec = {"step": step, "t": time.time()}
        for k, v in metrics.items():
            s = _safe(v)
            if not isinstance(s, float):
                self.coerced += 1
            rec[k] = s
        line = json.dumps(rec, allow_nan=False)
        if self.path:
            try:
                with open(self.path, "a") as f:
                    f.write(line + "\n")
            except OSError:
                self.write_errors += 1      # the loop matters more
        return rec
