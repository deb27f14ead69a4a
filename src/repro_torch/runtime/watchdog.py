"""Step watchdog: straggler detection + hang deadline (a copy of
``repro/runtime/watchdog.py``).  It times the step function it wraps; the
port's train step returns once its metrics are on the host, so the time is
the device's work.

At 1000+-node scale the dominant failure modes are (a) a slow chip/host
dragging every synchronous step (straggler) and (b) a hung collective.
The watchdog wraps each step:

  * keeps a rolling median of step wall-times;
  * flags steps > ``straggler_factor`` x median (logged + counted — the
    launcher's policy decides when to abandon the reservation);
  * arms a hard deadline timer per step: if a step exceeds
    ``deadline_factor`` x median (min ``min_deadline_s``), ``on_hang`` is
    invoked (default: raise StepHang, which launch/train.py turns into an
    abort-and-restart-from-checkpoint).
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Callable, List, Optional

__all__ = ["StepHang", "Watchdog"]


class StepHang(RuntimeError):
    pass


@dataclasses.dataclass
class Watchdog:
    straggler_factor: float = 2.0
    deadline_factor: float = 10.0
    min_deadline_s: float = 60.0
    window: int = 50
    on_hang: Optional[Callable[[], None]] = None

    def __post_init__(self):
        self._times: List[float] = []
        self.stragglers = 0
        self.hangs = 0

    @property
    def median(self) -> Optional[float]:
        return statistics.median(self._times) if self._times else None

    def _deadline(self) -> float:
        m = self.median
        return max(self.min_deadline_s,
                   (m or 0.0) * self.deadline_factor)

    def step(self, fn, *args, **kw):
        """Run one step under the watchdog; returns fn's result.

        The deadline timer is always disarmed on exit — including when
        ``fn`` raises — and once the step has *settled* an in-flight
        alarm is a no-op: ``Timer.cancel`` cannot stop a callback that
        already started, so without the settled gate a step failing just
        past the deadline would double-fault with a spurious ``on_hang``
        (counted hang + side effects) for a step that is already over."""
        hang_evt = threading.Event()
        lock = threading.Lock()
        settled = [False]

        def _alarm():
            with lock:
                if settled[0]:
                    return          # step already finished/raised
                self.hangs += 1
                hang_evt.set()
            if self.on_hang:
                self.on_hang()

        timer = threading.Timer(self._deadline(), _alarm)
        timer.daemon = True
        timer.start()
        t0 = time.monotonic()
        try:
            out = fn(*args, **kw)
        finally:
            with lock:
                settled[0] = True
            timer.cancel()
        dt = time.monotonic() - t0
        if hang_evt.is_set():
            raise StepHang(f"step exceeded deadline {self._deadline():.1f}s")
        m = self.median
        if m is not None and dt > self.straggler_factor * m:
            self.stragglers += 1
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return out
