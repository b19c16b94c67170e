"""Straggler and hang detection for the training loop.

A copy of ``repro/runtime/watchdog.py``: each step's wall time feeds an
EWMA; a step slower than ``straggler_factor`` × the EWMA fires the
straggler callback (logged and counted here; on a cluster it would report
the slow host).  A watchdog thread fires the hang callback when no step
has beaten within ``hang_timeout`` seconds.  ``start`` may follow a
``stop``: each ``Trainer.fit`` runs the thread for its own loop.
"""

from __future__ import annotations

import threading
import time

__all__ = ["Watchdog"]


class Watchdog:
    def __init__(self, *, straggler_factor: float = 3.0, hang_timeout: float = 300.0,
                 on_straggler=None, on_hang=None, ewma: float = 0.9):
        self.straggler_factor = straggler_factor
        self.hang_timeout = hang_timeout
        self.on_straggler = on_straggler
        self.on_hang = on_hang
        self.ewma_coef = ewma
        self.ewma: float | None = None
        self.straggler_events: list[tuple[int, float, float]] = []
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- heartbeat thread --

    def start(self) -> "Watchdog":
        self._stop.clear()
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)

    def _watch(self) -> None:
        while not self._stop.wait(min(self.hang_timeout / 4, 5.0)):
            if time.monotonic() - self._last_beat > self.hang_timeout:
                if self.on_hang:
                    self.on_hang()
                self._last_beat = time.monotonic()

    # -- per-step --

    def step(self, step_idx: int, duration: float) -> bool:
        self._last_beat = time.monotonic()
        if self.ewma is None:
            self.ewma = duration
            return False
        is_straggler = duration > self.straggler_factor * self.ewma
        if is_straggler:
            self.straggler_events.append((step_idx, duration, self.ewma))
            if self.on_straggler:
                self.on_straggler(step_idx, duration, self.ewma)
        # slow steps should not poison the baseline
        coef = self.ewma_coef if not is_straggler else 0.995
        self.ewma = coef * self.ewma + (1 - coef) * duration
        return is_straggler
