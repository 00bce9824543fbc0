"""Fault-tolerance plumbing: preemption capture, step timing / straggler
detection, bounded-retry recovery (the reference's ``repro.train.fault``,
plain Python, carried over as it is)."""
from __future__ import annotations

import signal
import time


class PreemptionGuard:
    """Latches SIGTERM/SIGINT so the loop can checkpoint-and-exit cleanly
    (TPU pod preemptions deliver SIGTERM with a grace window)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):   # non-main thread / unsupported
                pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


class StepTimer:
    """EWMA step timing; flags straggler steps (>ratio × EWMA). On a real
    cluster the flag feeds the controller's slice-replacement logic; here it
    is surfaced in metrics and logs."""

    def __init__(self, alpha: float = 0.1, straggler_ratio: float = 3.0):
        self.alpha = alpha
        self.ratio = straggler_ratio
        self.ewma = None
        self.stragglers = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> tuple[float, bool]:
        dt = time.perf_counter() - self._t0
        is_straggler = self.ewma is not None and dt > self.ratio * self.ewma
        if is_straggler:
            self.stragglers += 1
        else:                      # don't pollute the EWMA with outliers
            self.ewma = dt if self.ewma is None else \
                (1 - self.alpha) * self.ewma + self.alpha * dt
        return dt, is_straggler


def with_retries(fn, recover, max_retries: int = 3, log=print):
    """Run ``fn()``; on exception call ``recover(attempt)`` and retry.
    Models node-failure recovery: reload the last checkpoint and continue."""
    attempt = 0
    while True:
        try:
            return fn()
        except KeyboardInterrupt:
            raise
        except Exception as e:                      # noqa: BLE001
            attempt += 1
            if attempt > max_retries:
                raise
            log(f"[fault] step failed ({type(e).__name__}: {e}); "
                f"recovery attempt {attempt}/{max_retries}")
            recover(attempt)
