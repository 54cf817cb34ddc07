"""Fault-tolerance utilities for long-running distributed training.

- Watchdog: straggler / hang detection.  Each step arms a timer sized to an
  SLO multiple of the trailing median step time; if a step exceeds it, the
  callback fires (log -> alert -> abort-and-restart-from-checkpoint, which at
  cluster scale evicts the straggling host).
- Heartbeat: periodic liveness file (what a cluster supervisor scrapes).
- retry: bounded-backoff wrapper for transient infrastructure failures
  (checkpoint I/O, data source hiccups).
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from typing import Callable, Optional


class DeviceLost(RuntimeError):
    """A mesh participant is gone or straggling past the SLO.

    Raised at a checkpoint boundary (never mid-step) by the scale-out
    drivers — the training engine's watchdog/fault hooks and the
    PlanEngine's sharded dispatch — so the caller can DEGRADE (shrink the
    mesh, replay from the last checkpoint) instead of aborting.  Test
    harnesses raise it from injection hooks to exercise the same path.
    """


class Watchdog:
    def __init__(self, slo_factor: float = 5.0, min_timeout_s: float = 30.0,
                 on_straggler: Optional[Callable[[float], None]] = None,
                 window: int = 32):
        self.slo_factor = slo_factor
        self.min_timeout_s = min_timeout_s
        self.on_straggler = on_straggler or (lambda t: None)
        self._times: list[float] = []
        self._window = window
        self._timer: Optional[threading.Timer] = None
        self.fired = 0

    def timeout_s(self) -> float:
        if not self._times:
            return self.min_timeout_s
        med = statistics.median(self._times)
        return max(self.min_timeout_s, self.slo_factor * med)

    def step_start(self):
        self._arm(self.timeout_s())
        self._t0 = time.time()

    def step_end(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        dt = time.time() - self._t0
        self._times.append(dt)
        if len(self._times) > self._window:
            self._times.pop(0)
        return dt

    def _arm(self, timeout):
        def fire():
            self.fired += 1
            self.on_straggler(timeout)

        self._timer = threading.Timer(timeout, fire)
        self._timer.daemon = True
        self._timer.start()


class Heartbeat:
    """Periodic liveness marker: {host, step, time} json, atomically swapped."""

    def __init__(self, path: str, interval_s: float = 15.0, host_id: int = 0):
        self.path = path
        self.interval_s = interval_s
        self.host_id = host_id
        self._step = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def update(self, step: int):
        self._step = step

    def start(self):
        def loop():
            while not self._stop.wait(self.interval_s):
                self.beat()

        self.beat()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def beat(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": self.host_id, "step": self._step,
                       "time": time.time()}, f)
        os.replace(tmp, self.path)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


def retry(fn, *, attempts: int = 3, backoff_s: float = 1.0,
          exceptions=(OSError, IOError)):
    """Bounded-backoff retry for transient infrastructure failures."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203
            last = e
            time.sleep(backoff_s * (2 ** i))
    raise last
