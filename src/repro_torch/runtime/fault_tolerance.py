"""Fault tolerance for long training runs.

Counterpart of :mod:`repro.runtime.fault_tolerance`, kept as it is (it
imports no JAX) but for one lock: ``Heartbeat.beat`` from the caller and
from its own thread no longer race on the shared temporary file.  Pieces (each independently testable; composed by
``run_resilient`` and the training loop):

  Heartbeat        — per-host liveness file the cluster agent watches; a
                     stale heartbeat triggers an external restart (the
                     scheduler replaces hardware, the job just has to
                     checkpoint and restart fast).
  StragglerMonitor — step-time watchdog; flags steps slower than k x the
                     rolling median.  Mitigation = report + (optionally)
                     trigger a checkpoint so the scheduler can evict it.
  run_resilient    — retry harness around the step loop: on failure, restore
                     the latest checkpoint and continue, with bounded retries
                     and exponential backoff.  Deterministic data (the
                     pipeline is a pure f(step)) makes the replay exact.

The reference's elastic rescale (restore onto another mesh) belongs to
sharding, ROADMAP item 7.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, List, Optional

import numpy as np


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 5.0, payload: Optional[dict] = None):
        self.path = path
        self.interval_s = interval_s
        self.payload = payload or {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the beat thread and the caller's beat(step=...) write the same
        # temporary file: one writer at a time, or a replace can race another
        self._lock = threading.Lock()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def beat(self, **extra):
        data = {"time": time.time(), **self.payload, **extra}
        tmp = self.path + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self.path)

    def _run(self):
        while not self._stop.is_set():
            self.beat()
            self._stop.wait(self.interval_s)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self.interval_s)

    @staticmethod
    def is_alive(path: str, timeout_s: float) -> bool:
        try:
            with open(path) as f:
                t = json.load(f)["time"]
            return (time.time() - t) < timeout_s
        except (OSError, ValueError, KeyError):
            return False


class StragglerMonitor:
    """Flags steps slower than ``threshold ×`` the rolling median."""

    def __init__(self, threshold: float = 2.0, window: int = 50, min_steps: int = 8):
        self.threshold = threshold
        self.window = window
        self.min_steps = min_steps
        self.times: List[float] = []
        self.flags: List[int] = []

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        self.times = self.times[-self.window :]
        if len(self.times) < self.min_steps:
            return False
        med = float(np.median(self.times))
        if seconds > self.threshold * med:
            self.flags.append(step)
            return True
        return False

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


def run_resilient(
    step_fn: Callable[[int], None],
    start_step: int,
    num_steps: int,
    restore_fn: Callable[[], int],
    max_failures: int = 3,
    backoff_s: float = 0.1,
    on_failure: Optional[Callable[[int, Exception], None]] = None,
) -> int:
    """Run ``step_fn(step)`` for steps [start, start+num); on exception,
    call ``restore_fn() -> restored_step`` and resume from there.

    Returns the number of failures survived.  Raises after ``max_failures``.
    """
    failures = 0
    step = start_step
    end = start_step + num_steps
    while step < end:
        try:
            step_fn(step)
            step += 1
        except Exception as e:  # noqa: BLE001 — the harness must catch all
            failures += 1
            if on_failure is not None:
                on_failure(step, e)
            if failures > max_failures:
                raise
            time.sleep(backoff_s * (2 ** (failures - 1)))
            step = restore_fn()
    return failures
