"""Fault tolerance: step watchdog, straggler monitor, auto-restart loop
(a copy of ``repro/train/fault.py``, docstrings reworded).

On a real multi-pod deployment these wrap the per-host training loop; here
they are exercised by the example trainer (including a --simulate-failure
mode that kills the loop mid-run and proves checkpoint/restart recovery).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class StragglerMonitor:
    """Tracks step latencies; flags steps beyond p95 x tolerance.

    At scale the same statistic (exchanged via a tiny allreduce of per-host
    step times) drives the mitigation policy: re-shard input files away from
    slow hosts / evict persistent stragglers to spares.  Here the policy is
    surfaced as a flag + callback.
    """

    tolerance: float = 2.0
    window: int = 50
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _times: List[float] = dataclasses.field(default_factory=list)
    straggler_steps: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 10:
            return False
        srt = sorted(self._times)
        p95 = srt[int(0.95 * (len(srt) - 1))]
        if dt > self.tolerance * p95:
            self.straggler_steps.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt, p95)
            return True
        return False


@dataclasses.dataclass
class Watchdog:
    """Detects a hung step (e.g. a dead host stalling a collective).

    The caller stamps ``arm()`` before the blocking step and ``disarm()``
    after; ``expired`` turning True means the step exceeded the deadline and
    the caller should treat the run as failed (triggering restart-from-
    checkpoint).  Single-process stand-in for a real heartbeat service.
    """

    deadline_s: float = 300.0
    _armed_at: Optional[float] = None

    def arm(self) -> None:
        self._armed_at = time.monotonic()

    def disarm(self) -> None:
        self._armed_at = None

    @property
    def expired(self) -> bool:
        return (self._armed_at is not None
                and time.monotonic() - self._armed_at > self.deadline_s)


class SimulatedFailure(RuntimeError):
    """Raised by the example trainer's failure injector."""


def run_with_restarts(run_fn: Callable[[], Dict], *, max_restarts: int = 3,
                      backoff_s: float = 0.5,
                      log=print) -> Dict:
    """Restart-on-failure loop.

    ``run_fn`` must be resumable (restore-from-latest-checkpoint inside).
    Mirrors the production pattern where the cluster scheduler relaunches
    dead jobs and the trainer self-resumes.
    """
    attempts = 0
    while True:
        try:
            out = run_fn()
            out["restarts"] = attempts
            return out
        except SimulatedFailure as e:
            attempts += 1
            log(f"[fault] run failed ({e}); restart {attempts}/{max_restarts}")
            if attempts > max_restarts:
                raise
            time.sleep(backoff_s)
