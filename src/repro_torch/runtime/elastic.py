"""Elasticity and fault-tolerance glue for the training loop, as in the
reference (``repro.runtime.elastic``; it imports no jax, and is copied
so that the port imports nothing of the reference).

* ``StragglerMonitor``: per-step wall-time EWMA; steps slower than
  ``threshold x`` the EWMA are flagged; it trips after ``patience``
  consecutive flags (the loop then checkpoints and stops for a restart).
* ``Preemption``: a SIGTERM-aware flag so the loop exits through a clean
  checkpoint on eviction notice.
* ``run_elastic``: the restart loop: restore the latest checkpoint, train,
  and on failure restore and continue.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    threshold: float = 2.0
    patience: int = 5
    _ewma: float = field(default=0.0)
    _flags: int = 0
    steps: int = 0

    def observe(self, step_seconds: float) -> bool:
        """Returns True when mitigation (checkpoint+restart) should fire."""
        self.steps += 1
        if self._ewma == 0.0:
            self._ewma = step_seconds
            return False
        slow = step_seconds > self.threshold * self._ewma
        self._flags = self._flags + 1 if slow else 0
        # slow steps do not poison the baseline
        if not slow:
            self._ewma = 0.9 * self._ewma + 0.1 * step_seconds
        return self._flags >= self.patience


class Preemption:
    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        for s in signals:
            try:
                signal.signal(s, self._handler)
            except ValueError:           # not the main thread (tests)
                pass

    def _handler(self, *_):
        self.requested = True


def run_elastic(make_state, train_loop, checkpointer, *, max_restarts=3):
    """Restart loop: each attempt restores the latest checkpoint (if any)
    and runs ``train_loop(state, start_step)``; an exception triggers a
    restore and retry, up to ``max_restarts``."""
    attempts = 0
    while True:
        state = make_state()
        start = 0
        if checkpointer.latest_step() is not None:
            state, start = checkpointer.restore(state)
        try:
            return train_loop(state, start)
        except Exception:
            attempts += 1
            if attempts > max_restarts:
                raise
            time.sleep(0.01)
