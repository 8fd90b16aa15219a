"""Preemption-safe training: save-on-signal (a copy of
``research_image_retrieval_tpu/train/preemption.py``).

A scheduler sends SIGTERM before it takes the machine; this handler flips
a flag the train loop checks each step, so the loop checkpoints and exits
cleanly instead of losing the epoch.
"""

from __future__ import annotations

import signal
import threading

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Flag-based SIGTERM/SIGINT guard for training loops.

    Usage:
        guard = PreemptionGuard()          # installs handlers
        for batch in loader:
            ...train step...
            if guard.should_stop:
                mgr.save(epoch, state); break
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = threading.Event()
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):
                pass  # not main thread / unsupported signal

    def _handler(self, signum, frame):
        print(f">> received signal {signum}: checkpoint-and-exit requested",
              flush=True)
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def request_stop(self):
        """Programmatic trigger (tests / cooperative shutdown)."""
        self._stop.set()

    def restore(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
