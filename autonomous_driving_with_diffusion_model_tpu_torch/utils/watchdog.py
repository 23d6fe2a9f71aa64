"""Thread-timer watchdog (reference: scenario_runner/srunner/scenariomanager/watchdog.py:22-80).

The port's own copy of the JAX package's ``utils/watchdog.py``, which it may not import.

Guards simulation and agent steps against hangs: if ``update`` isn't called
within the timeout the watchdog marks failure and (optionally) raises in the
owning thread via a callback. Used by the route evaluator around episodes the
way the leaderboard wraps its tick loop (scenario_manager.py:63-69,125-146).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

__all__ = ["Watchdog"]


class Watchdog:
    def __init__(self, timeout: float = 10.0, on_timeout: Optional[Callable] = None):
        self._timeout = timeout + 1.0  # reference adds 1 s slack
        self._on_timeout = on_timeout
        self._failed = False
        self._timer: Optional[threading.Timer] = None
        self._stopped = True
        self._lock = threading.Lock()

    def start(self):
        with self._lock:
            self._stopped = False
            self._failed = False
            self._arm()

    def _arm(self):
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(self._timeout, self._event)
        self._timer.daemon = True
        self._timer.start()

    def _event(self):
        with self._lock:
            if self._stopped:
                return
            self._failed = True
            self._stopped = True
        if self._on_timeout is not None:
            self._on_timeout()

    def update(self):
        """Pet the watchdog; call once per step."""
        with self._lock:
            if not self._stopped:
                self._arm()

    def stop(self):
        with self._lock:
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def get_status(self) -> bool:
        """True while healthy (reference semantics)."""
        return not self._failed
