"""Windowed PID controller.

The port's own copy of the JAX package's ``driving/pid.py``, which it may not import.

Semantics must match the reference controller exactly for closed-loop parity
(reference: control/pid.py:6-28): the integral term is the mean of the last
``n`` errors (window pre-filled with zeros), the derivative is the difference
of the last two errors. Implemented over a numpy ring buffer.
"""

import numpy as np

__all__ = ["PIDController"]


class PIDController:
    def __init__(self, K_P=1.0, K_I=0.0, K_D=0.0, n=20):
        self.gains = np.array([K_P, K_I, K_D], dtype=np.float64)
        self._buf = np.zeros(n, dtype=np.float64)
        self._head = 0
        self._prev_error = 0.0
        self._peak = 0.0

    def step(self, error: float) -> float:
        error = float(error)
        derivative = error - self._prev_error
        self._prev_error = error

        self._buf[self._head] = error
        self._head = (self._head + 1) % len(self._buf)
        integral = float(self._buf.mean())

        # peak tracking kept for interface parity with the reference (unused)
        self._peak = max(self._peak, abs(error))

        return float(np.dot(self.gains, [error, integral, derivative]))
