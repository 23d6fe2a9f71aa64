"""Expert-control noiser for DAgger-style data collection.

The port's own copy of the JAX package's ``sim/noiser.py``, which it may not import.

Re-design of the reference's triangular noise injector (reference:
carla_gym/utils/expert_noiser.py:1-185 — wall-clock ``time.time()`` driven and
seeded from the global ``random`` module, i.e. fps-dependent and untestable).
Here the same triangular noise-episode shape runs on SIMULATION time with an
injectable RNG: episodes start with probability ``frequency``/60 per sim
second, ramp the perturbation up at 0.03*intensity per second (capped at
0.55), hold for the episode duration, then ramp back down symmetrically.
"Spike" perturbs steering (scaled down with speed, 25/(2.3*speed+5));
"Throttle" perturbs throttle/brake.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["ExpertNoiser"]


class ExpertNoiser:
    def __init__(
        self,
        noise_type: str = "Spike",  # "Spike" | "Throttle" | "None"
        frequency: float = 15.0,  # noise episodes per minute
        intensity: float = 10.0,
        min_noise_time_amount: float = 2.0,
        rng: Optional[np.random.Generator] = None,
    ):
        if noise_type not in ("Spike", "Throttle", "None"):
            raise ValueError(f"unknown noise type {noise_type!r}")
        self.noise_type = noise_type
        self.frequency = frequency
        self.min_noise_time_amount = min_noise_time_amount
        self.rng = rng or np.random.default_rng(0)
        self.intensity = intensity + float(self.rng.integers(-2, 3))
        self._episode_start: Optional[float] = None
        self._episode_duration = 0.0
        self._sign = 1.0
        self._last_second = -1.0

    def _maybe_start(self, sim_time: float):
        # one Bernoulli trial per elapsed sim second (reference:103-116)
        if sim_time - self._last_second < 1.0:
            return
        self._last_second = sim_time
        if float(self.rng.integers(0, 60)) < self.frequency:
            self._episode_start = sim_time
            self._episode_duration = self.min_noise_time_amount + float(
                self.rng.integers(50, 200)
            ) / 100.0
            self._sign = 1.0 if self.rng.integers(0, 2) else -1.0

    def _noise_value(self, sim_time: float) -> float:
        """Triangular profile: ramp up during the episode, back down after."""
        t = sim_time - self._episode_start
        rate = 0.03 * self.intensity
        peak = min(0.55, 0.001 + self._episode_duration * rate)
        if t < self._episode_duration:  # ramp up
            return self._sign * min(0.55, 0.001 + t * rate)
        down = peak - (t - self._episode_duration) * rate
        if down <= 0.0:
            self._episode_start = None  # episode over
            return 0.0
        return self._sign * down

    def compute_noise(
        self, control: np.ndarray, speed: float, sim_time: float
    ) -> Tuple[np.ndarray, bool]:
        """control: [throttle, steer, brake]; returns (noisy control,
        noise_active). The caller records the CLEAN expert control as the
        label while applying the noisy one (DAgger collection)."""
        control = np.asarray(control, np.float64).copy()
        if self.noise_type == "None":
            return control, False
        if self._episode_start is None:
            self._maybe_start(sim_time)
        if self._episode_start is None:
            return control, False
        noise = self._noise_value(sim_time)
        if self._episode_start is None:  # just ended
            return control, False
        if self.noise_type == "Spike":
            # steer authority falls with speed (reference:135-147)
            control[1] = float(
                np.clip(control[1] + noise * (25.0 / (2.3 * speed + 5.0)), -1.0, 1.0)
            )
        else:  # Throttle
            if noise > 0:
                control[0] = float(np.clip(control[0] + noise, 0.0, 1.0))
            else:
                control[2] = float(np.clip(control[2] - noise, 0.0, 1.0))
        return control, True
