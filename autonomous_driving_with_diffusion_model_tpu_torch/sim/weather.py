"""Dynamic weather evolution (reference: carla_gym/utils/dynamic_weather.py:28-124).

The port's own copy of the JAX package's ``sim/weather.py``, which it may not import.

Pure-math Sun/Storm oscillators; a CARLA adapter copies the parameter dict
onto ``carla.WeatherParameters`` each tick. ``dynamic_{speed}`` config names
select the time-scale factor like the reference's WeatherHandler.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["Sun", "Storm", "DynamicWeather", "clamp"]


def clamp(value, minimum=0.0, maximum=100.0):
    return max(minimum, min(value, maximum))


class Sun:
    def __init__(self, azimuth: float, altitude: float, rng: Optional[np.random.Generator] = None):
        self.azimuth = azimuth
        self.altitude = altitude
        rng = rng or np.random.default_rng()
        self._t = rng.uniform(0.0, 2.0 * np.pi)

    def tick(self, delta_seconds: float):
        self._t += 0.008 * delta_seconds
        self._t %= 2.0 * np.pi
        self.azimuth += 0.25 * delta_seconds
        self.azimuth %= 360.0
        self.altitude = (70 * np.sin(self._t)) - 20


class Storm:
    def __init__(self, precipitation: float):
        self._t = precipitation if precipitation > 0.0 else -50.0
        self._increasing = True
        self.clouds = 0.0
        self.rain = 0.0
        self.wetness = 0.0
        self.puddles = 0.0
        self.wind = 0.0
        self.fog = 0.0

    def tick(self, delta_seconds: float):
        delta = (1.3 if self._increasing else -1.3) * delta_seconds
        self._t = clamp(delta + self._t, -250.0, 100.0)
        self.clouds = clamp(self._t + 40.0, 0.0, 90.0)
        self.rain = clamp(self._t, 0.0, 80.0)
        delay = -10.0 if self._increasing else 90.0
        self.puddles = clamp(self._t + delay, 0.0, 85.0)
        self.wetness = clamp(self._t * 5, 0.0, 100.0)
        self.wind = 5.0 if self.clouds <= 20 else 90 if self.clouds >= 70 else 40
        self.fog = clamp(self._t - 10, 0.0, 30.0)
        if self._t == -250.0:
            self._increasing = True
        if self._t == 100.0:
            self._increasing = False


class DynamicWeather:
    """Evolving weather parameter dict (speed factor parsed from
    "dynamic_{speed}" names like the reference WeatherHandler.reset)."""

    def __init__(
        self,
        sun_azimuth: float = 0.0,
        sun_altitude: float = 75.0,
        precipitation: float = 0.0,
        speed_factor: float = 1.0,
        rng: Optional[np.random.Generator] = None,
    ):
        self.sun = Sun(sun_azimuth, sun_altitude, rng)
        self.storm = Storm(precipitation)
        self.speed_factor = speed_factor

    @classmethod
    def from_config_name(cls, name: str, **kwargs) -> "DynamicWeather":
        parts = name.split("_")
        speed = float(parts[1]) if len(parts) == 2 else 1.0
        return cls(speed_factor=speed, **kwargs)

    def tick(self, delta_seconds: float) -> Dict[str, float]:
        self.sun.tick(delta_seconds * self.speed_factor)
        self.storm.tick(delta_seconds * self.speed_factor)
        return {
            "cloudiness": self.storm.clouds,
            "precipitation": self.storm.rain,
            "precipitation_deposits": self.storm.puddles,
            "wind_intensity": self.storm.wind,
            "fog_density": self.storm.fog,
            "wetness": self.storm.wetness,
            "sun_azimuth_angle": self.sun.azimuth,
            "sun_altitude_angle": self.sun.altitude,
        }
