"""Training meters with the reference's logging surface (the port's copy of
the JAX package's ``utils/meters.py``; reference: misc/meter.py:10-55):
running value/average per metric and a tab-joined ``val (avg)`` line for the
train log.
"""

from dataclasses import dataclass, field
from typing import Dict

__all__ = ["AverageMeter", "MetricMeter"]


@dataclass
class AverageMeter:
    val: float = 0.0
    sum: float = 0.0
    count: int = 0

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def reset(self) -> None:
        self.val, self.sum, self.count = 0.0, 0.0, 0

    def update(self, val, n: int = 1) -> None:
        self.val = float(val)
        self.sum += self.val * n
        self.count += n


class MetricMeter:
    def __init__(self, delimiter: str = "\t"):
        self.meters: Dict[str, AverageMeter] = {}
        self.delimiter = delimiter

    def update(self, input_dict) -> None:
        if input_dict is None:
            return
        if not isinstance(input_dict, dict):
            raise TypeError("Input to MetricMeter.update() must be a dictionary")
        for key, value in input_dict.items():
            self.meters.setdefault(key, AverageMeter()).update(float(value))

    def __str__(self) -> str:
        parts = [f"{k} {m.val:.4f} ({m.avg:.4f})" for k, m in self.meters.items()]
        return self.delimiter.join(parts)

    def get_log_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for key, meter in self.meters.items():
            out[key] = meter.val
            out[f"avg_{key}"] = meter.avg
        return out
