"""Median plan latency over every plan of the window (host clock, ms)."""

import numpy as np


def read(ctx):
    lat = getattr(ctx, "latency_s", None)
    return float(np.median(lat)) * 1e3 if lat else None
