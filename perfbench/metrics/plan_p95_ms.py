"""95th percentile of the latency of every plan of the window (host
clock, ms; linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    lat = getattr(ctx, "latency_s", None)
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
