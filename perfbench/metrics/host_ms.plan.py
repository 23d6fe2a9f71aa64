"""Median host milliseconds of ``plan_begin`` over the window's plans: the
inputs copied into the plan program's buffers, its weights key, the
replay queued, the outputs cloned (host clock)."""

import numpy as np


def read(ctx):
    host = getattr(ctx, "host_s", None)
    return float(np.median(host)) * 1e3 if getattr(ctx, "kind", None) == "plan" and host else None
