"""Samples of every train step of the window over the window's seconds,
which end in a device synchronize (host clock)."""


def read(ctx):
    if getattr(ctx, "kind", None) != "train" or not ctx.window_s:
        return None
    return ctx.units * ctx.batch / ctx.window_s
