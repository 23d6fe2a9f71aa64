"""From process start to the first timed request (host clock)."""


def read(ctx):
    return getattr(ctx, "setup_s", None)
