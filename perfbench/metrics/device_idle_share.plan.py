"""Share of the traced stretch of plans in which no operation ran on the
device: 100 x (1 - union of the device events' time / wall time)."""


def read(ctx):
    tr = getattr(ctx, "trace", None)
    if getattr(ctx, "kind", None) != "plan" or not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
