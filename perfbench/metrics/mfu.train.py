"""The window's train steps' operations (counted from the configuration's
shapes: the forward and a backward of twice its operations at
TRAIN.BATCH_SIZE) over the window's seconds, as a share of the card's
data-sheet peak in the compute dtype."""


def read(ctx):
    if getattr(ctx, "kind", None) != "train" or not ctx.window_s or not ctx.step_flops:
        return None
    peak = ctx.rates["fp32_flops" if ctx.cfg["TPU"]["COMPUTE_DTYPE"] == "float32" else "bf16_flops"]
    return 100.0 * ctx.units * ctx.step_flops / ctx.window_s / peak
