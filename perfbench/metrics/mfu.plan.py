"""The window's plans' operations (counted from the configuration's
shapes: the encoder once, every denoising step's U-Net forward at its
batch) over the window's seconds, as a share of the card's data-sheet peak
in the compute dtype (float32 outside the tensor cores; bfloat16 dense)."""


def read(ctx):
    if getattr(ctx, "kind", None) != "plan" or not ctx.window_s or not ctx.work:
        return None
    peak = ctx.rates["fp32_flops" if ctx.cfg["TPU"]["COMPUTE_DTYPE"] == "float32" else "bf16_flops"]
    return 100.0 * ctx.units * ctx.work["flops"] / ctx.window_s / peak
