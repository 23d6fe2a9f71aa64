"""The roofline bound of every residual-block call of the traced plans
(from shapes: the larger of operations over the float32 peak and bytes
over the memory bandwidth, summed) over the device time the profiler gave
the residual-block kernel (``conv_gn_mish_kernel``, both launches of a
call) in those plans."""


def read(ctx):
    tr = getattr(ctx, "trace", None)
    if getattr(ctx, "kind", None) != "plan" or not tr or not ctx.work:
        return None
    kernel_s = sum(s for name, s in tr["by_name"].items() if "conv_gn_mish_kernel" in name)
    if kernel_s <= 0:
        return None
    return 100.0 * tr["units"] * ctx.work["residual_bound_s"] / kernel_s
