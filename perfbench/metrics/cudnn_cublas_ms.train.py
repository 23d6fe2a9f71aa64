"""Device milliseconds per train step of cuDNN's and cuBLAS's kernels
(their FFT, weight-gradient and data-gradient kernels too), over the
traced stretch of steps."""


def read(ctx):
    tr = getattr(ctx, "trace", None)
    if getattr(ctx, "kind", None) != "train" or not tr or not tr["units"]:
        return None
    ms = tr["by_kind"].get("cudnn/cublas", 0.0) * 1e3
    return ms / tr["units"] if ms > 0 else None
