"""Mean device milliseconds of the augmentation program's call per step
(CUDA events around it, over the traced run's window)."""


def read(ctx):
    ms = getattr(ctx, "augment_ms", None)
    return sum(ms) / len(ms) if getattr(ctx, "kind", None) == "train" and ms else None
