from .augment import IMAGENET_MEAN, IMAGENET_STD, normalize_images

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_images"]
