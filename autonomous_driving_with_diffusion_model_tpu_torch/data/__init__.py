from .augment import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    AugmentProgram,
    augment_batch,
    augment_factors,
    normalize_images,
)
from .dataset import DeviceResidentLoader, Loader, TrajDataset, get_loader, maybe_device_resident
from .png import read_png, write_png

__all__ = [
    "TrajDataset",
    "Loader",
    "DeviceResidentLoader",
    "get_loader",
    "maybe_device_resident",
    "augment_batch",
    "AugmentProgram",
    "augment_factors",
    "normalize_images",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "read_png",
    "write_png",
]
