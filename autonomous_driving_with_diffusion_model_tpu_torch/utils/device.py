"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a machine without a card raises instead of falling back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


def use_float32_math(device: Union[str, torch.device]) -> None:
    """On the card, float32 convolutions and matmuls compute in float32.
    PyTorch's default lets cuDNN round a float32 convolution's inputs to
    TF32 (a 10-bit mantissa), below the float32 that ``TPU.COMPUTE_DTYPE``
    states and the JAX package's CPU reference computes. The switches are
    process-wide, as PyTorch's are; a bfloat16 model is not affected."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
