"""SigLIP's vision tower (Zhai et al., "Sigmoid Loss for Language Image
Pre-Training", ICCV 2023; the ``so400m-patch14-384`` checkpoint's
``SiglipVisionModel`` in Hugging Face ``transformers``), the image encoder of
RDT-1B (``models/rdt.py``), and the image preprocessing RDT's deployment
applies before it.

A square image is cut into ``patch`` x ``patch`` patches by a strided
convolution (the rows and columns past the last whole patch are dropped: 27
patches a side of 384), each patch gets a learned position embedding, then
``depth`` pre-LayerNorm encoder layers (LayerNorm, multi-head self-attention
with biases, residual; LayerNorm, ``fc1`` . GELU(tanh) . ``fc2``, residual)
and the post-LayerNorm. The output is every patch token (no pooling head).

Parameter names follow ``transformers``' ``SiglipVisionTransformer``
(``embeddings.patch_embedding``, ``embeddings.position_embedding``,
``encoder.layers.<i>.{layer_norm1, self_attn.{q,k,v,out}_proj, layer_norm2,
mlp.fc1, mlp.fc2}``, ``post_layernorm``). Images are channels-last, (B, S,
S, 3), as the port's other encoders take them. The model computes in the
dtype of its parameters; LayerNorm and the softmax accumulate in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nn import attention, conv2d, dense, gelu_tanh, layer_norm

__all__ = ["SiglipVisionTower", "square_resize", "background", "IMAGE_MEAN", "IMAGE_STD"]

IMAGE_MEAN = 0.5  # SigLIP's processor: every channel's mean and std
IMAGE_STD = 0.5
LN_EPS = 1e-6


def square_resize(frames_u8: torch.Tensor, size: int) -> torch.Tensor:
    """RDT's image preprocessing on the device: (B, H, W, 3) uint8 frames
    padded to a square with the processor's mean colour (``int(0.5 * 255)``
    = 127, the frame centred, as RDT's ``expand2square`` pastes it), resized
    to ``size`` x ``size`` (bicubic with antialiasing, in float32, no
    rounding to uint8), scaled to [0, 1] and normalized with the mean and
    std: (B, size, size, 3) float32."""
    x = frames_u8.to(torch.float32).permute(0, 3, 1, 2) / 255.0
    h, w = x.shape[-2:]
    side = max(h, w)
    top, left = (side - h) // 2, (side - w) // 2
    x = F.pad(x, (left, side - w - left, top, side - h - top), value=int(IMAGE_MEAN * 255) / 255.0)
    x = F.interpolate(x, size=(size, size), mode="bicubic", antialias=True, align_corners=False)
    return ((x - IMAGE_MEAN) / IMAGE_STD).permute(0, 2, 3, 1)


def background(size: int, device) -> torch.Tensor:
    """An absent camera's image after preprocessing: RDT's background, the
    mean colour everywhere, (size, size, 3) float32."""
    return torch.full((size, size, 3), (int(IMAGE_MEAN * 255) / 255.0 - IMAGE_MEAN) / IMAGE_STD, device=device)


class _Embeddings(nn.Module):
    def __init__(self, width: int, image_size: int, patch: int):
        super().__init__()
        self.patch = patch
        self.patch_embedding = nn.Conv2d(3, width, patch, patch)
        self.position_embedding = nn.Embedding((image_size // patch) ** 2, width)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = conv2d(images, self.patch_embedding.weight, self.patch_embedding.bias, stride=self.patch)
        x = x.reshape(x.shape[0], -1, x.shape[-1])  # (B, patches, width), row-major patches
        return x + self.position_embedding.weight.to(x.dtype)


class _SelfAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(width, width) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        split = lambda lin: dense(x, lin.weight, lin.bias).reshape(B, N, self.heads, -1).transpose(1, 2)
        o = attention(split(self.q_proj), split(self.k_proj), split(self.v_proj))
        return dense(o.transpose(1, 2).reshape(B, N, C), self.out_proj.weight, self.out_proj.bias)


class _MLP(nn.Module):
    def __init__(self, width: int, mlp: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(width, mlp), nn.Linear(mlp, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(gelu_tanh(dense(x, self.fc1.weight, self.fc1.bias)), self.fc2.weight, self.fc2.bias)


class _EncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, mlp: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.self_attn = _SelfAttention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = _MLP(width, mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ln = lambda m, h: layer_norm(h, m.weight, m.bias, LN_EPS)
        x = x + self.self_attn(ln(self.layer_norm1, x))
        return x + self.mlp(ln(self.layer_norm2, x))


class _Encoder(nn.Module):
    def __init__(self, width: int, depth: int, heads: int, mlp: int):
        super().__init__()
        self.layers = nn.ModuleList([_EncoderLayer(width, heads, mlp) for _ in range(depth)])


class SiglipVisionTower(nn.Module):
    """``images`` (B, S, S, 3), preprocessed (:func:`square_resize`), in the
    model's dtype -> (B, (S // patch)^2, width) patch tokens."""

    def __init__(self, width: int = 1152, depth: int = 27, heads: int = 16, mlp: int = 4304,
                 image_size: int = 384, patch: int = 14):
        super().__init__()
        self.image_size = image_size
        self.tokens = (image_size // patch) ** 2
        self.embeddings = _Embeddings(width, image_size, patch)
        self.encoder = _Encoder(width, depth, heads, mlp)
        self.post_layernorm = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(images)
        for layer in self.encoder.layers:
            x = layer(x)
        return layer_norm(x, self.post_layernorm.weight, self.post_layernorm.bias, LN_EPS)
