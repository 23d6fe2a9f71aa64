"""The PyTorch port's ops/nn.py against the JAX package's, on the same numpy
inputs. Both run in float32 on the CPU; the port's functions take torch
weight layouts, so the test transposes the JAX-layout weights it draws."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from autonomous_driving_with_diffusion_model_tpu.ops import nn as jnn
from autonomous_driving_with_diffusion_model_tpu_torch.ops import nn as tnn


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _mish(rng):
    x = rng.standard_normal((4, 16, 8)).astype(np.float32) * 4
    return jnn.mish(jnp.asarray(x)), tnn.mish(_t(x))


def _pos_emb(rng):
    t = np.array([0.0, 1.0, 37.0, 99.0], np.float32)
    return jnn.sinusoidal_pos_emb(jnp.asarray(t), 64), tnn.sinusoidal_pos_emb(_t(t), 64)


def _group_norm(rng):
    x = rng.standard_normal((2, 16, 32)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    return jnn.group_norm(jnp.asarray(x), g, b, 8), tnn.group_norm(_t(x), _t(g), _t(b), 8)


def _channel_layer_norm(rng):
    x = rng.standard_normal((2, 16, 32)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    # the reference keeps g/b as (1, C, 1) parameters
    want = jnn.channel_layer_norm(jnp.asarray(x), g, b)
    return want, tnn.channel_layer_norm(_t(x), _t(g).reshape(1, -1, 1), _t(b).reshape(1, -1, 1))


def _conv1d_k5(rng):
    x = rng.standard_normal((2, 16, 7)).astype(np.float32)
    w = rng.standard_normal((5, 7, 32)).astype(np.float32) * 0.2  # (K, Cin, Cout)
    b = rng.standard_normal(32).astype(np.float32)
    want = jnn.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), padding=2)
    return want, tnn.conv1d(_t(x), _t(w.transpose(2, 1, 0)), _t(b), padding=2)


def _conv1d_down(rng):
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    w = rng.standard_normal((3, 32, 32)).astype(np.float32) * 0.2
    b = rng.standard_normal(32).astype(np.float32)
    want = jnn.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=2, padding=1)
    return want, tnn.conv1d(_t(x), _t(w.transpose(2, 1, 0)), _t(b), stride=2, padding=1)


def _conv1d_transpose(rng):
    x = rng.standard_normal((2, 4, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16, 16)).astype(np.float32) * 0.2  # JAX (K, Cin, Cout)
    b = rng.standard_normal(16).astype(np.float32)
    want = jnn.conv1d_transpose(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    # torch ConvTranspose1d weight (Cin, Cout, K) (torch_convert T_CONVT1D)
    return want, tnn.conv1d_transpose(_t(x), _t(w.transpose(1, 2, 0)), _t(b))


def _conv2d(rng):
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    w = rng.standard_normal((7, 7, 3, 16)).astype(np.float32) * 0.1  # HWIO
    want = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), None, stride=2, padding=3)
    return want, tnn.conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), None, stride=2, padding=3)


# float32 on both sides; convolutions sum up to 147 products in another order
CASES = {
    "mish": (_mish, 1e-6),
    "sinusoidal_pos_emb": (_pos_emb, 1e-5),
    "group_norm": (_group_norm, 1e-5),
    "channel_layer_norm": (_channel_layer_norm, 1e-5),
    "conv1d_k5": (_conv1d_k5, 1e-5),
    "conv1d_stride2": (_conv1d_down, 1e-5),
    "conv1d_transpose": (_conv1d_transpose, 1e-5),
    "conv2d": (_conv2d, 2e-5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name, rng):
    fn, atol = CASES[name]
    want, got = fn(rng)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=1e-5)
