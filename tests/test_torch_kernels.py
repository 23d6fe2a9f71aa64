"""The port's two kernels (ops/kernels.py): their plain versions against the
JAX Pallas kernels (interpret mode, as tests/test_pallas.py runs them), the
wrappers' CPU and autograd behaviour, and, on a card only, the CUDA kernels
against the plain versions.

JAX is imported inside the tests that compare with it, so that the ``gpu``
tests also run on a machine without JAX:
``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels

# (B, L, Cin, C, E): the test_pallas cases, then a sample of the planner's
# main-path shapes (MODEL.DIM 64, E = 128)
RES_CASES = [
    (2, 16, 7, 32, 24),
    (2, 16, 32, 32, 24),
    (1, 16, 7, 64, 128),
    (2, 8, 64, 128, 128),
    (1, 2, 512, 512, 128),
    (2, 2, 1024, 256, 128),
    (1, 4, 512, 128, 128),
]
CONV_CASES = [(2, 16, 7, 64), (1, 16, 64, 64), (2, 16, 128, 256)]
# every residual-block shape of the default U-Net forward, then the head
MAIN_RES = [(16, 7, 64), (16, 64, 64), (8, 64, 128), (8, 128, 128), (4, 128, 256),
            (4, 256, 256), (2, 256, 512), (2, 512, 512), (2, 1024, 256), (2, 256, 256),
            (4, 512, 128), (4, 128, 128), (8, 256, 64), (8, 64, 64)]


def _res_inputs(rng, B, L, cin, c, e):
    """numpy (x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, wres, bres), weights
    at the scale of torch's default init."""
    u = lambda shape, fan: rng.uniform(-1, 1, shape).astype(np.float32) / np.sqrt(fan)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    has_res = cin != c
    return [
        n(B, L, cin), n(B, e),
        u((5, cin, c), 5 * cin), u((c,), 5 * cin), 1 + 0.1 * n(c), 0.1 * n(c),
        u((e, c), e), u((c,), e),
        u((5, c, c), 5 * c), u((c,), 5 * c), 1 + 0.1 * n(c), 0.1 * n(c),
        u((1, cin, c), cin) if has_res else None, u((c,), cin) if has_res else None,
    ]


def _conv_inputs(rng, B, L, cin, c):
    return [
        rng.standard_normal((B, L, cin)).astype(np.float32),
        (rng.standard_normal((5, cin, c)) * 0.1).astype(np.float32),
        (rng.standard_normal(c) * 0.1).astype(np.float32),
        (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32),
        (rng.standard_normal(c) * 0.1).astype(np.float32),
    ]


def _torch(arrays, device="cpu", dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(device, dtype) for a in arrays]


def _jax(arrays):
    import jax.numpy as jnp

    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,L,cin,c,e", RES_CASES)
def test_residual_block_plain_matches_pallas(rng, B, L, cin, c, e):
    from autonomous_driving_with_diffusion_model_tpu.ops.pallas_kernels import fused_residual_block

    arrays = _res_inputs(rng, B, L, cin, c, e)
    want = np.asarray(fused_residual_block(*_jax(arrays), interpret=True))
    got = kernels.residual_block_plain(*_torch(arrays))
    # tests/test_pallas.py's tolerance: fp32, one-pass vs two-pass GN statistics
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("B,L,cin,c", CONV_CASES)
def test_conv_block_plain_matches_pallas(rng, B, L, cin, c):
    from autonomous_driving_with_diffusion_model_tpu.ops.pallas_kernels import fused_conv1d_gn_mish

    arrays = _conv_inputs(rng, B, L, cin, c)
    want = np.asarray(fused_conv1d_gn_mish(*_jax(arrays), interpret=True))
    got = kernels.conv1d_gn_mish_plain(*_torch(arrays))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("which", ["residual", "conv"])
def test_wrapper_takes_plain_version_on_cpu(rng, which):
    kernels.reset_launch_counts()
    if which == "residual":
        args = _torch(_res_inputs(rng, 2, 8, 16, 32, 24))
        got = kernels.fused_residual_block(*args)
        want = kernels.residual_block_plain(*args)
    else:
        args = _torch(_conv_inputs(rng, 2, 16, 7, 16))
        got = kernels.fused_conv1d_gn_mish(*args)
        want = kernels.conv1d_gn_mish_plain(*args)
    assert torch.equal(got, want)
    # no kernel was launched, so neither count moved
    assert kernels.fused_residual_block.launches == 0
    assert kernels.fused_conv1d_gn_mish.launches == 0


@pytest.mark.parametrize("which", ["residual", "conv"])
def test_wrapper_raises_under_autograd(rng, which):
    if which == "residual":
        args = _torch(_res_inputs(rng, 1, 8, 16, 16, 24))
        fn = kernels.fused_residual_block
    else:
        args = _torch(_conv_inputs(rng, 1, 16, 7, 16))
        fn = kernels.fused_conv1d_gn_mish
    args[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*args)
    with torch.no_grad():
        fn(*args)  # fine without grad mode


def test_ctypes_signature_matches_the_c_declaration():
    """The argtypes the loader declares have one entry per parameter of the
    C entry point, pointers as c_void_p (ctypes would cut a pointer passed as
    an int)."""
    import ctypes
    import re

    from autonomous_driving_with_diffusion_model_tpu_torch.ops import build

    for source, entries in build.SIGNATURES.items():
        text = (build.CSRC / source).read_text()
        for name, argtypes in entries.items():
            decl = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text).group(1)
            params = [p.strip() for p in decl.split(",")]
            assert len(params) == len(argtypes), name
            for p, a in zip(params, argtypes):
                want = ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float") else ctypes.c_int
                assert a is want, (name, p)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_on_card(dtype):
    _need_card()
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    # fp32: sums in another order than cuDNN; bf16: outputs may round to a
    # neighbouring bf16 value
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=3e-2, rtol=1.6e-2)
    with torch.no_grad():
        for B in (1, 2):
            for L, cin, c in MAIN_RES:
                args = _torch(_res_inputs(rng, B, L, cin, c, 128), "cuda", dt)
                before = kernels.fused_residual_block.launches
                got = kernels.fused_residual_block(*args).float()
                assert kernels.fused_residual_block.launches == before + 1
                want = kernels.residual_block_plain(*args).float()
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **tol)
            args = _torch(_conv_inputs(rng, B, 16, 64, 64), "cuda", dt)
            got = kernels.fused_conv1d_gn_mish(*args).float()
            torch.cuda.synchronize()
            torch.testing.assert_close(got, kernels.conv1d_gn_mish_plain(*args).float(), **tol)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_off_the_main_path():
    """Lengths that are not powers of two and groups of a few channels: the
    CTA's thread count is rounded up to whole warps."""
    _need_card()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for B, L, cin, c, e in RES_CASES[:2] + [(1, 5, 12, 24, 16), (2, 3, 40, 40, 8), (1, 1, 8, 16, 8)]:
            args = _torch(_res_inputs(rng, B, L, cin, c, e), "cuda")
            got = kernels.fused_residual_block(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, kernels.residual_block_plain(*args), atol=1e-4, rtol=1e-4)
        for B, L, cin, c in CONV_CASES + [(1, 13, 9, 16)]:
            args = _torch(_conv_inputs(rng, B, L, cin, c), "cuda")
            got = kernels.fused_conv1d_gn_mish(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, kernels.conv1d_gn_mish_plain(*args), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_input():
    _need_card()
    rng = np.random.default_rng(0)
    args = _torch(_conv_inputs(rng, 1, 16, 64, 64), "cuda")
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            kernels.fused_conv1d_gn_mish(args[0], args[1].transpose(0, 1).contiguous().transpose(0, 1), *args[2:])
        with pytest.raises(TypeError):
            kernels.fused_conv1d_gn_mish(args[0].double(), *args[1:])
        longer = torch.zeros(1, kernels.MAX_L + 1, 64, device="cuda")
        with pytest.raises(ValueError, match="conv_gn_mish takes"):
            kernels.fused_conv1d_gn_mish(longer, *args[1:])
