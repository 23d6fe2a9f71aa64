"""The port's two kernels (ops/kernels.py): their plain versions against the
JAX Pallas kernels (interpret mode, as tests/test_pallas.py runs them), the
wrappers' CPU and autograd behaviour (the ``Recompute`` autograd.Function
whose backward is the plain version's), and, on a card only, the CUDA
kernels and their gradients against the plain versions.

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


def _grad_inputs(rng, which, B=2):
    """(kernel wrapper, plain version, inputs) at a small shape, every input
    a leaf that needs its gradient; the residual case has a projection."""
    if which == "residual":
        arrays, fn, plain = _res_inputs(rng, B, 8, 16, 32, 24), kernels.fused_residual_block, kernels.residual_block_plain
    else:
        arrays, fn, plain = _conv_inputs(rng, B, 16, 7, 16), kernels.fused_conv1d_gn_mish, kernels.conv1d_gn_mish_plain
    return fn, plain, [a.requires_grad_(True) for a in _torch(arrays)]


def _grads(out, inputs, up):
    return torch.autograd.grad((out * up).sum(), inputs)


@pytest.mark.parametrize("which", ["residual", "conv"])
def test_recompute_gradients_match_plain(rng, which):
    """``Recompute`` (the kernels' autograd.Function), driven with the plain
    forward injected as its launch: its output is the plain version's, and
    its backward gives every input (x, t, each weight, bias, gamma and beta,
    the residual projection) autograd's gradient of the plain version."""
    fn, plain, inputs = _grad_inputs(rng, which)
    up = torch.from_numpy(rng.standard_normal((2, 8 if which == "residual" else 16, 32 if which == "residual" else 16)).astype(np.float32))
    got = kernels.Recompute.apply(plain, plain, dict(n_groups=8, eps=1e-5), *inputs)
    want = plain(*inputs)
    assert torch.equal(got, want)
    for g, w, a in zip(_grads(got, inputs, up), _grads(want, inputs, up), inputs):
        assert g.shape == a.shape
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("which", ["residual", "conv"])
def test_recompute_skips_inputs_without_grad(rng, which):
    """Only the inputs that need a gradient get one; an absent residual
    projection (None) passes through."""
    fn, plain, inputs = _grad_inputs(rng, which)
    if which == "residual":
        inputs = [inputs[0].detach()] + inputs[1:12] + [None, None]  # x fixed, Cin == C needs no wres
        inputs[0] = torch.randn(2, 8, 32)
        inputs[2] = torch.randn(5, 32, 32, requires_grad=True)
    else:
        inputs = [inputs[0].detach()] + inputs[1:]
    got = kernels.Recompute.apply(plain, plain, dict(n_groups=8, eps=1e-5), *inputs)
    wrt = [a for a in inputs if a is not None and a.requires_grad]
    g = torch.autograd.grad(got.sum(), wrt)
    w = torch.autograd.grad(plain(*inputs).sum(), wrt)
    for a, b in zip(g, w):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("which", ["residual", "conv"])
def test_wrapper_differentiates_on_cpu(rng, which):
    """On CPU tensors the wrapper is the plain version, which autograd
    differentiates as it stands; no kernel launch is counted."""
    kernels.reset_launch_counts()
    fn, plain, inputs = _grad_inputs(rng, which)
    out = fn(*inputs)
    assert out.grad_fn is not None and "Recompute" not in type(out.grad_fn).__name__
    for g, w in zip(torch.autograd.grad(out.sum(), inputs), torch.autograd.grad(plain(*inputs).sum(), inputs)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert kernels.fused_residual_block.launches == 0 and kernels.fused_conv1d_gn_mish.launches == 0


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


# off-path shapes of the gpu tests: lengths that are not powers of two,
# groups of a few channels, Cin that no cluster size divides
OFF_RES = [(1, 5, 12, 24, 16), (2, 3, 40, 40, 8), (1, 1, 8, 16, 8), (1, 16, 7, 64, 128),
           (1, 2, 1000, 512, 128), (2, 3, 1001, 64, 32)]
OFF_CONV = [(1, 13, 9, 16), (2, 16, 1000, 64)]
# the five 512-wide blocks of the U-Net (downs.3.x, mid, ups.0.0), (L, Cin, C)
WIDE = [(2, 256, 512), (2, 512, 512), (2, 1024, 256)]


def _geometry_cases():
    """(id, B, L, Cin, C, E) of every residual-block launch pair, main-path
    and off-path."""
    cases = []
    for B in (1, 2):
        for L, cin, c in MAIN_RES:
            cases.append((f"main-B{B}-L{L}-{cin}-{c}", B, L, cin, c, 128))
    for B, L, cin, c, e in RES_CASES + OFF_RES:
        cases.append((f"res-B{B}-L{L}-{cin}-{c}-E{e}", B, L, cin, c, e))
    return cases


@pytest.mark.parametrize("B,L,cin,c,e", [pytest.param(*a[1:], id=a[0]) for a in _geometry_cases()])
def test_launch_geometry(B, L, cin, c, e):
    """Every launch's geometry: the cluster's ranks cover each input row, each
    epilogue row and each output exactly once; the cluster size, threads and
    shared memory are what the card takes; the 512-wide blocks spread over at
    least 64 CTAs at batch 1."""
    K, groups, cg = 5, 8, c // 8
    epi2 = kernels.EPI_RES_CONV if cin != c else kernels.EPI_RES_ID
    launches = [(cin, c, e, kernels.EPI_TBIAS), (c, c, cin, epi2)]
    geos = list(kernels.residual_block_geometry(B, L, cin, c, e, cin != c))
    for (rows, cout, ce, epi), g in zip(launches, geos):
        assert g == kernels.launch_geometry(B, L, rows, cout, K, groups, ce, epi)
        assert g.cs in (1, 2, 4, 8) and g.cs <= kernels.MAX_CLUSTER
        assert g.ctas == B * groups * g.cs
        reduced = ce if epi in (kernels.EPI_TBIAS, kernels.EPI_RES_CONV) else 0
        for n in (rows, reduced, L * cg):
            covered = np.zeros(n, int)
            for r in range(g.cs):
                lo, hi = kernels.rank_slice(n, g.cs, r)
                covered[lo:hi] += 1
            assert (covered == 1).all()
        if rows < 2 * kernels.MIN_RANK_CHANNELS:
            assert g.cs == 1  # Cin = 7 and the like keep one CTA per group
        assert g.threads <= 1024 and g.threads % 32 == 0 and g.threads >= g.S * cg
        assert g.S * 2 > kernels.MAX_SPLIT or g.S * 2 * cg > kernels.MAX_THREADS
        assert g.smem <= 232448
    if B == 1 and (L, cin, c) in WIDE:
        assert all(g.cs > 1 and g.ctas >= 64 for g in geos)


def _head_cases():
    """(id, B, L, Cin, C) of the head on the main path and of the off-path
    conv shapes."""
    cases = [(f"head-B{B}", B, 16, 64, 64) for B in (1, 2)]
    for B, L, cin, c in CONV_CASES + OFF_CONV:
        cases.append((f"conv-B{B}-L{L}-{cin}-{c}", B, L, cin, c))
    return cases


@pytest.mark.parametrize("B,L,cin,c", [pytest.param(*a[1:], id=a[0]) for a in _head_cases()])
def test_head_geometry(B, L, cin, c):
    """The head's geometry, in float32 and bfloat16: whole warps of at most
    1024 threads, every tile's S lanes in one warp, shared memory the card
    takes, one CTA per (batch row, group), and stages that cover Cin exactly
    once in whole copy units; Cin = 1000 in float32 streams through more than
    one stage, and the main-path head is the one-stage, 16-byte design."""
    K, groups, cg = 5, 8, c // 8
    for nbytes in (4, 2):
        g = kernels.head_geometry(B, L, cin, c, K, groups, nbytes, nbytes)
        assert g.threads <= 1024 and g.threads % 32 == 0
        assert g.S in (1, 2, 4, 8, 16, 32)  # so the S lanes of a tile sit in one warp
        assert g.threads >= g.S * cg * -(-L // kernels.HEAD_P) > g.threads - 32
        assert g.smem <= 232448
        assert g.ctas == B * groups
        covered = np.zeros(cin, int)
        for c0 in range(0, cin, g.stage):
            covered[c0:c0 + g.stage] += 1
        assert (covered == 1).all()
        assert (cin * nbytes) % g.width == 0 and (g.stage * nbytes) % g.width == 0
        assert (cg * nbytes) % g.width == 0
        if (L, cin, c) == (16, 1000, 64) and nbytes == 4:
            assert g.stage < cin
        if (L, cin, c) == (16, 64, 64):
            assert (g.stage, g.width, g.ctas) == (64, 16, 8 * B)


@pytest.mark.parametrize(
    "cin,c,nbytes,align,want",
    [
        (64, 64, 4, 16, 16),  # the main-path head
        (64, 64, 2, 16, 16),
        (9, 16, 4, 16, 4),  # cg = 2: 8-byte weight rows
        (7, 64, 4, 16, 4),  # 28-byte input rows
        (7, 64, 2, 16, 2),  # 14-byte bf16 input rows: no cp.async
        (64, 64, 4, 4, 4),  # a pointer aligned to 4 bytes only
        (64, 8, 2, 16, 2),  # cg = 1 in bf16
    ],
)
def test_head_copy_width(cin, c, nbytes, align, want):
    assert kernels.head_geometry(1, 16, cin, c, 5, 8, nbytes, nbytes, align).width == want


@pytest.mark.parametrize("L,cg,fits", [(16, 256, True), (16, 257, False), (1, 1024, True), (5, 513, False)])
def test_head_geometry_fits_one_cta(L, cg, fits):
    """A group's cg x ceil(L / 4) tiles fit one CTA of at most 1024 threads or
    get a thread count the C side refuses; the wrapper then raises."""
    g = kernels.head_geometry(1, L, 64, 8 * cg, 5, 8)
    assert (g.threads <= kernels.MAX_THREADS) == fits


@pytest.mark.parametrize("which", ["residual", "conv"])
def test_wrapper_refuses_stamps_on_cpu(rng, which):
    """Phase stamps come from the CUDA kernels; the CPU path has none to give."""
    if which == "residual":
        args = _torch(_res_inputs(rng, 1, 8, 16, 16, 24))
        fn, stamps = kernels.fused_residual_block, (torch.zeros(8, 5, 2, dtype=torch.int64),) * 2
    else:
        args = _torch(_conv_inputs(rng, 1, 16, 7, 16))
        fn, stamps = kernels.fused_conv1d_gn_mish, torch.zeros(8, 5, 2, dtype=torch.int64)
    with torch.no_grad(), pytest.raises(ValueError, match="phase stamps"):
        fn(*args, stamps=stamps)


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
            before = kernels.fused_conv1d_gn_mish.launches
            got = kernels.fused_conv1d_gn_mish(*args).float()
            assert kernels.fused_conv1d_gn_mish.launches == before + 1
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,cin,c", CONV_CASES + OFF_CONV)
def test_cuda_head_matches_plain(B, L, cin, c, dtype):
    """The head's kernel off the main path: Cin = 7 and 9 (4-byte copies in
    float32, 2-byte in bfloat16), cg = 2, L = 13, and Cin = 1000, which
    streams through the two-deep ring."""
    _need_card()
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=3e-2, rtol=1.6e-2)
    args = _torch(_conv_inputs(rng, B, L, cin, c), "cuda", dt)
    geo = kernels.head_geometry(B, L, cin, c, 5, 8, args[0].element_size(), args[1].element_size())
    if (L, cin, c) == (13, 9, 16) and dtype == "float32":
        assert geo.width == 4
    if cin == 1000 and dtype == "float32":
        assert geo.stage < cin
    before = kernels.fused_conv1d_gn_mish.launches
    with torch.no_grad():
        got = kernels.fused_conv1d_gn_mish(*args).float()
        want = kernels.conv1d_gn_mish_plain(*args).float()
    torch.cuda.synchronize()
    assert kernels.fused_conv1d_gn_mish.launches == before + 1
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("stage", [16, 24])
def test_cuda_head_at_forced_geometries(monkeypatch, stage):
    """The main-path head with stages forced small, so that the ring runs on
    it (64 = 24 + 24 + 16 takes a ragged last stage)."""
    _need_card()
    pick = kernels.head_geometry
    monkeypatch.setattr(kernels, "head_geometry", lambda *a, **kw: pick(*a, **kw, stage=stage))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for B in (1, 2):
            args = _torch(_conv_inputs(rng, B, 16, 64, 64), "cuda")
            got = kernels.fused_conv1d_gn_mish(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, kernels.conv1d_gn_mish_plain(*args), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 3, 7, 11])
def test_cuda_head_other_kernel_sizes(K):
    """Kernel sizes other than the planner's 5: the taps go five at a time,
    with zero weights past K."""
    _need_card()
    rng = np.random.default_rng(6)
    x, w, b, gamma, beta = _torch(_conv_inputs(rng, 2, 16, 64, 64), "cuda")
    w = torch.from_numpy((rng.standard_normal((K, 64, 64)) * 0.1).astype(np.float32)).cuda()
    with torch.no_grad():
        got = kernels.fused_conv1d_gn_mish(x, w, b, gamma, beta)
        want = kernels.conv1d_gn_mish_plain(x, w, b, gamma, beta)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("cs", [1, 2, 4, 8])
def test_cuda_kernels_match_plain_at_each_cluster_size(monkeypatch, cs):
    """Each cluster size the geometry can pick, forced on shapes whose Cin no
    cluster size divides (ranks of unequal and of empty slices)."""
    _need_card()
    pick = kernels.launch_geometry
    monkeypatch.setattr(kernels, "launch_geometry", lambda *a, **kw: pick(*a, cs=cs))
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for B, L, cin, c, e in OFF_RES:
            args = _torch(_res_inputs(rng, B, L, cin, c, e), "cuda")
            got = kernels.fused_residual_block(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, kernels.residual_block_plain(*args), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_cuda_kernels_repeat_bit_for_bit():
    """No atomics and a fixed order of every sum: two launches of one call
    agree exactly, for both kernels."""
    _need_card()
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for B in (1, 2):
            for L, cin, c in MAIN_RES:
                args = _torch(_res_inputs(rng, B, L, cin, c, 128), "cuda")
                first = kernels.fused_residual_block(*args)
                assert torch.equal(first, kernels.fused_residual_block(*args))
            for shape in [(16, 64, 64)] + [sh[1:] for sh in OFF_CONV]:
                args = _torch(_conv_inputs(rng, B, *shape), "cuda")
                first = kernels.fused_conv1d_gn_mish(*args)
                assert torch.equal(first, kernels.fused_conv1d_gn_mish(*args))


@pytest.mark.gpu
def test_cuda_phase_stamps():
    """A stamped launch gives the same output as a plain one, and each CTA's
    five stamps run forward in time on both clocks."""
    _need_card()
    rng = np.random.default_rng(5)
    with torch.no_grad():
        args = _torch(_conv_inputs(rng, 2, 16, 64, 64), "cuda")
        geo = kernels.head_geometry(2, 16, 64, 64, 5, 8)
        stamps = kernels.phase_stamps(geo.ctas, "cuda")
        got = kernels.fused_conv1d_gn_mish(*args, stamps=stamps)
        assert torch.equal(got, kernels.fused_conv1d_gn_mish(*args))
        args = _torch(_res_inputs(rng, 1, 16, 64, 64, 128), "cuda")
        geos = kernels.residual_block_geometry(1, 16, 64, 64, 128, False)
        pair = tuple(kernels.phase_stamps(g.ctas, "cuda") for g in geos)
        got = kernels.fused_residual_block(*args, stamps=pair)
        assert torch.equal(got, kernels.fused_residual_block(*args))
    for s in (stamps,) + pair:
        s = s.cpu()
        assert (s[:, 0, 0] > 0).all()
        assert (s[:, 1:, :] >= s[:, :-1, :]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("field,value", [("cs", 3), ("cs", 16), ("threads", 2048), ("smem", 4)])
def test_cuda_refused_geometry_raises(field, value):
    """A geometry the residual block's template does not take raises; nothing
    falls back."""
    _need_card()
    rng = np.random.default_rng(0)
    x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, _, _ = _torch(_res_inputs(rng, 1, 16, 64, 64, 128), "cuda")
    h = torch.empty_like(x)
    geo = kernels.launch_geometry(1, 16, 64, 64, 5, 8, 64, kernels.EPI_RES_ID)._replace(**{field: value})
    before = kernels.fused_residual_block.launches
    with torch.no_grad(), pytest.raises(ValueError, match="conv_gn_mish takes"):
        kernels._launch(geo, h, w2, b2, g2, be2, torch.empty_like(x), 8, 1e-5, kernels.EPI_RES_ID, x)
    assert kernels.fused_residual_block.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize(
    "field,value",
    [("threads", 2048), ("threads", 512), ("smem", 4), ("width", 8), ("S", 3), ("stage", 0)],
)
def test_cuda_refused_head_geometry_raises(monkeypatch, field, value):
    """A head geometry the C side does not take raises ValueError through the
    wrapper and leaves its launch count as it was; nothing falls back."""
    _need_card()
    pick = kernels.head_geometry
    monkeypatch.setattr(kernels, "head_geometry", lambda *a, **kw: pick(*a, **kw)._replace(**{field: value}))
    args = _torch(_conv_inputs(np.random.default_rng(0), 1, 16, 64, 64), "cuda")
    before = kernels.fused_conv1d_gn_mish.launches
    with torch.no_grad(), pytest.raises(ValueError, match="conv1d_gn_mish takes"):
        kernels.fused_conv1d_gn_mish(*args)
    assert kernels.fused_conv1d_gn_mish.launches == before


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
        with pytest.raises(ValueError, match="conv1d_gn_mish takes"):
            kernels.fused_conv1d_gn_mish(longer, *args[1:])
        # groups of 257 channels: their tiles do not fit one CTA
        wide = _torch(_conv_inputs(rng, 1, 16, 16, 8 * 257), "cuda")
        before = kernels.fused_conv1d_gn_mish.launches
        with pytest.raises(ValueError, match="conv1d_gn_mish takes"):
            kernels.fused_conv1d_gn_mish(*wide)
        assert kernels.fused_conv1d_gn_mish.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2, 32])
def test_cuda_kernel_gradients_match_plain(B):
    """Both kernels through their autograd.Function at every main-path shape
    (and the training batch, B = 32): the forward against the plain forward,
    and every input's gradient against autograd of the plain version (the
    backward is that autograd, at the same inputs: 1e-4 of the largest
    gradient covers cuDNN's choice of algorithm)."""
    _need_card()
    rng = np.random.default_rng(7)
    shapes = [("res", L, cin, c) for L, cin, c in MAIN_RES] + [("conv", 16, 64, 64)]
    for kind, L, cin, c in shapes:
        arrays = _res_inputs(rng, B, L, cin, c, 128) if kind == "res" else _conv_inputs(rng, B, L, cin, c)
        fn = kernels.fused_residual_block if kind == "res" else kernels.fused_conv1d_gn_mish
        plain = kernels.residual_block_plain if kind == "res" else kernels.conv1d_gn_mish_plain
        got_in = [None if a is None else a.requires_grad_(True) for a in _torch(arrays, "cuda")]
        want_in = [None if a is None else a.detach().clone().requires_grad_(True) for a in got_in]
        before = fn.launches
        got = fn(*got_in)
        assert fn.launches == before + 1
        want = plain(*want_in)
        up = torch.randn_like(want)
        wrt = lambda xs: [a for a in xs if a is not None]
        g_got = torch.autograd.grad((got * up).sum(), wrt(got_in))
        g_want = torch.autograd.grad((want * up).sum(), wrt(want_in))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        for a, b in zip(g_got, g_want):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max()
