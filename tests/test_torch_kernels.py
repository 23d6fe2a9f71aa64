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
# the 16 residual calls of one default U-Net forward, in order: the down
# path, the two middle blocks (512 -> 512 at L = 2), the up path
FORWARD_RES = MAIN_RES[:8] + [(2, 512, 512)] * 2 + MAIN_RES[8:]


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


# (id, B, (L, Cin, C), the card's co-resident clusters, cached pack, p_bytes,
# (one_wave, pdl)): launch_path's rule on the first launch of a block. 16
# clusters of 8 is what an H100 holds at one CTA an SM (the launch floor's
# 128-CTA row in PERF.md); a cluster of one (Cin = 7) has 132 slots.
PATH_CASES = [
    ("one-wave-B1", 1, (2, 512, 512), 16, True, 4, (True, True)),
    ("one-wave-B2", 2, (2, 512, 512), 16, True, 4, (True, True)),
    ("one-wave-B1-bf16", 1, (2, 1024, 256), 16, True, 2, (True, True)),
    ("one-wave-B2-cs1", 2, (16, 7, 64), 132, True, 4, (True, True)),
    ("fresh-pack-B1", 1, (2, 512, 512), 16, False, 4, (True, False)),
    ("multi-wave-B16", 16, (2, 512, 512), 16, True, 4, (False, False)),
    ("multi-wave-B32", 32, (16, 64, 64), 16, True, 4, (False, False)),
    ("clusters-short-B2", 2, (4, 128, 256), 15, True, 4, (False, False)),
    ("slice-too-big-B1", 1, (2, 2048, 2048), 16, True, 4, (False, False)),
]


@pytest.mark.parametrize("B,shape,clusters,cached,p_bytes,want",
                         [pytest.param(*a[1:], id=a[0]) for a in PATH_CASES])
def test_launch_path(B, shape, clusters, cached, p_bytes, want):
    """The one-wave dispatch rule as a pure function of the geometry, the
    co-resident cluster count and the cache-hit flag: batch 1-2 takes the
    one-wave path, with programmatic dependent launch only on a cached pack;
    batch 16 and 32 need more clusters than the card holds; a slice past the
    shared memory stays off it. Today's geometry is kept but for the slice."""
    L, cin, c = shape
    geo = kernels.residual_block_geometry(B, L, cin, c, 128, cin != c)[0]
    wide = kernels.one_wave_geometry(geo, L, cin, c, 5, 8, 128, kernels.EPI_TBIAS, p_bytes)
    base = kernels._geometry(B, L, cin, c, 5, 8, 128, kernels.EPI_TBIAS, geo.cs, kernels.ONE_WAVE_THREADS)
    assert (wide.cs, wide.ctas) == (geo.cs, geo.ctas) and wide.threads <= max(geo.threads, kernels.ONE_WAVE_THREADS)
    assert base._replace(smem=wide.smem) == wide
    rows = 5 * -(-cin // geo.cs) + -(-128 // geo.cs)  # the conv's and the epilogue's
    assert wide.smem == -(-base.smem // 16) * 16 + rows * (c // 8) * p_bytes
    assert kernels.launch_path(wide, clusters, cached) == want
    assert kernels.launch_path(wide, clusters, cached, rows16=False) == (False, False)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("L,cin,c", MAIN_RES)
def test_one_wave_slice_fits_every_main_path_launch(B, L, cin, c):
    """Both launches of every main-path block hold their weight slice in
    shared memory beside today's buffers, in float32 and bfloat16, with
    16-byte weight rows (cg = C / 8 >= 8)."""
    geos = kernels.residual_block_geometry(B, L, cin, c, 128, cin != c)
    launches = [(cin, 128, kernels.EPI_TBIAS),
                (c, cin, kernels.EPI_RES_CONV if cin != c else kernels.EPI_RES_ID)]
    for geo, (rows, ce, epi) in zip(geos, launches):
        for p_bytes in (4, 2):
            wide = kernels.one_wave_geometry(geo, L, rows, c, 5, 8, ce, epi, p_bytes)
            assert wide.smem <= kernels.MAX_SMEM and wide.threads <= kernels.ONE_WAVE_THREADS
            assert (c // 8 * p_bytes) % 16 == 0
            assert kernels.launch_path(wide, 16, True) == (True, True)


# replays' launch counts: a default plan (1,600 calls, 3,200 launches
# one-wave with PDL), a Diffusion Policy plan (1,200 FiLM calls, 700
# one-wave and 1,700 streamed launches, all with PDL) and a free_guidance
# plan of 8 hypotheses (10 forwards at batch 16: 310 folded launches and the
# 10 Cin = 7 first launches one-wave, all with PDL)
REPLAYS = {
    "default": {"fused_conv1d_gn_mish": 100, "fused_residual_block": 1600,
                "fused_residual_block.one_wave": 3200, "fused_residual_block.pdl": 3200,
                "fused_residual_block.streamed": 0, "fused_residual_block.folded": 0,
                "fused_residual_block.film": 0},
    "diffusion_policy": {"fused_conv1d_gn_mish": 100, "fused_residual_block": 1200,
                         "fused_residual_block.one_wave": 700, "fused_residual_block.pdl": 2400,
                         "fused_residual_block.streamed": 1700, "fused_residual_block.folded": 0,
                         "fused_residual_block.film": 1200},
    "free_guidance_k8": {"fused_conv1d_gn_mish": 10, "fused_residual_block": 160,
                         "fused_residual_block.one_wave": 10, "fused_residual_block.pdl": 320,
                         "fused_residual_block.streamed": 0, "fused_residual_block.folded": 310,
                         "fused_residual_block.film": 0},
}


@pytest.mark.parametrize("replay", list(REPLAYS), ids=list(REPLAYS))
def test_path_counts_pass_through_launch_counts(replay):
    """The one-wave, PDL, streamed and folded counts and the FiLM launches
    sit beside the wrappers' counts in launch_counts, and a graph's replay
    adds them through add_launch_counts (with the softmax attention's
    counts, which these U-Net replays do not hold)."""
    replay = REPLAYS[replay]
    kernels.reset_launch_counts()
    counts = kernels.launch_counts()
    keys = set(kernels.WRAPPERS) | set(kernels.PATHS) | {kernels.FILM}
    assert set(counts) == keys | set(kernels.ATTENTION) and keys == set(replay) and not any(counts.values())
    assert {"fused_residual_block.streamed", "fused_residual_block.folded"} <= set(kernels.PATHS)
    kernels.add_launch_counts(replay)
    kernels.add_launch_counts(replay)
    assert kernels.launch_counts() == {k: 2 * replay.get(k, 0) for k in counts}
    f = kernels.fused_residual_block
    assert (f.launches, f.one_wave, f.pdl, f.streamed, f.folded) == tuple(
        2 * replay[k] for k in ("fused_residual_block", *kernels.PATHS))
    kernels.add_launch_counts({"fused_residual_block": 1})  # keys it lacks add nothing
    assert kernels.launch_counts()["fused_residual_block.pdl"] == 2 * replay["fused_residual_block.pdl"]
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts().values())


# Diffusion Policy's CNN at its published widths (MODEL.DIM 512, DIM_MULTS
# (1, 2, 4), a 260-wide conditioning): the (L, Cin, C) of the 12 FiLM calls
# of a forward, in order, and the launches (call, 0: conv 1 with FiLM, 1:
# conv 2 with the residual) that the one-wave path refuses (their slice
# does not fit shared memory): 17 of the 24
DP_E = 260
DP_FILM = [(16, 7, 512), (16, 512, 512), (8, 512, 1024), (8, 1024, 1024), (4, 1024, 2048),
           (4, 2048, 2048), (4, 2048, 2048), (4, 2048, 2048), (4, 4096, 1024), (4, 1024, 1024),
           (8, 2048, 512), (8, 512, 512)]
DP_STREAMED = [(i, j) for i in range(2, 10) for j in (0, 1)] + [(10, 0)]


def _launch(B, L, cin, c, e, j, film):
    """(Cin, Ce, epi) of launch j of a call: conv 1 with the time
    projection (FiLM's), or conv 2 with the residual."""
    if j == 0:
        return cin, e, kernels.EPI_FILM if film else kernels.EPI_TBIAS
    return c, cin, kernels.EPI_RES_CONV if cin != c else kernels.EPI_RES_ID


def _path(monkeypatch, B, L, rows, c, ce, epi, cached=True):
    """_pick_path on meta tensors of a launch's shapes, on a card modelled
    as an H100: 132 SMs, each holding two one-wave CTAs of at most 512
    threads (30 clusters of eight; the card said 15 of 1024-thread CTAs,
    PERF.md)."""
    monkeypatch.setattr(kernels, "_sm_count", lambda device: 132)
    monkeypatch.setattr(kernels, "_max_active_clusters", lambda *a, **kw: {8: 30}.get(a[-1].cs, 264 // a[-1].cs))
    meta = lambda *shape: torch.empty(shape, device="meta")
    x, w, out = meta(B, L, rows), meta(5, rows, c), meta(B, L, c)
    heads = 2 if epi == kernels.EPI_FILM else 1
    ein = ew = None
    if epi in (kernels.EPI_TBIAS, kernels.EPI_FILM):
        ein, ew = meta(B, ce), meta(ce, heads * c)
    elif epi == kernels.EPI_RES_CONV:
        ein, ew = meta(B, L, ce), meta(ce, c)
    elif epi == kernels.EPI_RES_ID:
        ein = meta(B, L, c)
    geo = kernels.launch_geometry(B, L, rows, c, 5, 8, ce, epi)
    return kernels._pick_path(geo, x, w, out, epi, ein, ew, 8, cached)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("call,j", DP_STREAMED, ids=[f"{DP_FILM[i]}-conv{j + 1}" for i, j in DP_STREAMED])
def test_streamed_path_takes_diffusion_policy_wide_launches(monkeypatch, B, call, j):
    """Each of the 17 launches of a Diffusion Policy forward that the
    one-wave path refuses takes the streamed path at batch 1 and 2, with
    programmatic dependent launch on a cached pack only; its geometry cuts
    the rows over one CTA an SM."""
    L, cin, c = DP_FILM[call]
    rows, ce, epi = _launch(B, L, cin, c, DP_E, j, True)
    geo, path, pdl = _path(monkeypatch, B, L, rows, c, ce, epi)
    assert (path, pdl) == ("streamed", True)
    assert _path(monkeypatch, B, L, rows, c, ce, epi, cached=False)[1:] == ("streamed", False)
    assert geo == kernels.streamed_geometry(B, L, rows, c, 5, 8, ce, epi, 4, 132)
    assert geo.ctas == 8 * geo.parts == 128 and geo.threads == kernels.STREAM_THREADS
    chunk = -(-L * c // 8 // kernels.FINISH_CLUSTER)
    assert geo.smem <= kernels.MAX_SMEM and geo.fin_smem == 4 * (36 + 5 * c // 8 + 3 * chunk)
    assert geo.fin_threads == -(-chunk // 32) * 32
    nseg = 1 + (2 if epi == kernels.EPI_FILM else epi != kernels.EPI_RES_ID)
    assert geo.scratch == nseg * 8 * geo.parts * B * L * (c // 8)
    # 16 KB tiles, whole S-row steps, and no more than two rows a thread a tile
    assert geo.tile_rows % geo.S == 0 and geo.tile_rows * (c // 8) * 4 == kernels.STREAM_TILE_BYTES
    assert geo.tile_rows // geo.S == 2


@pytest.mark.parametrize("B", [1, 2, 8, 16, 32, 64])
def test_streamed_path_never_takes_default_widths(monkeypatch, B):
    """The default U-Net's launches never take the streamed path: one-wave
    at batch 1-2 (both launches of every block); folded at batch 8-32 in
    clusters of 16 (but the Cin = 7 first launch, which has fewer input
    channels than ranks and whose clusters of one the card holds all at
    once: one-wave); at batch 64 folded where the slices fit shared memory,
    else the multi-wave code."""
    for L, cin, c in MAIN_RES:
        for j in (0, 1):
            rows, ce, epi = _launch(B, L, cin, c, 128, j, False)
            geo, path, pdl = _path(monkeypatch, B, L, rows, c, ce, epi)
            if B <= 2:
                assert path == "one_wave", (L, cin, c, j)
            elif rows == 7:
                assert path == ("one_wave" if B <= 32 else "multi_wave"), (L, cin, c, j)
            elif B <= 32:
                assert (path, pdl) == ("folded", True), (L, cin, c, j)
                assert geo == kernels.folded_geometry(B, L, rows, c, 5, 8, ce, epi, 4, 16)
            else:
                fits = kernels.folded_geometry(B, L, rows, c, 5, 8, ce, epi, 4, 16) is not None
                assert path == ("folded" if fits else "multi_wave"), (L, cin, c, j)
            assert path != "streamed"
            if B > 2:
                assert kernels.streamed_geometry(B, L, rows, c, 5, 8, ce, epi, 4, 132) is None


@pytest.mark.parametrize("B", [3, 8, 16, 32])
@pytest.mark.parametrize("L,cin,c", MAIN_RES)
def test_folded_geometry_partitions_the_weights(B, L, cin, c):
    """Both launches of every main-path block at batch 3-32 have a folded
    geometry in float32 and bfloat16 within the shared memory in clusters of
    16 and of 8; the Cin = 7 launch has none, clusters of 8 or 16 leaving
    ranks without input channels. A geometry is one cluster a group, whose
    ranks'
    slices cover each of the K x Cin conv rows, each epilogue row and each
    batch row's outputs exactly once, so each weight of the call is fetched
    by exactly one CTA; the slice the C side sizes holds the largest rank's
    rows; the threads take the register tiles in one pass where the batch
    allows."""
    K, groups, cg = 5, 8, c // 8
    launches = [(cin, 128, kernels.EPI_TBIAS),
                (c, cin, kernels.EPI_RES_CONV if cin != c else kernels.EPI_RES_ID)]
    for rows, ce, epi in launches:
        for cs in kernels.FOLD_CLUSTERS:
            for p_bytes in (4, 2):
                geo = kernels.folded_geometry(B, L, rows, c, K, groups, ce, epi, p_bytes, cs)
                if rows < cs:
                    assert geo is None
                    continue
                assert geo is not None and geo.smem <= kernels.MAX_SMEM
                assert geo.ctas == groups * cs and geo.threads <= kernels.FOLD_THREADS and geo.threads % 32 == 0
                assert geo.S in (1, 2, 4) and geo.S <= -(-rows // cs)
                tl = 1 if L == 1 else 2 if L == 2 else 4
                tiles = -(-B // (kernels.FOLD_PAIRS // tl)) * -(-L // tl) * (cg // 4)
                assert geo.threads == min(kernels.FOLD_THREADS, -(-tiles * geo.S // 32) * 32)
                reduced = ce if epi != kernels.EPI_RES_ID else 0
                # weight rows: (tap, input channel) of the conv, then the epilogue's
                owners = np.zeros((K, rows), int)
                eowners = np.zeros(reduced, int)
                outs = np.zeros(L * cg, int)
                for r in range(cs):
                    lo, hi = kernels.rank_slice(rows, cs, r)
                    assert hi - lo <= -(-rows // cs)
                    owners[:, lo:hi] += 1
                    elo, ehi = kernels.rank_slice(reduced, cs, r)
                    eowners[elo:ehi] += 1
                    olo, ohi = kernels.rank_slice(L * cg, cs, r)
                    outs[olo:ohi] += 1
                assert (owners == 1).all() and (eowners == 1).all() and (outs == 1).all()


def test_k8_forward_paths_follow_the_rule(monkeypatch):
    """The free_guidance_k8 replay's counts in REPLAYS are what the path
    rule gives the 16 calls of a forward at batch 16 (8 hypotheses under
    CFG's dual batch), over 10 DDIM steps: every launch folded with PDL but
    the Cin = 7 first launch, one-wave with PDL."""
    counts = {"folded": 0, "one_wave": 0, "pdl": 0}
    for L, cin, c in FORWARD_RES:
        for j in (0, 1):
            rows, ce, epi = _launch(16, L, cin, c, 128, j, False)
            _, path, pdl = _path(monkeypatch, 16, L, rows, c, ce, epi)
            counts[path] = counts.get(path, 0) + 1
            counts["pdl"] += pdl
    want = REPLAYS["free_guidance_k8"]
    assert len(FORWARD_RES) * 10 == want["fused_residual_block"]
    assert {k: 10 * counts[k] for k in ("folded", "one_wave", "pdl")} == {
        k: want[f"fused_residual_block.{k}"] for k in ("folded", "one_wave", "pdl")}
    assert set(counts) == {"folded", "one_wave", "pdl"}


@pytest.mark.parametrize("B", [3, 8])
def test_folded_path_takes_film_where_it_fits(monkeypatch, B):
    """Diffusion Policy's FiLM launches at batch 3 and 8: folded (with FiLM's
    two heads in the epilogue) where the folded slices fit shared memory,
    the multi-wave code where they do not (the 1024- and 2048-wide weights),
    one-wave for the Cin = 7 first launch; never streamed."""
    seen = set()
    for L, cin, c in DP_FILM:
        for j in (0, 1):
            rows, ce, epi = _launch(B, L, cin, c, DP_E, j, True)
            geo, path, _ = _path(monkeypatch, B, L, rows, c, ce, epi)
            if rows == 7:
                assert path == "one_wave"
            elif kernels.folded_geometry(B, L, rows, c, 5, 8, ce, epi, 4, 16) is not None:
                assert path == "folded" and geo.cs == 16
            else:
                assert path == "multi_wave" and kernels.folded_geometry(B, L, rows, c, 5, 8, ce, epi, 4, 8) is None
            seen.add((path, epi))
    assert {("folded", kernels.EPI_FILM), ("multi_wave", kernels.EPI_FILM)} <= seen


@pytest.mark.parametrize("B,L,p_bytes,why", [
    (3, 4, 4, "batch 3"), (2, 16, 4, "32 pairs"), (1, 16, 2, None), (2, 8, 2, None), (1, 4, 4, None)])
def test_streamed_geometry_limits(B, L, p_bytes, why):
    """The streamed path takes batch 1-2 up to 16 (batch row, position)
    pairs, in float32 and bfloat16, and nothing past them."""
    geo = kernels.streamed_geometry(B, L, 2048, 2048, 5, 8, DP_E, kernels.EPI_FILM, p_bytes, 132)
    assert (geo is None) == (why is not None)
    if geo is not None:
        assert geo.tile_rows * 256 * p_bytes == kernels.STREAM_TILE_BYTES and geo.smem <= kernels.MAX_SMEM
    # rows that do not copy in 16-byte pieces
    assert kernels.streamed_geometry(1, 4, 2048, 8 * 6, 5, 8, DP_E, kernels.EPI_FILM, 4, 132) is None


def test_block_passes_its_cache_hit(monkeypatch):
    """ResidualTemporalMapBlock tells the wrapper whether its pack was made
    before the call: not on the first call, after an in-place update of a
    parameter, or under autograd; yes on a repeat."""
    from autonomous_driving_with_diffusion_model_tpu_torch.models import blocks

    seen = []
    real = blocks.fused_residual_block

    def spy(*args, weights_cached=False, **kw):
        seen.append(weights_cached)
        return real(*args, **kw)

    monkeypatch.setattr(blocks, "fused_residual_block", spy)
    torch.manual_seed(0)
    block = blocks.ResidualTemporalMapBlock(16, 32, 24)
    x, t = torch.randn(1, 8, 16), torch.randn(1, 24)
    with torch.no_grad():
        first = block(x, t)
        assert torch.equal(block(x, t), first)
        block.blocks[0].block[0].weight.mul_(1.01)
        block(x, t)
        block(x, t)
    block(x, t)  # under autograd: a pack in the graph, made now
    assert seen == [False, True, False, True, False]


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
    monkeypatch.setattr(kernels, "streamed_geometry", lambda *a, **kw: None)  # the cluster paths only
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
@pytest.mark.parametrize("field,value", [("parts", 0), ("threads", 256), ("smem", 16), ("fin_threads", 32)])
def test_cuda_refused_streamed_geometry_raises(field, value):
    """A streamed geometry the C side does not compute from the shapes
    raises; nothing falls back."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(23)
    x, t, w1, b1, g1, be1, tw, tb = _film_call(gen, 1, 4, 1024, 1024, DP_E)[:8]
    geo = kernels.streamed_geometry(1, 4, 1024, 1024, 5, 8, DP_E, kernels.EPI_FILM, 4,
                                    kernels._sm_count(x.device.index))._replace(**{field: value})
    with torch.no_grad(), pytest.raises(ValueError, match="streamed path does not take"):
        kernels._launch_streamed(geo, x, w1, b1, g1, be1, torch.empty_like(x), 8, 1e-5, kernels.EPI_FILM,
                                 t, tw, tb)


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


def _paths():
    return kernels.fused_residual_block.one_wave, kernels.fused_residual_block.pdl


@pytest.fixture
def multi_wave(monkeypatch):
    """A context that sends every launch down the multi-wave code: the card
    is said to hold no cluster of a one-wave launch, and no launch has a
    streamed geometry."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        with monkeypatch.context() as m:
            m.setattr(kernels, "_max_active_clusters", lambda *a, **kw: 0)
            m.setattr(kernels, "streamed_geometry", lambda *a, **kw: None)
            yield

    return ctx


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_wave_matches_plain_on_card(dtype, multi_wave):
    """The one-wave path, launched as the blocks launch a cached pack (with
    programmatic dependent launch), at every main-path shape at B = 1 and 2:
    against the plain version at the present tolerances, and bit for bit
    against today's path where both split each sum over the same S threads
    (the same sums in the same order). Every batch-1 launch takes it; a
    batch-2 launch takes it where the card holds all its clusters at once."""
    _need_card()
    rng = np.random.default_rng(10)
    dt = getattr(torch, dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=3e-2, rtol=1.6e-2)
    with torch.no_grad():
        for B in (1, 2):
            for L, cin, c in MAIN_RES:
                args = _torch(_res_inputs(rng, B, L, cin, c, 128), "cuda", dt)
                before = _paths()
                got = kernels.fused_residual_block(*args, weights_cached=True)
                one_wave, pdl = (a - b for a, b in zip(_paths(), before))
                assert one_wave == pdl and (one_wave == 2 or B == 2)
                with multi_wave():
                    before = _paths()
                    old = kernels.fused_residual_block(*args, weights_cached=True)
                    assert _paths() == before
                want = kernels.residual_block_plain(*args)
                torch.cuda.synchronize()
                geos = kernels.residual_block_geometry(B, L, cin, c, 128, cin != c)
                if all(kernels.one_wave_geometry(g, L, rows, c, 5, 8, ce, epi, 4).S == g.S
                       for g, (rows, ce, epi) in zip(geos, [(cin, 128, kernels.EPI_TBIAS),
                                                            (c, cin, kernels.EPI_RES_CONV)])):
                    assert torch.equal(got, old)
                torch.testing.assert_close(old.float(), want.float(), **tol)
                torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
def test_one_wave_repeats_bit_for_bit_on_card():
    """Two launches of one call on the one-wave path agree exactly, with and
    without programmatic dependent launch."""
    _need_card()
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for B in (1, 2):
            for L, cin, c in MAIN_RES:
                args = _torch(_res_inputs(rng, B, L, cin, c, 128), "cuda")
                first = kernels.fused_residual_block(*args, weights_cached=True)
                assert torch.equal(first, kernels.fused_residual_block(*args, weights_cached=True))
                assert torch.equal(first, kernels.fused_residual_block(*args))


def _chain_blocks(rng, widths, L, B, device):
    """Residual blocks' kernel arguments (without x) along ``widths``."""
    blocks = []
    for cin, c in zip(widths, widths[1:]):
        arrays = _res_inputs(rng, B, L, cin, c, 128)
        blocks.append((_torch(arrays[1:2], device)[0], _torch(arrays[2:], device)))
    return blocks


def _run_chain(x, blocks, fn, **kw):
    for t, params in blocks:
        x = fn(x, t, *params, **kw)
    return x


@pytest.mark.gpu
def test_one_wave_chain_in_a_graph_on_card():
    """16 chained blocks at B = 1 captured in one CUDA graph with
    programmatic dependent launch (the attribute becomes programmatic
    edges): the replay equals the same chain launched eagerly bit for bit,
    and the plain chain within 16 blocks' rounding; every launch counted on
    the one-wave path with PDL, in the eager chain and in the capture."""
    _need_card()
    rng = np.random.default_rng(13)
    widths = [256, 512] + [512] * 14 + [256]  # a projection at each end, identities between
    blocks = _chain_blocks(rng, widths, 2, 1, "cuda")
    x0 = torch.from_numpy(rng.standard_normal((1, 2, 256)).astype(np.float32)).cuda()
    with torch.no_grad():
        kernels.reset_launch_counts()
        eager = _run_chain(x0, blocks, kernels.fused_residual_block, weights_cached=True)
        assert _paths() == (32, 32)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _run_chain(x0, blocks, kernels.fused_residual_block, weights_cached=True)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        kernels.reset_launch_counts()
        with torch.cuda.graph(graph):
            out = _run_chain(x0, blocks, kernels.fused_residual_block, weights_cached=True)
        assert _paths() == (32, 32)
        graph.replay()
        plain = _run_chain(x0, blocks, kernels.residual_block_plain)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        # each block's sums in another order than cuDNN's, over 16 blocks
        torch.testing.assert_close(out, plain, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_fresh_pack_launches_without_pdl_on_card():
    """A block whose weights a kernel wrote just before its call (a pack
    made in the call): launched on the one-wave path without programmatic
    dependent launch, equal to the plain version of the new weights; the
    next call reuses the pack, with PDL, and gives the same bits."""
    _need_card()
    from autonomous_driving_with_diffusion_model_tpu_torch.models.blocks import ResidualTemporalMapBlock

    torch.manual_seed(0)
    block = ResidualTemporalMapBlock(512, 512, 128).cuda()
    x, t = torch.randn(1, 2, 512, device="cuda"), torch.randn(1, 128, device="cuda")
    with torch.no_grad():
        block(x, t)
        block.blocks[1].block[0].weight.mul_(1.5)  # a kernel writes the weights
        before = _paths()
        got = block(x, t)
        assert tuple(a - b for a, b in zip(_paths(), before)) == (2, 0)
        want = kernels.residual_block_plain(x, t, *block.kernel_params())
        before = _paths()
        again = block(x, t)
        assert tuple(a - b for a, b in zip(_paths(), before)) == (2, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(again, got)


def _streamed():
    return kernels.fused_residual_block.streamed, kernels.fused_residual_block.pdl


def _film_call(gen, B, L, cin, c, e, film=True):
    """A residual block's kernel arguments on the card at the scale of
    torch's default init, drawn there: FiLM's (E, 2C) projection, or the
    time bias's (E, C)."""
    u = lambda shape, fan: (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) / fan ** 0.5
    nrm = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    ce = 2 * c if film else c
    res = cin != c
    return [nrm(B, L, cin), nrm(B, e), u((5, cin, c), 5 * cin), u((c,), 5 * cin), 1 + 0.1 * nrm(c),
            0.1 * nrm(c), u((e, ce), e), u((ce,), e), u((5, c, c), 5 * c), u((c,), 5 * c),
            1 + 0.1 * nrm(c), 0.1 * nrm(c), u((1, cin, c), cin) if res else None, u((c,), cin) if res else None]


@pytest.fixture
def no_one_wave(monkeypatch):
    """A context in which the card is said to hold no one-wave cluster:
    batch 1-2 launches that the streamed path takes go down it."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        with monkeypatch.context() as m:
            m.setattr(kernels, "_max_active_clusters", lambda *a, **kw: 0)
            yield

    return ctx


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("film", [True, False], ids=["film", "time-bias"])
def test_streamed_matches_plain_on_card(dtype, film, no_one_wave):
    """The streamed path at the ten geometries of Diffusion Policy's FiLM
    calls (the card said to hold no one-wave cluster, so that the 512-wide
    ones take it too), at B = 1 and 2, in float32 and bfloat16, with each
    epilogue it takes (FiLM or the time bias on conv 1; the residual
    projection or the identity on conv 2): against the plain version at the
    present tolerances. A launch past 16 (batch row, position) pairs (L = 16
    at B = 2) stays on the multi-wave code."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(20 + film)
    dt = getattr(torch, dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=3e-2, rtol=1.6e-2)
    with torch.no_grad(), no_one_wave():
        for L, cin, c in sorted(set(DP_FILM)):
            for B in (1, 2):
                args = [None if a is None else a.to(dt) for a in _film_call(gen, B, L, cin, c, DP_E, film)]
                before = _streamed()
                got = kernels.fused_residual_block(*args, weights_cached=True)
                streamed, pdl = (a - b for a, b in zip(_streamed(), before))
                assert streamed == pdl == (2 if B * L <= kernels.STREAM_MAX_ROWS else 0), (L, cin, c, B)
                want = kernels.residual_block_plain(*args)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
def test_streamed_repeats_bit_for_bit_on_card():
    """Two calls on the streamed path agree exactly, with and without
    programmatic dependent launch, at B = 1 and 2."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(21)
    with torch.no_grad():
        for L, cin, c in [(4, 1024, 2048), (4, 4096, 1024), (8, 2048, 512), (4, 1024, 1024)]:
            for B in (1, 2):
                args = _film_call(gen, B, L, cin, c, DP_E)
                before = _streamed()
                first = kernels.fused_residual_block(*args, weights_cached=True)
                assert _streamed()[0] - before[0] >= 1
                assert torch.equal(first, kernels.fused_residual_block(*args, weights_cached=True))
                assert torch.equal(first, kernels.fused_residual_block(*args))


@pytest.mark.gpu
def test_streamed_chain_in_a_graph_on_card():
    """Diffusion Policy's down path and middle at batch 1 (1024 -> 2048 ->
    2048 -> 2048 -> 1024 at L = 4), captured in one CUDA graph with
    programmatic dependent launch: the replay equals the eager chain bit for
    bit and the plain chain within its rounding; every launch streamed and
    counted with PDL, eagerly and at capture."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(22)
    widths = [1024, 2048, 2048, 2048, 1024]
    blocks = []
    for cin, c in zip(widths, widths[1:]):
        args = _film_call(gen, 1, 4, cin, c, DP_E)
        blocks.append((args[1], args[2:]))
    x0 = torch.randn(1, 4, 1024, generator=gen, device="cuda")
    want_counts = (8, 8)
    with torch.no_grad():
        kernels.reset_launch_counts()
        eager = _run_chain(x0, blocks, kernels.fused_residual_block, weights_cached=True)
        assert _streamed() == want_counts
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _run_chain(x0, blocks, kernels.fused_residual_block, weights_cached=True)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        kernels.reset_launch_counts()
        with torch.cuda.graph(graph):
            out = _run_chain(x0, blocks, kernels.fused_residual_block, weights_cached=True)
        assert _streamed() == want_counts
        graph.replay()
        plain = _run_chain(x0, blocks, kernels.residual_block_plain)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        torch.testing.assert_close(out, plain, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_streamed_fresh_pack_launches_without_pdl_on_card():
    """A FiLM block whose weights a kernel wrote just before its call (a
    pack made in the call): both launches streamed without programmatic
    dependent launch, equal to the plain version of the new weights; the
    next call reuses the pack, with PDL, and gives the same bits."""
    _need_card()
    from autonomous_driving_with_diffusion_model_tpu_torch.models.conditional_unet1d import (
        ConditionalResidualBlock1D,
    )

    torch.manual_seed(0)
    block = ConditionalResidualBlock1D(1024, 2048, DP_E).cuda()
    x, t = torch.randn(1, 4, 1024, device="cuda"), torch.randn(1, DP_E, device="cuda")
    with torch.no_grad():
        block(x, t)
        block.blocks[1].block[0].weight.mul_(1.5)  # a kernel writes the weights
        before = _streamed()
        got = block(x, t)
        assert tuple(a - b for a, b in zip(_streamed(), before)) == (2, 0)
        want = kernels.residual_block_plain(x, t, *block.kernel_params())
        before = _streamed()
        again = block(x, t)
        assert tuple(a - b for a, b in zip(_streamed(), before)) == (2, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(again, got)


def _folded():
    return kernels.fused_residual_block.folded, kernels.fused_residual_block.pdl


FOLD_BATCHES = [3, 8, 16, 32]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_matches_plain_on_card(dtype, multi_wave):
    """The folded path, launched as the blocks launch a cached pack (with
    programmatic dependent launch), at every main-path shape at B = 3, 8, 16
    and 32: every launch folded but the Cin = 7 first launch (one-wave),
    against the plain version at the present tolerances; the multi-wave code
    forced at the same shapes still matches the plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(30)
    dt = getattr(torch, dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=3e-2, rtol=1.6e-2)
    with torch.no_grad():
        for B in FOLD_BATCHES:
            for L, cin, c in MAIN_RES:
                args = [None if a is None else a.to(dt) for a in _film_call(gen, B, L, cin, c, 128, film=False)]
                before = _folded()
                got = kernels.fused_residual_block(*args, weights_cached=True)
                folded, pdl = (a - b for a, b in zip(_folded(), before))
                assert (folded, pdl) == (1 if cin == 7 else 2, 2), (B, L, cin, c)
                with multi_wave():
                    before = _folded()
                    old = kernels.fused_residual_block(*args, weights_cached=True)
                    assert _folded() == before
                want = kernels.residual_block_plain(*args)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(), **tol)
                torch.testing.assert_close(old.float(), want.float(), **tol)


@pytest.mark.gpu
def test_folded_repeats_bit_for_bit_on_card():
    """Two calls on the folded path agree exactly, with and without
    programmatic dependent launch (a fixed order of every sum, no atomics)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(31)
    with torch.no_grad():
        for B in FOLD_BATCHES:
            for L, cin, c in MAIN_RES:
                args = _film_call(gen, B, L, cin, c, 128, film=False)
                first = kernels.fused_residual_block(*args, weights_cached=True)
                assert torch.equal(first, kernels.fused_residual_block(*args, weights_cached=True))
                assert torch.equal(first, kernels.fused_residual_block(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [16, 32])
def test_folded_chain_in_a_graph_on_card(B):
    """A default forward's 16 residual calls in order (without the
    resampling between levels: each call on its own input) at B = 16 and 32,
    captured in one CUDA graph with programmatic dependent launch: the
    replay equals the eager calls bit for bit and the plain version within
    its rounding; 31 launches folded and the Cin = 7 launch one-wave, all
    with PDL, eagerly and at capture."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(32 + B)
    calls = [_film_call(gen, B, L, cin, c, 128, film=False) for L, cin, c in FORWARD_RES]
    want_counts = (2 * len(calls) - 1, 2 * len(calls))

    def run():
        return [kernels.fused_residual_block(*args, weights_cached=True) for args in calls]

    with torch.no_grad():
        kernels.reset_launch_counts()
        eager = run()
        assert _folded() == want_counts and kernels.fused_residual_block.one_wave == 1
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        kernels.reset_launch_counts()
        with torch.cuda.graph(graph):
            outs = run()
        assert _folded() == want_counts
        for o in outs:
            o.zero_()
        graph.replay()
        plain = [kernels.residual_block_plain(*args) for args in calls]
        torch.cuda.synchronize()
        for o, e, p in zip(outs, eager, plain):
            assert torch.equal(o, e)
            torch.testing.assert_close(o, p, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_folded_fresh_pack_launches_without_pdl_on_card():
    """A block at batch 16 whose weights a kernel wrote just before its call
    (a pack made in the call): both launches folded without programmatic
    dependent launch, equal to the plain version of the new weights; the
    next call reuses the pack, with PDL, and gives the same bits."""
    _need_card()
    from autonomous_driving_with_diffusion_model_tpu_torch.models.blocks import ResidualTemporalMapBlock

    torch.manual_seed(0)
    block = ResidualTemporalMapBlock(256, 512, 128).cuda()
    x, t = torch.randn(16, 2, 256, device="cuda"), torch.randn(16, 128, device="cuda")
    with torch.no_grad():
        block(x, t)
        block.blocks[1].block[0].weight.mul_(1.5)  # a kernel writes the weights
        before = _folded()
        got = block(x, t)
        assert tuple(a - b for a, b in zip(_folded(), before)) == (2, 0)
        want = kernels.residual_block_plain(x, t, *block.kernel_params())
        before = _folded()
        again = block(x, t)
        assert tuple(a - b for a, b in zip(_folded(), before)) == (2, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_film_on_card(dtype):
    """FiLM calls at Diffusion Policy's widths at batch 3 and 8: a launch
    whose folded slices fit shared memory and whose clusters the card holds
    takes the folded path with FiLM's two heads (some do), the others stay on
    the multi-wave code; every call against the plain version at the present
    tolerances."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(33)
    dt = getattr(torch, dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=3e-2, rtol=1.6e-2)
    seen = 0
    with torch.no_grad():
        for L, cin, c in [(16, 512, 512), (8, 512, 1024), (4, 2048, 2048), (8, 2048, 512)]:
            for B in (3, 8):
                args = [None if a is None else a.to(dt) for a in _film_call(gen, B, L, cin, c, DP_E)]
                fits = [any(kernels.folded_geometry(B, L, rows, c, 5, 8, ce, epi, args[2].element_size(), cs)
                            is not None for cs in kernels.FOLD_CLUSTERS)
                        for rows, ce, epi in (_launch(B, L, cin, c, DP_E, j, True) for j in (0, 1))]
                before = _folded()[0]
                got = kernels.fused_residual_block(*args, weights_cached=True)
                folded = _folded()[0] - before
                assert folded <= sum(fits), (L, cin, c, B)
                seen += folded
                want = kernels.residual_block_plain(*args)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(), **tol)
    assert seen > 0


@pytest.mark.parametrize("raises", [False, True])
def test_recorded_launches_restore_the_counts(raises):
    """``recorded_launches`` holds the launches made inside it, by
    ``launch_counts``' keys, and on leaving sets the counts back to what
    they were, also when the block raises; nested, each block records its
    own."""
    kernels.reset_launch_counts()
    kernels.add_launch_counts({"fused_residual_block": 3, kernels.FILM: 1})
    before = kernels.launch_counts()
    inner = {"fused_conv1d_gn_mish": 1, kernels.PATHS[0]: 4}
    outer = {"fused_residual_block": 5, kernels.FILM: 5}
    try:
        with kernels.recorded_launches() as got:
            kernels.add_launch_counts(outer)  # the launches a replay adds, as wrappers count theirs
            with kernels.recorded_launches() as got_inner:
                kernels.add_launch_counts(inner)
            assert kernels.launch_counts() == {k: before[k] + outer.get(k, 0) for k in before}
            if raises:
                raise KeyError("inside the block")
    except KeyError:
        assert raises
    assert got_inner == {k: inner.get(k, 0) for k in before}
    assert got == {k: outer.get(k, 0) for k in before}
    assert kernels.launch_counts() == before
