"""The port's CUDA kernels for the temporal U-Net: wrappers, launch counts and
plain PyTorch versions (counterpart of the JAX package's
``ops/pallas_kernels.py``).

Each kernel has its own CUDA source:

* ``fused_conv1d_gn_mish`` replaces ``pallas_kernels.py:fused_conv1d_gn_mish``
  (one ``Conv1dBlock``: ``mish(GN8(conv1d_k5(x) + b))``, the U-Net's head),
  one launch of ``ops/csrc/conv1d_gn_mish.cu``, at the geometry of
  :func:`head_geometry`;
* ``fused_residual_block`` replaces ``pallas_kernels.py:fused_residual_block``
  (a whole ``ResidualTemporalMapBlock``), two launches of the template
  ``ops/csrc/conv_gn_mish.cu``, which serves the residual block only: conv 2
  needs every channel of h, a dependency across the whole grid. Each launch's
  geometry comes from :func:`launch_geometry`.

The C side checks each geometry. What bounds the residual block on an H100
is the weight bytes (at batch 1-2 each weight does 2 FLOPs per batch row);
the head moves too little for bytes or FLOPs to matter, and is bound by
latency: its launch, its round trip to memory and the chain of instructions
on its critical path. Each source's header says what its design does about
that. Signatures and layouts are those of the JAX kernels:
x (B, L, Cin), conv weights (K, Cin, C), the time projection (E, C), the
residual projection (1, Cin, C). The modules pack their torch-layout
parameters into these layouts once (``models/blocks.py``), not on every call.

Both kernels can record phase stamps (``stamps=``, off by default): thread 0
of each CTA writes the device's ns timer and its SM's cycle counter at the
five :data:`PHASES`, into an int64 tensor from :func:`phase_stamps`.

A wrapper given CPU tensors computes the plain version, which autograd
differentiates as it stands; given CUDA tensors it launches the kernel or
raises. It adds one to its ``launches`` count for each call that launches.

Neither TPU kernel has a backward (the JAX package trains through the XLA
composite, ``TPU.USE_PALLAS_CONV`` off). So when a CUDA call needs a gradient,
it goes through :class:`Recompute`, a ``torch.autograd.Function`` whose
forward launches the kernel and whose backward recomputes the plain version
from the saved inputs and returns its gradients: the same function JAX's
training differentiates. Hand-written backward kernels are open work.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import torch

from .nn import conv1d, group_norm, mish

__all__ = [
    "fused_conv1d_gn_mish",
    "fused_residual_block",
    "launch_geometry",
    "residual_block_geometry",
    "head_geometry",
    "phase_stamps",
    "rank_slice",
    "conv1d_gn_mish_plain",
    "residual_block_plain",
    "Recompute",
    "reset_launch_counts",
    "launch_counts",
    "add_launch_counts",
]

SOURCE = "conv_gn_mish.cu"  # the residual block's template
HEAD_SOURCE = "conv1d_gn_mish.cu"
EPI_TBIAS, EPI_RES_CONV, EPI_RES_ID = 1, 2, 3
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ERR_SHAPE = -2  # the C function's code for a shape or geometry it does not take
MAX_L = 16  # positions a kernel thread holds in registers
MAX_THREADS = 1024
MAX_SMEM = 232448  # bytes of shared memory a CTA may use
MAX_SPLIT = 32  # threads sharing one channel's reduction inside a CTA
MAX_CLUSTER = 8  # the portable cluster size
MIN_RANK_CHANNELS = 8  # input channels a cluster's rank keeps at least
HEAD_P = 4  # positions of one output channel a head thread holds (the C side's P)
HEAD_MAX_LANES = 8  # lanes sharing one head output's sum
PHASES = ("entry", "loads landed", "outputs in shared memory", "statistics done", "stored")


# ---------------------------------------------------------------- plain versions


def _cgm32(x: torch.Tensor, w, b, gamma, beta, n_groups: int, eps: float) -> torch.Tensor:
    """float32 conv1d(k, pad k//2) + GroupNorm + Mish; w in (K, Cin, C)."""
    f = lambda a: a.to(torch.float32)
    y = conv1d(f(x), f(w).permute(2, 1, 0), f(b), padding=w.shape[0] // 2)
    return mish(group_norm(y, f(gamma), f(beta), n_groups, eps))


def conv1d_gn_mish_plain(x, w, b, gamma, beta, n_groups: int = 8, eps: float = 1e-5):
    """``mish(group_norm(conv1d(x, w, b, padding=K//2)))`` in float32, returned
    in ``x.dtype`` (the composite of ``ops/nn.py``)."""
    return _cgm32(x, w, b, gamma, beta, n_groups, eps).to(x.dtype)


def residual_block_plain(
    x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, wres=None, bres=None,
    n_groups: int = 8, eps: float = 1e-5,
):
    """``CGM2(CGM1(x) + mish(t) tw + tb) + (x wres + bres, or x)`` in float32
    (h stays float32 between the two), returned in ``x.dtype``."""
    f = lambda a: a.to(torch.float32)
    h = _cgm32(x, w1, b1, g1, be1, n_groups, eps)
    h = h + (mish(f(t)) @ f(tw) + f(tb))[:, None, :]
    out = _cgm32(h, w2, b2, g2, be2, n_groups, eps)
    res = f(x) @ f(wres[0]) + f(bres) if wres is not None else f(x)
    return (out + res).to(x.dtype)


# ---------------------------------------------------------------- launch geometry


class Geometry(NamedTuple):
    cs: int  # CTAs in a cluster, which owns one (batch row, group)
    S: int  # threads sharing one channel's reduction inside a CTA
    threads: int  # threads of a CTA
    smem: int  # shared-memory bytes of a CTA
    ctas: int  # CTAs of the launch


def rank_slice(n: int, parts: int, r: int) -> tuple:
    """[start, stop) of part r when n items are cut into ``parts`` contiguous
    slices; the kernel cuts the input channels, the epilogue's rows and the
    outputs over a cluster's ranks with the same formula."""
    return r * n // parts, (r + 1) * n // parts


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_geometry(B, L, Cin, C, K, groups, Ce, epi, cs=None) -> Geometry:
    """The geometry of one launch of the residual block's template: ``Ce`` is
    the epilogue's reduced length (E for ``EPI_TBIAS``, the residual's Cin
    for ``EPI_RES_CONV``, ignored for ``EPI_RES_ID``); ``cs`` forces a cluster
    size.

    A cluster of ``cs`` CTAs owns one (batch row, group); ``cs`` is the
    largest power of two up to 8 that leaves each rank ``MIN_RANK_CHANNELS``
    input channels. The shared memory is the C side's ``layout`` total."""
    cg = C // groups
    S = 1
    while S * 2 <= MAX_SPLIT and S * 2 * cg <= MAX_THREADS:
        S *= 2
    threads = _cdiv(S * cg, 32) * 32
    has_e = epi in (EPI_TBIAS, EPI_RES_CONV)
    Ce = Ce if has_e else 0
    if cs is None:
        cs = 1
        while cs * 2 <= MAX_CLUSTER and Cin // (cs * 2) >= MIN_RANK_CHANNELS:
            cs *= 2
    erows = 1 if epi == EPI_TBIAS else L
    n, ne = L * cg, (erows * cg if has_e else 0)
    chunk = _cdiv(n, cs)  # outputs a rank finishes
    floats = (32 + 4 * cg + n + ne + n + (chunk if epi == EPI_RES_ID else 0)
              + (L + K - 1) * _cdiv(Cin, cs) + erows * _cdiv(Ce, cs) + S * (n + ne))
    return Geometry(cs, S, threads, 4 * floats, B * groups * cs)


def residual_block_geometry(B, L, Cin, C, E, has_res, K=5, groups=8) -> tuple:
    """The geometries of ``fused_residual_block``'s two launches: conv 1 with
    the time projection, conv 2 with the residual (a projection when
    ``has_res``, else the identity)."""
    return (
        launch_geometry(B, L, Cin, C, K, groups, E, EPI_TBIAS),
        launch_geometry(B, L, C, C, K, groups, Cin, EPI_RES_CONV if has_res else EPI_RES_ID),
    )


class HeadGeometry(NamedTuple):
    S: int  # adjacent lanes of a warp sharing one output's K x Cin sum
    threads: int  # threads of a CTA
    width: int  # bytes of each copy into shared memory: 16, 4 or 2
    stage: int  # input channels a stage of shared memory holds
    smem: int  # shared-memory bytes of a CTA
    ctas: int  # CTAs of the launch: one per (batch row, group)


def _round16(n: int) -> int:
    return _cdiv(n, 16) * 16


def _odd_row(nbytes: int, width: int) -> int:
    """Bytes of a shared-memory row: an odd number of copy units of at least
    4 bytes, so that neighbouring rows start in different banks."""
    unit = max(width, 4)
    n = _cdiv(nbytes, unit)
    return (n + (n % 2 == 0)) * unit


def _head_smem(L, Cin, cg, K, width, stage, x_bytes, p_bytes) -> int:
    """The C side's total (``conv1d_gn_mish.cu:make_plan``, which checks this
    number: change the two together): bias, gamma and beta, the group's conv
    outputs in fp32, and one stage buffer (two when Cin takes more than one
    stage) of padded input rows and weight rows."""
    rows = _cdiv(L, HEAD_P) * HEAD_P + K - 1
    buf = (_round16(rows * _odd_row(stage * x_bytes, width))
           + _round16(K * stage * _odd_row(cg * p_bytes, width)))
    return 3 * _round16(cg * p_bytes) + _round16(L * cg * 4) + (2 if stage < Cin else 1) * buf


@functools.lru_cache(maxsize=None)  # a pure function of ints, called on every launch
def head_geometry(B, L, Cin, C, K, groups, x_bytes=4, p_bytes=4, align=16,
                  stage=None) -> HeadGeometry:
    """The geometry of one head launch. ``x_bytes``/``p_bytes``: the element
    sizes of x and of the parameters; ``align``: the least alignment, in
    bytes, of the input pointers; ``stage`` forces the input channels of a
    stage.

    One CTA owns one (batch row, group). A tile of ``HEAD_P`` positions of one
    channel has its sum split over S lanes: up to 8, at most one per input
    channel. A group whose tiles do not fit 1024 threads (more than 256
    channels at L = 16) gets a thread count the C side refuses. The copy
    width is the widest of 16, 4 and 2 bytes that the rows and pointers
    allow. Cin is one stage when it fits the shared memory, else the widest
    stage of which two fit (a two-deep ring)."""
    cg = C // groups
    tiles = cg * _cdiv(L, HEAD_P)
    S = 1
    while S * 2 <= HEAD_MAX_LANES and S * 2 <= Cin and tiles * S * 2 <= MAX_THREADS:
        S *= 2
    width = next((w for w in (16, 4, 2)
                  if (Cin * x_bytes) % w == 0 and (cg * p_bytes) % w == 0 and align % w == 0), 2)
    smem = lambda ch: _head_smem(L, Cin, cg, K, width, ch, x_bytes, p_bytes)
    if stage is None:
        unit = max(1, width // x_bytes)  # channels of one copy unit
        stage = Cin
        while stage > unit and smem(stage) > MAX_SMEM:
            stage = (stage - 1) // unit * unit
    return HeadGeometry(S, _cdiv(tiles * S, 32) * 32, width, stage, smem(stage), B * groups)


def phase_stamps(ctas: int, device) -> torch.Tensor:
    """A buffer for one launch's phase stamps: (ctas, len(PHASES), 2) int64,
    the device's ns timer and the SM's cycle counter of each phase."""
    return torch.zeros((ctas, len(PHASES), 2), dtype=torch.int64, device=device)


# ---------------------------------------------------------------- launches


def _check_cuda(x: torch.Tensor, named: dict, shapes: dict) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"conv_gn_mish kernels take CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv_gn_mish kernels take float32 or bfloat16, got {x.dtype}")
    for name, a in named.items():
        if a is None:
            continue
        if a.device != x.device:
            raise RuntimeError(f"{name} is on {a.device}, x on {x.device}")
        if a.dtype != x.dtype:
            raise TypeError(f"{name} is {a.dtype}, x is {x.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(a.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {shapes[name]}")


def _check_stamps(stamps: Optional[torch.Tensor], ctas: int, device) -> None:
    if stamps is None:
        return
    want = (ctas, len(PHASES), 2)
    if (stamps.device != device or stamps.dtype != torch.int64 or not stamps.is_contiguous()
            or tuple(stamps.shape) != want):
        raise ValueError(f"stamps must be a contiguous int64 tensor of shape {want} on {device}")


def _ptr(a: Optional[torch.Tensor]):
    return None if a is None else a.data_ptr()


def _launch(geo: Geometry, x, w, b, gamma, beta, out, n_groups, eps, epi, ein=None, ew=None,
            eb=None, stamps=None) -> None:
    """One launch of the residual block's template at geometry ``geo``.
    ``ein``/``ew``/``eb``: the epilogue's input, weight and bias (t, tw, tb;
    or xres, wres, bres; or xres alone)."""
    from .build import library

    B, L, Cin = x.shape
    K, _, C = w.shape
    Ce = ein.shape[-1] if ein is not None else 0
    _check_stamps(stamps, geo.ctas, x.device)
    lib = library(SOURCE)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.adm_conv_gn_mish(
            _ptr(x), _ptr(w), _ptr(b), _ptr(gamma), _ptr(beta),
            B, L, Cin, C, K, n_groups, float(eps), epi,
            _ptr(ein), Ce, _ptr(ew), _ptr(eb),
            _ptr(out), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[out.dtype],
            geo.cs, geo.threads, geo.smem, _ptr(stamps), stream,
        )
    if err == ERR_SHAPE:
        raise ValueError(
            f"conv_gn_mish takes L <= {MAX_L}, C a multiple of n_groups with C / n_groups <= 1024, "
            f"rows that fit a CTA's shared memory, clusters of 1-{MAX_CLUSTER} (a power of two) "
            f"and a residual-block epilogue; got L={L}, Cin={Cin}, C={C}, n_groups={n_groups}, "
            f"K={K}, epi={epi}, {geo}"
        )
    if err != 0:
        # a refused cluster launch (cudaErrorClusterOutOfResources, ...) lands
        # here: there is no retry at another geometry
        raise RuntimeError(f"conv_gn_mish launch failed (CUDA error {err}, {geo})")


def _alignment(*tensors: torch.Tensor) -> int:
    """The least alignment of the tensors' pointers, in bytes, up to 16: the
    lowest set bit of their OR."""
    bits = 16
    for t in tensors:
        bits |= t.data_ptr()
    return bits & -bits


def _launch_head(geo: HeadGeometry, x, w, b, gamma, beta, out, n_groups, eps, stamps=None) -> None:
    """One launch of the head's kernel at geometry ``geo``."""
    from .build import library

    B, L, Cin = x.shape
    K, _, C = w.shape
    _check_stamps(stamps, geo.ctas, x.device)
    lib = library(HEAD_SOURCE)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.adm_conv1d_gn_mish(
            _ptr(x), _ptr(w), _ptr(b), _ptr(gamma), _ptr(beta),
            B, L, Cin, C, K, n_groups, float(eps),
            _ptr(out), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[out.dtype],
            geo.S, geo.width, geo.stage, geo.threads, geo.smem, _ptr(stamps), stream,
        )
    if err == ERR_SHAPE:
        raise ValueError(
            f"conv1d_gn_mish takes L <= {MAX_L}, C a multiple of n_groups, a group's "
            f"C / n_groups x ceil(L / {HEAD_P}) tiles of S lanes in one CTA of at most "
            f"{MAX_THREADS} threads, S lanes in one warp, 16/4/2-byte copies that the rows and "
            f"pointers allow and "
            f"stages that fit a CTA's shared memory; got L={L}, Cin={Cin}, C={C}, "
            f"n_groups={n_groups}, K={K}, {geo}"
        )
    if err != 0:
        raise RuntimeError(f"conv1d_gn_mish launch failed (CUDA error {err}, {geo})")


class Recompute(torch.autograd.Function):
    """A kernel call that autograd can differentiate:
    ``Recompute.apply(launch, plain, kw, *tensors)``.

    The forward returns ``launch(*tensors, **kw)``, the kernel's output, and
    saves the inputs (``tensors`` may hold None: an absent residual
    projection). The backward recomputes ``plain(*tensors, **kw)`` from them
    under autograd and returns its gradient for every input that needs one.
    The plain version is float32 inside, so the gradient is too, returned in
    each input's dtype."""

    @staticmethod
    def forward(ctx, launch, plain, kw, *tensors):
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*tensors)
        return launch(*tensors, **kw)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [None if a is None else a.detach().requires_grad_(n)
                      for a, n in zip(ctx.saved_tensors, needs)]
            wrt = [a for a in inputs if a is not None and a.requires_grad]
            grads = iter(torch.autograd.grad(ctx.plain(*inputs, **ctx.kw), wrt, grad_out) if wrt else ())
        return (None, None, None) + tuple(
            next(grads) if a is not None and a.requires_grad else None for a in inputs)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def fused_conv1d_gn_mish(x, w, b, gamma, beta, n_groups: int = 8, eps: float = 1e-5, *,
                         stamps=None):
    """x: (B, L, Cin); w: (K, Cin, C); b/gamma/beta: (C,) -> (B, L, C).
    ``stamps``: None, or a :func:`phase_stamps` buffer of the launch's CTAs."""
    if x.device.type == "cpu":
        if stamps is not None:
            raise ValueError("phase stamps come from the CUDA kernel: give CUDA tensors")
        return conv1d_gn_mish_plain(x, w, b, gamma, beta, n_groups, eps)
    launch = functools.partial(_conv1d_gn_mish_cuda, stamps=stamps)
    kw = dict(n_groups=n_groups, eps=eps)
    if _needs_grad(x, w, b, gamma, beta):
        return Recompute.apply(launch, conv1d_gn_mish_plain, kw, x, w, b, gamma, beta)
    return launch(x, w, b, gamma, beta, **kw)


def _conv1d_gn_mish_cuda(x, w, b, gamma, beta, n_groups, eps, stamps=None):
    B, L, Cin = x.shape
    K, _, C = w.shape
    _check_cuda(
        x,
        dict(x=x, w=w, b=b, gamma=gamma, beta=beta),
        dict(x=(B, L, Cin), w=(K, Cin, C), b=(C,), gamma=(C,), beta=(C,)),
    )
    out = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
    geo = head_geometry(B, L, Cin, C, K, n_groups, x.element_size(), w.element_size(),
                        _alignment(x, w, b, gamma, beta))
    _launch_head(geo, x, w, b, gamma, beta, out, n_groups, eps, stamps)
    fused_conv1d_gn_mish.launches += 1
    return out


def fused_residual_block(
    x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, wres=None, bres=None,
    n_groups: int = 8, eps: float = 1e-5, *, stamps=None,
):
    """Whole ResidualTemporalMapBlock. x: (B, L, Cin); t: (B, E); w1 (K, Cin,
    C); w2 (K, C, C); tw (E, C); wres (1, Cin, C) or None (then Cin == C).
    ``stamps``: None, or a pair of :func:`phase_stamps` buffers, one for
    each launch."""
    args = (x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, wres, bres)
    if x.device.type == "cpu":
        if stamps is not None:
            raise ValueError("phase stamps come from the CUDA kernel: give CUDA tensors")
        return residual_block_plain(*args, n_groups=n_groups, eps=eps)
    launch = functools.partial(_residual_block_cuda, stamps=stamps)
    kw = dict(n_groups=n_groups, eps=eps)
    if _needs_grad(*args):
        return Recompute.apply(launch, residual_block_plain, kw, *args)
    return launch(*args, **kw)


def _residual_block_cuda(x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, wres, bres,
                         n_groups, eps, stamps=None):
    B, L, Cin = x.shape
    K, _, C = w1.shape
    E = t.shape[1]
    if (wres is None) != (bres is None) or (wres is None and Cin != C):
        raise ValueError("wres/bres are needed exactly when Cin != C")
    _check_cuda(
        x,
        dict(x=x, t=t, w1=w1, b1=b1, g1=g1, be1=be1, tw=tw, tb=tb, w2=w2, b2=b2, g2=g2,
             be2=be2, wres=wres, bres=bres),
        dict(x=(B, L, Cin), t=(B, E), w1=(K, Cin, C), b1=(C,), g1=(C,), be1=(C,), tw=(E, C),
             tb=(C,), w2=(K, C, C), b2=(C,), g2=(C,), be2=(C,), wres=(1, Cin, C), bres=(C,)),
    )
    s1, s2 = (None, None) if stamps is None else stamps
    h = torch.empty((B, L, C), dtype=torch.float32, device=x.device)  # stays fp32
    out = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
    geo1, geo2 = residual_block_geometry(B, L, Cin, C, E, wres is not None, K, n_groups)
    _launch(geo1, x, w1, b1, g1, be1, h, n_groups, eps, EPI_TBIAS, t, tw, tb, stamps=s1)
    if wres is not None:
        _launch(geo2, h, w2, b2, g2, be2, out, n_groups, eps, EPI_RES_CONV, x, wres[0], bres,
                stamps=s2)
    else:
        _launch(geo2, h, w2, b2, g2, be2, out, n_groups, eps, EPI_RES_ID, x, stamps=s2)
    fused_residual_block.launches += 1
    return out


fused_conv1d_gn_mish.launches = 0
fused_residual_block.launches = 0


def reset_launch_counts() -> None:
    fused_conv1d_gn_mish.launches = 0
    fused_residual_block.launches = 0


def launch_counts() -> Dict[str, int]:
    """Each wrapper's launch count, by the wrapper's name."""
    return {f.__name__: f.launches for f in (fused_conv1d_gn_mish, fused_residual_block)}


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by wrapper name) to the launch counts: the launches
    of a replayed CUDA graph, which calls no wrapper."""
    for f in (fused_conv1d_gn_mish, fused_residual_block):
        f.launches += counts.get(f.__name__, 0)
