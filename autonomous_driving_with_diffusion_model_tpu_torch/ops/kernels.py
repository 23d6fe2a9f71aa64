"""The port's CUDA kernels for the temporal U-Net: wrappers, launch counts and
plain PyTorch versions (counterpart of the JAX package's
``ops/pallas_kernels.py``).

Both kernels come from one CUDA template, ``ops/csrc/conv_gn_mish.cu``:

* ``fused_conv1d_gn_mish`` replaces ``pallas_kernels.py:fused_conv1d_gn_mish``
  (one ``Conv1dBlock``: ``mish(GN8(conv1d_k5(x) + b))``), one launch;
* ``fused_residual_block`` replaces ``pallas_kernels.py:fused_residual_block``
  (a whole ``ResidualTemporalMapBlock``), two launches: conv 2 needs every
  channel of h, a dependency across the whole grid.

What bounds them on an H100 is the weight bytes (at batch 1-2 each weight
does 2 FLOPs per batch row); the source's header says what the design does
about that. Each launch's geometry (cluster size, threads, shared memory)
comes from :func:`launch_geometry`, which the C side checks. Signatures and
layouts are those of the JAX kernels: x (B, L, Cin), conv weights (K, Cin,
C), the time projection (E, C), the residual projection (1, Cin, C). The modules pack their torch-layout parameters into
these layouts once (``models/blocks.py``), not on every call.

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel or raises. It adds one to its ``launches`` count for each
call that launches. Both are forward-only: they raise under autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .nn import conv1d, group_norm, mish

__all__ = [
    "fused_conv1d_gn_mish",
    "fused_residual_block",
    "launch_geometry",
    "residual_block_geometry",
    "rank_slice",
    "conv1d_gn_mish_plain",
    "residual_block_plain",
    "check_forward_only",
    "reset_launch_counts",
]

SOURCE = "conv_gn_mish.cu"
EPI_NONE, EPI_TBIAS, EPI_RES_CONV, EPI_RES_ID = 0, 1, 2, 3
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ERR_SHAPE = -2  # the C function's code for a shape or geometry it does not take
MAX_L = 16  # positions a kernel thread holds in registers
MAX_THREADS = 1024
MAX_SPLIT = 32  # threads sharing one channel's reduction inside a CTA
MAX_CLUSTER = 8  # the portable cluster size
MIN_RANK_CHANNELS = 8  # input channels a cluster's rank keeps at least


def check_forward_only(*tensors: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "the conv_gn_mish kernels are forward-only: call them under torch.no_grad() "
            "or with inputs that do not require grad"
        )


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
    """The geometry of one conv_gn_mish launch: ``Ce`` is the epilogue's
    reduced length (E for ``EPI_TBIAS``, the residual's Cin for
    ``EPI_RES_CONV``, ignored otherwise); ``cs`` forces a cluster size.

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


def _launch(geo: Geometry, x, w, b, gamma, beta, out, n_groups, eps, epi, ein=None, ew=None,
            eb=None) -> None:
    """One kernel launch at geometry ``geo``. ``ein``/``ew``/``eb``: the
    epilogue's input, weight and bias (t, tw, tb; or xres, wres, bres; or
    xres alone)."""
    from .build import library

    B, L, Cin = x.shape
    K, _, C = w.shape
    Ce = ein.shape[-1] if ein is not None else 0
    ptr = lambda a: None if a is None else a.data_ptr()
    lib = library(SOURCE)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.adm_conv_gn_mish(
            ptr(x), ptr(w), ptr(b), ptr(gamma), ptr(beta),
            B, L, Cin, C, K, n_groups, float(eps), epi,
            ptr(ein), Ce, ptr(ew), ptr(eb),
            ptr(out), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[out.dtype],
            geo.cs, geo.threads, geo.smem, stream,
        )
    if err == ERR_SHAPE:
        raise ValueError(
            f"conv_gn_mish takes L <= {MAX_L}, C a multiple of n_groups with C / n_groups <= 1024, "
            f"rows that fit a CTA's shared memory and clusters of 1-{MAX_CLUSTER} (a power of two); "
            f"got L={L}, Cin={Cin}, C={C}, n_groups={n_groups}, K={K}, {geo}"
        )
    if err != 0:
        # a refused cluster launch (cudaErrorClusterOutOfResources, ...) lands
        # here: there is no retry at another geometry
        raise RuntimeError(f"conv_gn_mish launch failed (CUDA error {err}, {geo})")


def fused_conv1d_gn_mish(x, w, b, gamma, beta, n_groups: int = 8, eps: float = 1e-5):
    """x: (B, L, Cin); w: (K, Cin, C); b/gamma/beta: (C,) -> (B, L, C)."""
    check_forward_only(x, w, b, gamma, beta)
    if x.device.type == "cpu":
        return conv1d_gn_mish_plain(x, w, b, gamma, beta, n_groups, eps)
    B, L, Cin = x.shape
    K, _, C = w.shape
    _check_cuda(
        x,
        dict(x=x, w=w, b=b, gamma=gamma, beta=beta),
        dict(x=(B, L, Cin), w=(K, Cin, C), b=(C,), gamma=(C,), beta=(C,)),
    )
    out = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
    geo = launch_geometry(B, L, Cin, C, K, n_groups, 0, EPI_NONE)
    _launch(geo, x, w, b, gamma, beta, out, n_groups, eps, EPI_NONE)
    fused_conv1d_gn_mish.launches += 1
    return out


def fused_residual_block(
    x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, wres=None, bres=None,
    n_groups: int = 8, eps: float = 1e-5,
):
    """Whole ResidualTemporalMapBlock. x: (B, L, Cin); t: (B, E); w1 (K, Cin,
    C); w2 (K, C, C); tw (E, C); wres (1, Cin, C) or None (then Cin == C)."""
    check_forward_only(x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, wres, bres)
    if x.device.type == "cpu":
        return residual_block_plain(
            x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, wres, bres, n_groups, eps
        )
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
    h = torch.empty((B, L, C), dtype=torch.float32, device=x.device)  # stays fp32
    out = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
    geo1, geo2 = residual_block_geometry(B, L, Cin, C, E, wres is not None, K, n_groups)
    _launch(geo1, x, w1, b1, g1, be1, h, n_groups, eps, EPI_TBIAS, t, tw, tb)
    if wres is not None:
        _launch(geo2, h, w2, b2, g2, be2, out, n_groups, eps, EPI_RES_CONV, x, wres[0], bres)
    else:
        _launch(geo2, h, w2, b2, g2, be2, out, n_groups, eps, EPI_RES_ID, x)
    fused_residual_block.launches += 1
    return out


fused_conv1d_gn_mish.launches = 0
fused_residual_block.launches = 0


def reset_launch_counts() -> None:
    fused_conv1d_gn_mish.launches = 0
    fused_residual_block.launches = 0
