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
  needs every channel of h, a dependency across the whole grid. Given a
  conditioning projection of 2C outputs it is Diffusion Policy's
  ``ConditionalResidualBlock1D`` instead: FiLM, the first C outputs scaling
  conv 1's activation and the last C shifting it (``EPI_FILM``). Each launch's
  geometry comes from :func:`launch_geometry`. At batch 1-2 a launch takes
  the one-wave path where :func:`launch_path` allows it (the CTA's weight
  slice fetched into shared memory at entry, with programmatic dependent
  launch where the weights are a cached pack), and else the streamed path
  where :func:`streamed_geometry` gives one (each group's weight rows cut
  over one CTA an SM and streamed through a ring in shared memory, a second
  kernel finishing the group: weights too wide for a one-wave slice). From
  batch 3 a launch takes the folded path where :func:`folded_geometry`
  gives one and the card holds its clusters (one cluster a group for every
  batch row, so each weight is read from device memory once a call).

The C side checks each geometry. What bounds the residual block on an H100
is the weight bytes (at batch 1-2 each weight does 2 FLOPs per batch row);
the head moves too little for bytes or FLOPs to matter, and is bound by
latency: its launch, its round trip to memory and the chain of instructions
on its critical path. Each source's header says what its design does about
that. Signatures and layouts are those of the JAX kernels:
x (B, L, Cin), conv weights (K, Cin, C), the time projection (E, C), the
residual projection (1, Cin, C). The modules pack their torch-layout
parameters into these layouts once (``models/blocks.py``), not on every call.

A wrapper given CPU tensors computes the plain version, which autograd
differentiates as it stands; given CUDA tensors it launches the kernel or
raises. It adds one to its ``launches`` count for each call that launches;
``fused_residual_block`` also counts its launches (two a call) on the
one-wave path (``one_wave``), on the streamed path (``streamed``; each a
streaming kernel and its finishing kernel), on the folded path (``folded``)
and those of any path launched with programmatic dependent launch (``pdl``),
and its launches with the FiLM epilogue (``film``, one a FiLM call)
(:func:`launch_counts`). The counts also hold ``ops/nn.py:attention``'s
calls and cross-attention key tokens, and the condition tokens projected to
cross-attention keys and values (``ops/nn.py:count_cross_kv``; :data:`ATTENTION`).
A CUDA graph's capture records its launches in :func:`recorded_launches`,
which leaves the counts as they were, and each replay adds them
(:func:`add_launch_counts`).

Neither TPU kernel has a backward (the JAX package trains through the XLA
composite, ``TPU.USE_PALLAS_CONV`` off). So when a CUDA call needs a gradient,
it goes through :class:`Recompute`, a ``torch.autograd.Function`` whose
forward launches the kernel and whose backward recomputes the plain version
from the saved inputs and returns its gradients: the same function JAX's
training differentiates. Hand-written backward kernels are open work.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, NamedTuple, Optional

import torch

from .nn import attention, conv1d, group_norm, mish

__all__ = [
    "fused_conv1d_gn_mish",
    "fused_residual_block",
    "launch_geometry",
    "residual_block_geometry",
    "one_wave_geometry",
    "launch_path",
    "streamed_geometry",
    "folded_geometry",
    "head_geometry",
    "rank_slice",
    "conv1d_gn_mish_plain",
    "residual_block_plain",
    "Recompute",
    "reset_launch_counts",
    "launch_counts",
    "add_launch_counts",
    "recorded_launches",
    "WRAPPERS",
    "PATHS",
    "FILM",
]

SOURCE = "conv_gn_mish.cu"  # the residual block's template
HEAD_SOURCE = "conv1d_gn_mish.cu"
EPI_TBIAS, EPI_RES_CONV, EPI_RES_ID, EPI_FILM = 1, 2, 3, 4
_REDUCES = (EPI_TBIAS, EPI_RES_CONV, EPI_FILM)  # epilogues with a projection
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ERR_SHAPE = -2  # the C function's code for a shape or geometry it does not take
MAX_L = 16  # positions a kernel thread holds in registers
MAX_THREADS = 1024
MAX_SMEM = 232448  # bytes of shared memory a CTA may use
MAX_SPLIT = 32  # threads sharing one channel's reduction inside a CTA
MAX_CLUSTER = 8  # the portable cluster size
MIN_RANK_CHANNELS = 8  # input channels a cluster's rank keeps at least
# threads of a one-wave CTA at most: two such CTAs share an SM (64 registers
# a thread, at most 111 KB of shared memory each on the main path), so a
# launch's successor fits beside it (an H100 holds 15 clusters of eight
# 1024-thread CTAs, 30 of 512)
ONE_WAVE_THREADS = 512
# the streamed path (the C side's STREAM_*): ring slots of weight tiles, the
# weight bytes of a tile, threads of a streaming CTA at most, the batch rows
# it takes and the B x L pairs a thread sums at most
STREAM_STAGES = 10
STREAM_TILE_BYTES = 16384
STREAM_THREADS = 512
STREAM_MAX_B = 2
STREAM_MAX_ROWS = 16
FINISH_CLUSTER = 8  # CTAs finishing one (batch row, group) on the streamed path
# the folded path (the C side's FOLD_*): the least batch it takes, its cluster
# sizes by preference (16, H100's non-portable size, gives a launch of 8
# groups 128 CTAs), threads of a CTA at most, the (batch row, position)
# pairs of a thread's register tile, the taps its input window covers and the
# lanes that share one tile's channels at most
FOLD_MIN_B = 3
FOLD_CLUSTERS = (16, 8)
FOLD_THREADS = 512
FOLD_PAIRS = 4
FOLD_MAX_K = 5
FOLD_MAX_SPLIT = 4
HEAD_P = 4  # positions of one output channel a head thread holds (the C side's P)
HEAD_MAX_LANES = 8  # lanes sharing one head output's sum


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
    (h stays float32 between the two), returned in ``x.dtype``. With tw
    (E, 2C), FiLM: ``[s | b] = mish(t) tw + tb`` and conv 2 takes
    ``s * CGM1(x) + b``."""
    f = lambda a: a.to(torch.float32)
    h = _cgm32(x, w1, b1, g1, be1, n_groups, eps)
    e = (mish(f(t)) @ f(tw) + f(tb))[:, None, :]
    C = h.shape[-1]
    h = e[..., :C] * h + e[..., C:] if e.shape[-1] == 2 * C else h + e
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
    the epilogue's reduced length (E for ``EPI_TBIAS`` and ``EPI_FILM``, the
    residual's Cin for ``EPI_RES_CONV``, ignored for ``EPI_RES_ID``); ``cs``
    forces a cluster size.

    A cluster of ``cs`` CTAs owns one (batch row, group); ``cs`` is the
    largest power of two up to 8 that leaves each rank ``MIN_RANK_CHANNELS``
    input channels. The shared memory is the C side's ``layout`` total."""
    return _geometry(B, L, Cin, C, K, groups, Ce, epi, cs, MAX_THREADS)


def _geometry(B, L, Cin, C, K, groups, Ce, epi, cs, max_threads) -> Geometry:
    """:func:`launch_geometry` with S the largest that keeps S x cg within
    ``max_threads``."""
    cg = C // groups
    S = 1
    while S * 2 <= MAX_SPLIT and S * 2 * cg <= max_threads:
        S *= 2
    threads = _cdiv(S * cg, 32) * 32
    has_e = epi in _REDUCES
    Ce = Ce if has_e else 0
    if cs is None:
        cs = 1
        while cs * 2 <= MAX_CLUSTER and Cin // (cs * 2) >= MIN_RANK_CHANNELS:
            cs *= 2
    erows = L if epi == EPI_RES_CONV else 1  # input rows of the epilogue
    heads = 2 if epi == EPI_FILM else 1  # FiLM's scale and shift
    n, ne = L * cg, (heads * erows * cg if has_e else 0)
    chunk = _cdiv(n, cs)  # outputs a rank finishes
    floats = (32 + (3 + heads) * cg + n + ne + n + (chunk if epi == EPI_RES_ID else 0)
              + (L + K - 1) * _cdiv(Cin, cs) + erows * _cdiv(Ce, cs) + S * (n + ne))
    return Geometry(cs, S, threads, 4 * floats, B * groups * cs)


def residual_block_geometry(B, L, Cin, C, E, has_res, K=5, groups=8, film=False) -> tuple:
    """The geometries of ``fused_residual_block``'s two launches: conv 1 with
    the time projection (FiLM's where ``film``), conv 2 with the residual (a
    projection when ``has_res``, else the identity)."""
    return (
        launch_geometry(B, L, Cin, C, K, groups, E, EPI_FILM if film else EPI_TBIAS),
        launch_geometry(B, L, C, C, K, groups, Cin, EPI_RES_CONV if has_res else EPI_RES_ID),
    )


def one_wave_geometry(geo: Geometry, L, Cin, C, K, groups, Ce, epi, p_bytes) -> Geometry:
    """The one-wave path's geometry for a launch whose geometry is ``geo``:
    its cluster size, at most :data:`ONE_WAVE_THREADS` threads a CTA (S
    shrunk to fit), then the shared memory rounded up to 16 bytes and the
    CTA's weight slice, ``K x ceil(Cin / cs)`` conv rows and ``ceil(Ce /
    cs)`` epilogue rows (twice as many under FiLM) of ``cg`` values of
    ``p_bytes`` each (the C side's ``slice_bytes``)."""
    B = geo.ctas // (groups * geo.cs)
    base = _geometry(B, L, Cin, C, K, groups, Ce, epi, geo.cs, ONE_WAVE_THREADS)
    heads = 2 if epi == EPI_FILM else 1
    rows = K * _cdiv(Cin, geo.cs) + (heads * _cdiv(Ce, geo.cs) if epi in _REDUCES else 0)
    return base._replace(smem=_cdiv(base.smem, 16) * 16 + rows * (C // groups) * p_bytes)


def launch_path(geo: Geometry, clusters: int, cached: bool, rows16: bool = True) -> tuple:
    """``(one_wave, pdl)`` of a launch whose one-wave geometry is ``geo``.

    The one-wave path needs all ``B x groups`` clusters co-resident (the
    card holds ``clusters`` of them at once, ``cudaOccupancyMaxActiveClusters``
    of the one-wave instance), the slice in shared memory and weight rows
    that copy in whole 16-byte pieces (``rows16``). It is launched with
    programmatic dependent launch only when the weights are a cached pack
    (``cached``): a pack made in this call was written by the kernel right
    before, whose writes a launch that overlaps it could read stale."""
    one_wave = rows16 and geo.smem <= MAX_SMEM and geo.ctas // geo.cs <= clusters
    return one_wave, one_wave and cached


class StreamGeometry(NamedTuple):
    parts: int  # CTAs a group's weight rows are cut over
    S: int  # adjacent lanes sharing one column quad's rows
    threads: int  # threads of a streaming CTA
    tile_rows: int  # weight rows of a ring slot
    smem: int  # shared-memory bytes of a streaming CTA
    ctas: int  # streaming CTAs: groups x parts
    fin_threads: int  # threads of a finishing CTA, FINISH_CLUSTER of them per (batch row, group)
    fin_smem: int  # its shared-memory bytes
    scratch: int  # float32 partial sums: (segments, groups, parts, B x L, cg)


def streamed_geometry(B, L, Cin, C, K, groups, Ce, epi, p_bytes, sms) -> Optional[StreamGeometry]:
    """The streamed path's geometry for a launch on a card of ``sms`` SMs,
    or None where the path does not take it: more than
    :data:`STREAM_MAX_B` batch rows or :data:`STREAM_MAX_ROWS` (batch row,
    position) pairs, weight rows of ``cg = C / groups`` values that do not
    copy in whole 16-byte pieces, a CTA past :data:`STREAM_THREADS` threads
    or past the shared memory.

    The rows are the conv's ``K x Cin``, then ``Ce`` for each epilogue head
    (two under FiLM, none for the identity residual), cut into ``sms //
    groups`` contiguous slices a group, one CTA each (at most one a row). A
    streaming thread owns four columns and every S-th row of a tile, S the
    largest power of two up to 32 that keeps ``S x cg / 4`` within
    :data:`STREAM_THREADS`. Its shared memory is the C side's
    ``stream_smem``: :data:`STREAM_STAGES` slots of ``tile_rows`` rows (the
    rows of :data:`STREAM_TILE_BYTES`, a multiple of S), each row skewed by
    16 bytes (``16 x 8 / S`` below S = 8), then each of its rows' inputs for
    4, 8 or 16 pairs in float32. :data:`FINISH_CLUSTER` finishing CTAs a
    (batch row, group) take a slice of its ``L x cg`` outputs each, a thread
    an output."""
    cg = C // groups
    if B > STREAM_MAX_B or B * L > STREAM_MAX_ROWS or C % groups or (cg * p_bytes) % 16:
        return None
    cq = cg // 4
    S = 1
    while S * 2 <= 32 and S * 2 * cq <= STREAM_THREADS:
        S *= 2
    threads = _cdiv(S * cq, 32) * 32
    heads = (2 if epi == EPI_FILM else 1) if epi in _REDUCES else 0
    rows = K * Cin + heads * Ce
    parts = min(max(1, sms // groups), rows)
    row_bytes = cg * p_bytes
    tile_rows = max(S, STREAM_TILE_BYTES // row_bytes // S * S)
    pitch = row_bytes + 16 * (8 // S if S < 8 else 1)
    nr = next(n for n in (4, 8, 16) if n >= B * L)
    smem = STREAM_STAGES * tile_rows * pitch + _cdiv(rows, parts) * nr * 4
    n = L * cg
    chunk = _cdiv(n, FINISH_CLUSTER)  # outputs a finishing CTA takes
    fin_smem = 4 * (36 + 5 * cg + 3 * chunk)
    if threads > STREAM_THREADS or smem > MAX_SMEM or fin_smem > MAX_SMEM:
        return None
    return StreamGeometry(parts, S, threads, tile_rows, smem, groups * parts,
                          min(MAX_THREADS, _cdiv(chunk, 32) * 32), fin_smem, (1 + heads) * groups * parts * B * n)


class FoldGeometry(NamedTuple):
    cs: int  # CTAs in a cluster, which owns one group for every batch row
    S: int  # lanes sharing one register tile's input channels
    threads: int  # threads of a CTA
    smem: int  # shared-memory bytes of a CTA
    ctas: int  # CTAs of the launch: groups x cs


def _fold_tl(pos: int) -> int:
    """Positions of a register tile over ``pos`` positions (the C side's
    ``fold_tl``)."""
    return 1 if pos <= 1 else 2 if pos <= 2 else 4


def _round4(n: int) -> int:
    return _cdiv(n, 4) * 4


def _fold_pitch(pos: int, taps: int, kmax: int) -> int:
    """Floats between two staged input rows of the folded path (the C side's
    ``fold_pitch``): every position of the zero-padded row, and every piece
    of ``_fold_tl(pos)`` floats a window of ``kmax`` taps loads from the last
    tile."""
    tl = _fold_tl(pos)
    ntl = _cdiv(pos, tl)
    return _cdiv(max(pos + taps - 1, (ntl - 1) * tl + _cdiv(tl + kmax - 1, tl) * tl), tl) * tl


def folded_geometry(B, L, Cin, C, K, groups, Ce, epi, p_bytes, cs) -> Optional[FoldGeometry]:
    """The folded path's geometry for a launch in clusters of ``cs``, or None
    where the path does not take it: weight rows of ``cg = C / groups`` values
    that do not copy in whole 16-byte pieces, more than :data:`FOLD_MAX_K`
    taps, fewer input channels than ranks (``Cin < cs``, as Cin = 7), or a CTA
    past the shared memory.

    Cluster g owns group g for all B batch rows; its rank r the slice
    ``rank_slice(Cin, cs, r)`` of the input channels (``K x ceil(Cin / cs)``
    weight rows at most), of the epilogue's ``Ce`` rows (each head's) and of
    each batch row's ``L x cg`` outputs. A thread's register tile is
    ``FOLD_PAIRS`` (batch row, position) pairs, ``TL`` positions (1, 2 or 4) by
    ``FOLD_PAIRS / TL`` rows, by four columns; S (a power of two up to
    :data:`FOLD_MAX_SPLIT`, at most the rank's channels) lanes share a tile's
    channels, within :data:`FOLD_THREADS` threads. The shared memory is the
    C side's ``fold_layout`` total, buffers each rounded up to 16 bytes, then
    the weight slice (``slice_bytes``)."""
    cg = C // groups
    if C % groups or (cg * p_bytes) % 16 or K > FOLD_MAX_K or L > MAX_L or Cin < cs:
        return None
    has_e = epi in _REDUCES
    erows = L if epi == EPI_RES_CONV else 1
    nh = (2 if epi == EPI_FILM else 1) if has_e else 0
    n, nc, nce = L * cg, _cdiv(Cin, cs), _cdiv(Ce, cs) if has_e else 0
    chunk = _cdiv(n, cs)
    tl, etl = _fold_tl(L), _fold_tl(erows)
    tb, etb = FOLD_PAIRS // tl, FOLD_PAIRS // etl
    items = _cdiv(B, tb) * _cdiv(L, tl) * (cg // 4)
    S = 1
    while S * 2 <= FOLD_MAX_SPLIT and S * 2 <= nc and items * S * 2 <= FOLD_THREADS:
        S *= 2
    threads = min(FOLD_THREADS, _cdiv(items, 32 // S) * 32)
    xp, ep = _fold_pitch(L, K, FOLD_MAX_K), _fold_pitch(erows, 1, 1)
    held = (B * 2, 2 * cs, 5 * cg, cs * B * chunk, nh * cs * B * chunk, B * chunk if epi == EPI_RES_ID else 0)
    # the same bytes hold the staged inputs (and the time projection's sums)
    # until the ranks' sums are exchanged, the statistics and the chunk after
    staged = (_cdiv(B, tb) * tb * nc * xp, _cdiv(B, etb) * etb * nce * ep, nh * B * cg if erows == 1 else 0)
    floats = sum(map(_round4, held)) + max(sum(map(_round4, staged)), sum(map(_round4, (cs * B * 2, B * chunk))))
    smem = 4 * floats + (K * nc + nh * nce) * cg * p_bytes
    if smem > MAX_SMEM:
        return None
    return FoldGeometry(cs, S, threads, smem, groups * cs)


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


def _ptr(a: Optional[torch.Tensor]):
    return None if a is None else a.data_ptr()


@functools.lru_cache(maxsize=None)  # one query per geometry and kernel instance
def _max_active_clusters(device: int, B, L, Cin, C, K, groups, epi, Ce, x_code, p_code, out_code,
                         geo) -> int:
    """How many clusters of the launch at ``geo`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``): the one-wave launch's for a
    :class:`Geometry`, the folded launch's for a :class:`FoldGeometry`."""
    import ctypes

    from .build import library

    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = library(SOURCE).adm_conv_gn_mish_clusters(
            B, L, Cin, C, K, groups, epi, Ce, x_code, p_code, out_code,
            geo.cs, geo.threads, geo.smem, 2 if isinstance(geo, FoldGeometry) else 1, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"conv_gn_mish occupancy query failed (error {err}, {geo})")
    return n.value


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    """The card's SMs."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _pick_path(geo: Geometry, x, w, out, epi, ein, ew, n_groups, cached: bool) -> tuple:
    """``(geometry, path, pdl)`` of one launch of the template from what it
    can observe, ``path`` one of ``"folded"``, ``"one_wave"``, ``"streamed"``
    and ``"multi_wave"``: from batch :data:`FOLD_MIN_B`, the folded path at
    the first cluster size of :data:`FOLD_CLUSTERS` whose
    :func:`folded_geometry` exists and whose clusters the card holds for
    every group at once (asked once per geometry), with 16-byte aligned
    weight rows; else :func:`launch_path` at the one-wave geometry; where it
    refuses, the streamed path at batch 1-2 where :func:`streamed_geometry`
    gives one; each with programmatic dependent launch on a cached pack;
    else ``geo`` itself."""
    B, L, Cin = x.shape
    K, _, C = w.shape
    Ce = ein.shape[-1] if ein is not None else 0
    codes = (_DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[out.dtype])
    rows16 = ((C // n_groups) * w.element_size()) % 16 == 0 and _alignment(
        *(a for a in (w, ew) if a is not None)) == 16
    if rows16 and B >= FOLD_MIN_B:
        for cs in FOLD_CLUSTERS:
            fgeo = folded_geometry(B, L, Cin, C, K, n_groups, Ce, epi, w.element_size(), cs)
            if fgeo is not None and _max_active_clusters(x.device.index, B, L, Cin, C, K, n_groups, epi, Ce,
                                                         *codes, fgeo) >= n_groups:
                return fgeo, "folded", cached
    wide = one_wave_geometry(geo, L, Cin, C, K, n_groups, Ce, epi, w.element_size())
    clusters = 0
    if rows16 and wide.smem <= MAX_SMEM:
        clusters = _max_active_clusters(x.device.index, B, L, Cin, C, K, n_groups, epi, Ce, *codes, wide)
    one_wave, pdl = launch_path(wide, clusters, cached, rows16)
    if one_wave:
        return wide, "one_wave", pdl
    if rows16:
        sgeo = streamed_geometry(B, L, Cin, C, K, n_groups, Ce, epi, w.element_size(), _sm_count(x.device.index))
        if sgeo is not None:
            return sgeo, "streamed", cached
    return geo, "multi_wave", False


def _launch(geo: Geometry, x, w, b, gamma, beta, out, n_groups, eps, epi, ein=None, ew=None,
            eb=None, one_wave=False, pdl=False) -> None:
    """One launch of the residual block's template at geometry ``geo``.
    ``ein``/``ew``/``eb``: the epilogue's input, weight and bias (t, tw, tb,
    of 2C columns under FiLM; or xres, wres, bres; or xres alone);
    ``one_wave``: the one-wave path, at
    its geometry (:func:`one_wave_geometry`); ``pdl``: launched with
    programmatic dependent launch."""
    from .build import library

    B, L, Cin = x.shape
    K, _, C = w.shape
    Ce = ein.shape[-1] if ein is not None else 0
    lib = library(SOURCE)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.adm_conv_gn_mish(
            _ptr(x), _ptr(w), _ptr(b), _ptr(gamma), _ptr(beta),
            B, L, Cin, C, K, n_groups, float(eps), epi,
            _ptr(ein), Ce, _ptr(ew), _ptr(eb),
            _ptr(out), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[out.dtype],
            geo.cs, geo.threads, geo.smem, int(one_wave), int(pdl), stream,
        )
    if err == ERR_SHAPE:
        raise ValueError(
            f"conv_gn_mish takes L <= {MAX_L}, C a multiple of n_groups with C / n_groups <= 1024, "
            f"rows that fit a CTA's shared memory, clusters of 1-{MAX_CLUSTER} (a power of two), "
            f"a residual-block epilogue and, on the one-wave path, 16-byte weight rows; got L={L}, "
            f"Cin={Cin}, C={C}, n_groups={n_groups}, K={K}, epi={epi}, {geo}, one_wave={one_wave}, "
            f"pdl={pdl}"
        )
    if err != 0:
        # a refused cluster launch (cudaErrorClusterOutOfResources, ...) lands
        # here: there is no retry at another geometry
        raise RuntimeError(f"conv_gn_mish launch failed (CUDA error {err}, {geo})")


def _launch_streamed(geo: StreamGeometry, x, w, b, gamma, beta, out, n_groups, eps, epi, ein=None,
                     ew=None, eb=None, pdl=False) -> None:
    """One launch of the residual block's template on the streamed path at
    geometry ``geo`` (:func:`streamed_geometry`): its streaming kernel, then
    its finishing kernel, with a scratch for the partial sums between them."""
    from .build import library

    B, L, Cin = x.shape
    K, _, C = w.shape
    Ce = ein.shape[-1] if ein is not None else 0
    scratch = torch.empty(geo.scratch, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = library(SOURCE).adm_conv_gn_mish_streamed(
            _ptr(x), _ptr(w), _ptr(b), _ptr(gamma), _ptr(beta),
            B, L, Cin, C, K, n_groups, float(eps), epi,
            _ptr(ein), Ce, _ptr(ew), _ptr(eb), _ptr(out), _ptr(scratch),
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[out.dtype],
            geo.parts, geo.threads, geo.smem, geo.fin_threads, geo.fin_smem, int(pdl), stream,
        )
    if err == ERR_SHAPE:
        raise ValueError(f"conv_gn_mish's streamed path does not take L={L}, Cin={Cin}, C={C}, "
                         f"n_groups={n_groups}, K={K}, epi={epi}, {geo}")
    if err != 0:
        raise RuntimeError(f"conv_gn_mish streamed launch failed (CUDA error {err}, {geo})")


def _launch_folded(geo: FoldGeometry, x, w, b, gamma, beta, out, n_groups, eps, epi, ein=None, ew=None,
                   eb=None, pdl=False) -> None:
    """One launch of the residual block's template on the folded path at
    geometry ``geo`` (:func:`folded_geometry`)."""
    from .build import library

    B, L, Cin = x.shape
    K, _, C = w.shape
    Ce = ein.shape[-1] if ein is not None else 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = library(SOURCE).adm_conv_gn_mish_folded(
            _ptr(x), _ptr(w), _ptr(b), _ptr(gamma), _ptr(beta),
            B, L, Cin, C, K, n_groups, float(eps), epi,
            _ptr(ein), Ce, _ptr(ew), _ptr(eb),
            _ptr(out), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[out.dtype],
            geo.cs, geo.threads, geo.smem, int(pdl), stream,
        )
    if err == ERR_SHAPE:
        raise ValueError(f"conv_gn_mish's folded path does not take B={B}, L={L}, Cin={Cin}, C={C}, "
                         f"n_groups={n_groups}, K={K}, epi={epi}, {geo}")
    if err != 0:
        raise RuntimeError(f"conv_gn_mish folded launch failed (CUDA error {err}, {geo})")


def _alignment(*tensors: torch.Tensor) -> int:
    """The least alignment of the tensors' pointers, in bytes, up to 16: the
    lowest set bit of their OR."""
    bits = 16
    for t in tensors:
        bits |= t.data_ptr()
    return bits & -bits


def _launch_head(geo: HeadGeometry, x, w, b, gamma, beta, out, n_groups, eps) -> None:
    """One launch of the head's kernel at geometry ``geo``."""
    from .build import library

    B, L, Cin = x.shape
    K, _, C = w.shape
    lib = library(HEAD_SOURCE)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.adm_conv1d_gn_mish(
            _ptr(x), _ptr(w), _ptr(b), _ptr(gamma), _ptr(beta),
            B, L, Cin, C, K, n_groups, float(eps),
            _ptr(out), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[out.dtype],
            geo.S, geo.width, geo.stage, geo.threads, geo.smem, stream,
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


def fused_conv1d_gn_mish(x, w, b, gamma, beta, n_groups: int = 8, eps: float = 1e-5):
    """x: (B, L, Cin); w: (K, Cin, C); b/gamma/beta: (C,) -> (B, L, C)."""
    if x.device.type == "cpu":
        return conv1d_gn_mish_plain(x, w, b, gamma, beta, n_groups, eps)
    kw = dict(n_groups=n_groups, eps=eps)
    if _needs_grad(x, w, b, gamma, beta):
        return Recompute.apply(_conv1d_gn_mish_cuda, conv1d_gn_mish_plain, kw, x, w, b, gamma, beta)
    return _conv1d_gn_mish_cuda(x, w, b, gamma, beta, **kw)


def _conv1d_gn_mish_cuda(x, w, b, gamma, beta, n_groups, eps):
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
    _launch_head(geo, x, w, b, gamma, beta, out, n_groups, eps)
    fused_conv1d_gn_mish.launches += 1
    return out


def fused_residual_block(
    x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, wres=None, bres=None,
    n_groups: int = 8, eps: float = 1e-5, *, weights_cached: bool = False,
):
    """Whole ResidualTemporalMapBlock. x: (B, L, Cin); t: (B, E); w1 (K, Cin,
    C); w2 (K, C, C); tw (E, C), or (E, 2C) with tb (2C,) for FiLM (Diffusion
    Policy's ConditionalResidualBlock1D: the scale's C columns, then the
    shift's); wres (1, Cin, C) or None (then Cin == C).
    ``weights_cached`` (the blocks' own, ``models/blocks.py``):
    the weights and biases are a pack made before this call, which no kernel
    right before it wrote; only then may a one-wave, streamed or folded launch
    overlap the launch before it (:func:`launch_path`)."""
    args = (x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, wres, bres)
    if x.device.type == "cpu":
        return residual_block_plain(*args, n_groups=n_groups, eps=eps)
    launch = functools.partial(_residual_block_cuda, weights_cached=weights_cached)
    kw = dict(n_groups=n_groups, eps=eps)
    if _needs_grad(*args):
        return Recompute.apply(launch, residual_block_plain, kw, *args)
    return launch(*args, **kw)


def _residual_block_cuda(x, t, w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, wres, bres,
                         n_groups, eps, weights_cached=False):
    B, L, Cin = x.shape
    K, _, C = w1.shape
    E = t.shape[1]
    if (wres is None) != (bres is None) or (wres is None and Cin != C):
        raise ValueError("wres/bres are needed exactly when Cin != C")
    film = tw.shape[-1] == 2 * C
    CE = 2 * C if film else C
    _check_cuda(
        x,
        dict(x=x, t=t, w1=w1, b1=b1, g1=g1, be1=be1, tw=tw, tb=tb, w2=w2, b2=b2, g2=g2,
             be2=be2, wres=wres, bres=bres),
        dict(x=(B, L, Cin), t=(B, E), w1=(K, Cin, C), b1=(C,), g1=(C,), be1=(C,), tw=(E, CE),
             tb=(CE,), w2=(K, C, C), b2=(C,), g2=(C,), be2=(C,), wres=(1, Cin, C), bres=(C,)),
    )
    h = torch.empty((B, L, C), dtype=torch.float32, device=x.device)  # stays fp32
    out = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
    geo1, geo2 = residual_block_geometry(B, L, Cin, C, E, wres is not None, K, n_groups, film)
    epi2, ew2 = (EPI_RES_CONV, wres[0]) if wres is not None else (EPI_RES_ID, None)
    for geo, xin, w, b, g, be, y, epi, ein, ew, eb in (
            (geo1, x, w1, b1, g1, be1, h, EPI_FILM if film else EPI_TBIAS, t, tw, tb),
            (geo2, h, w2, b2, g2, be2, out, epi2, x, ew2, bres)):
        geo, path, pdl = _pick_path(geo, xin, w, y, epi, ein, ew, n_groups, weights_cached)
        if path == "streamed":
            _launch_streamed(geo, xin, w, b, g, be, y, n_groups, eps, epi, ein, ew, eb, pdl=pdl)
        elif path == "folded":
            _launch_folded(geo, xin, w, b, g, be, y, n_groups, eps, epi, ein, ew, eb, pdl=pdl)
        else:
            _launch(geo, xin, w, b, g, be, y, n_groups, eps, epi, ein, ew, eb,
                    one_wave=path == "one_wave", pdl=pdl)
        fused_residual_block.one_wave += path == "one_wave"
        fused_residual_block.streamed += path == "streamed"
        fused_residual_block.folded += path == "folded"
        fused_residual_block.pdl += pdl
    fused_residual_block.launches += 1
    fused_residual_block.film += film
    return out


WRAPPERS = ("fused_conv1d_gn_mish", "fused_residual_block")  # launch_counts' keys of calls
# launch_counts' keys of the residual block's launches (two a call) on the
# one-wave path, of those with programmatic dependent launch (on any path),
# of those on the streamed path and of those on the folded path
PATHS = ("fused_residual_block.one_wave", "fused_residual_block.pdl", "fused_residual_block.streamed",
         "fused_residual_block.folded")
# launch_counts' key of the residual block's launches with the FiLM epilogue
# (one a FiLM call)
FILM = "fused_residual_block.film"
# launch_counts' keys of the softmax attention (``ops/nn.py:attention``): its
# calls, the key tokens its cross-attention calls read, and the condition
# tokens projected to cross-attention keys and values (``ops/nn.py:count_cross_kv``)
ATTENTION = ("attention", "attention.cross_keys", "attention.cross_kv")


# (key, wrapper, attribute) of every count
_COUNTERS = tuple((f.__name__, f, "launches") for f in (fused_conv1d_gn_mish, fused_residual_block)) + tuple(
    (key, fused_residual_block, key.split(".")[1]) for key in (*PATHS, FILM)) + (
    (ATTENTION[0], attention, "calls"), (ATTENTION[1], attention, "cross_keys"),
    (ATTENTION[2], attention, "cross_kv"))


def reset_launch_counts() -> None:
    for _, f, attr in _COUNTERS:
        setattr(f, attr, 0)


def launch_counts() -> Dict[str, int]:
    """Each wrapper's launch count (calls), by the wrapper's name, the
    residual block's launches on the one-wave, streamed and folded paths and
    with programmatic dependent launch (:data:`PATHS`), its FiLM launches
    (:data:`FILM`), the softmax attention's calls and cross-attention key
    tokens, and the cross-attention's condition tokens projected to keys
    and values (:data:`ATTENTION`)."""
    return {key: getattr(f, attr) for key, f, attr in _COUNTERS}


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by :func:`launch_counts`' keys) to the launch counts:
    the launches of a replayed CUDA graph, which calls no wrapper."""
    for key, f, attr in _COUNTERS:
        setattr(f, attr, getattr(f, attr) + counts.get(key, 0))


@contextlib.contextmanager
def recorded_launches() -> Iterator[Dict[str, int]]:
    """A dict that holds, once the block is left, the launches made inside
    it (by :func:`launch_counts`' keys); the counts are then set back to
    what they were on entering, also when the block raises. A call counts
    the launches of one run of its body, so what builds a CUDA graph (its
    capture, a warm run that is not the call's own) runs in one."""
    before = launch_counts()
    made: Dict[str, int] = {}
    try:
        yield made
    finally:
        now = launch_counts()
        made.update({key: now[key] - before[key] for key in before})
        for key, f, attr in _COUNTERS:
            setattr(f, attr, before[key])


reset_launch_counts()
