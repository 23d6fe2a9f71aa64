"""PNG reading and writing with the standard library's ``zlib`` and numpy.

The port's training machine has neither OpenCV nor PIL, which the JAX
package decodes with (``data/dataset.py:63-65``). This reads what the
dataset holds: 8-bit, non-interlaced PNGs of colour type 0 (grey), 2 (RGB)
or 6 (RGBA), with any of the five row filters (``cv2.imwrite`` and libpng
pick them per row). It returns RGB, as ``cv2.imread`` followed by BGR->RGB
does: grey is repeated into three channels and alpha is dropped. Anything
else raises.

Decoding undoes each row's filter. None, Sub and Up rows are undone a whole
row at a time (Sub as a per-channel prefix sum modulo 256). Average and
Paeth depend on the byte to the left, already reconstructed, so an image
holding any such row is undone along anti-diagonals instead: every pixel
of diagonal x + y = d depends only on diagonals d - 1 and d - 2, so each
step is one vectorised operation over up to H pixels, W + H - 1 steps in
all; :func:`read_pngs` walks them once for a batch of frames, so each step
covers up to n x H pixels. ``chip_smoke.py`` phase 8 times both on the
card's host.

:func:`write_png` writes grey, RGB or RGBA with a chosen filter, so that
data can be made without either library.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

__all__ = ["read_png", "read_pngs", "png_shape", "write_png"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG -> (H, W, 3) uint8 RGB."""
    return read_pngs([path])[0]


def read_pngs(paths: Sequence[str]) -> np.ndarray:
    """8-bit PNGs of one size -> (n, H, W, 3) uint8 RGB, each frame as
    :func:`read_png` reads it. The frames' row filters are undone together,
    so the anti-diagonals of a batch's Average and Paeth rows are walked
    once for all of its frames (``data/dataset.py``'s decoder processes
    read a batch so)."""
    frames = [_filtered(p) for p in paths]
    h, w = frames[0][0].shape[:2]
    out = np.empty((len(frames), h, w, 3), np.uint8)
    for bpp in sorted({f.shape[2] for f, _ in frames}):
        idx = [i for i, (f, _) in enumerate(frames) if f.shape[2] == bpp]
        for i in idx:
            if frames[i][0].shape[:2] != (h, w):
                raise ValueError(f"{paths[i]}: a {frames[i][0].shape[1]}x{frames[i][0].shape[0]} frame among "
                                 f"{w}x{h} ones")
        img = _unfilter(np.stack([frames[i][0] for i in idx]), np.stack([frames[i][1] for i in idx]))
        out[idx] = np.repeat(img, 3, axis=3) if bpp == 1 else img[..., :3]
    return out


def _filtered(path: str):
    """A PNG's filtered rows (H, W, bpp) uint8 and each row's filter (H,)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path} is not a PNG")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, ctype, compression, filter_method, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace or compression or filter_method:
        raise ValueError(
            f"{path}: only 8-bit, non-interlaced PNGs of colour type 0, 2 or 6 are read "
            f"(bit depth {depth}, colour type {ctype}, interlace {interlace})"
        )
    bpp = _CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {rows.size} bytes of image data for {w}x{h}x{bpp}")
    rows = rows.reshape(h, w * bpp + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(kinds.max())}")
    return rows[:, 1:].reshape(h, w, bpp), kinds


def png_shape(path: str):
    """(H, W, 3): the shape ``read_png`` returns for ``path``, from its
    header alone."""
    with open(path, "rb") as f:
        head = f.read(8 + 8 + 13)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return h, w, 3


def _paeth(a, b, c):
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)  # |p - a|, |p - b|, |p - c| for p = a + b - c
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filt: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Undo the row filters of ``filt`` (n, H, W, bpp) uint8, n frames whose
    rows' filters are ``kinds`` (n, H)."""
    n, h, w, bpp = filt.shape
    if kinds.max(initial=0) <= 2:
        out = np.empty_like(filt)
        prev = np.zeros((n, w, bpp), np.uint8)
        for y in range(h):
            k, row = kinds[:, y, None, None], filt[:, y]
            if (k == 1).any():
                row = np.where(k == 1, np.cumsum(filt[:, y], axis=1, dtype=np.uint8), row)  # wraps modulo 256
            if (k == 2).any():
                row = np.where(k == 2, filt[:, y] + prev, row)
            out[:, y] = row
            prev = out[:, y]
        return out
    # anti-diagonals: pixel (y, x) of frame i lives at R[x + y + 2, y + 1, i];
    # two zero diagonals in front and a zero row above stand for the bytes
    # outside; a diagonal's rows of every frame are one contiguous block
    n_diag = w + h - 1
    skew = np.zeros((n_diag, h, n, bpp), np.int16)
    for y in range(h):
        skew[y:y + w, y] = filt[:, y].transpose(1, 0, 2)
    R = np.zeros((n_diag + 2, h + 1, n, bpp), np.int16)
    # each filter the rows use, and where: None predicts 0, Sub a, Up b,
    # Average (a + b) / 2, Paeth the nearest of a, b, c to a + b - c
    used = {j: (kinds.T == j)[:, :, None] for j in range(5) if (kinds == j).any()}
    for d in range(n_diag):
        y0, y1 = max(0, d - w + 1), min(h - 1, d) + 1
        a, b, c = R[d + 1, y0 + 1:y1 + 1], R[d + 1, y0:y1], R[d, y0:y1]  # left, up, up-left
        preds = {1: lambda: a, 2: lambda: b, 3: lambda: (a + b) >> 1, 4: lambda: _paeth(a, b, c)}
        if len(used) == 1:
            (j,) = used
            pred = preds[j]() if j else 0
        else:
            pred = np.zeros(a.shape, np.int16)
            for j, rows in used.items():
                if j:
                    np.copyto(pred, preds[j](), where=rows[y0:y1])
        R[d + 2, y0 + 1:y1 + 1] = (skew[d, y0:y1] + pred) & 255
    out = np.empty((n, h, w, bpp), np.uint8)
    for y in range(h):
        out[:, y] = R[y + 2:y + 2 + w, y + 1].transpose(1, 0, 2)
    return out


def _filter(raw: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Apply each row's filter to ``raw`` (H, W, bpp) uint8 -> the filtered
    bytes, (H, W, bpp) uint8."""
    x = raw.astype(np.int16)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, 1:] = x[:-1, :-1]
    preds = [np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, upleft)]
    pred = np.choose(kinds.astype(np.intp)[:, None, None], preds)
    return ((x - pred) & 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray, filter_type: Union[int, Sequence[int]] = 0,
              level: int = 6) -> None:
    """Write ``img``, (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8, as
    an 8-bit PNG. ``filter_type``: one row filter (0-4) for every row, or
    one per row; ``level``: the zlib compression level."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, bpp = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(bpp)
    if ctype is None:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {bpp}")
    kinds = np.broadcast_to(np.asarray(filter_type, np.uint8), (h,))
    if kinds.max(initial=0) > 4:
        raise ValueError(f"row filters are 0-4, got {filter_type}")
    rows = np.concatenate([kinds[:, None], _filter(img, kinds).reshape(h, w * bpp)], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))
