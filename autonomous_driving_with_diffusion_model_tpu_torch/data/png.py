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
all. ``chip_smoke.py`` phase 8 times both on the card's host.

:func:`write_png` writes grey, RGB or RGBA with a chosen filter, so that
data can be made without either library.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

__all__ = ["read_png", "write_png"]

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
    img = _unfilter(rows[:, 1:].reshape(h, w, bpp), kinds)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filt: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Undo the row filters of ``filt`` (H, W, bpp) uint8."""
    h, w, bpp = filt.shape
    if kinds.max(initial=0) <= 2:
        out = np.empty_like(filt)
        prev = np.zeros((w, bpp), np.uint8)
        for y in range(h):
            k = kinds[y]
            if k == 1:
                out[y] = np.cumsum(filt[y], axis=0, dtype=np.uint8)  # wraps modulo 256
            elif k == 2:
                out[y] = filt[y] + prev
            else:
                out[y] = filt[y]
            prev = out[y]
        return out
    # anti-diagonals: pixel (y, x) lives at R[x + y + 2, y + 1]; two zero
    # diagonals in front and a zero row above stand for the bytes outside
    n_diag = w + h - 1
    skew = np.zeros((n_diag, h, bpp), np.int16)
    for y in range(h):
        skew[y:y + w, y] = filt[y]
    R = np.zeros((n_diag + 2, h + 1, bpp), np.int16)
    k = kinds.astype(np.intp)[:, None]
    has_avg, has_paeth = (kinds == 3).any(), (kinds == 4).any()
    zero = np.zeros((h, bpp), np.int16)
    for d in range(n_diag):
        y0, y1 = max(0, d - w + 1), min(h - 1, d) + 1
        a, b, c = R[d + 1, y0 + 1:y1 + 1], R[d + 1, y0:y1], R[d, y0:y1]  # left, up, up-left
        n = y1 - y0
        pred = np.choose(k[y0:y1], [zero[:n], a, b, (a + b) >> 1 if has_avg else zero[:n],
                                    _paeth(a, b, c) if has_paeth else zero[:n]])
        R[d + 2, y0 + 1:y1 + 1] = (skew[d, y0:y1] + pred) & 255
    out = np.empty((h, w, bpp), np.uint8)
    for y in range(h):
        out[y] = R[y + 2:y + 2 + w, y + 1]
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
