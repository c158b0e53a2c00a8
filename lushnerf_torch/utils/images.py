"""An 8-bit PNG reader and writer on zlib, struct and numpy (no image
package).  The writer: RGB [H, W, 3] or grey [H, W] uint8, each row with
the filter it is given (0, none, by default); eval, render_only and the
warped-ray images write through it.  The reader: non-interlaced 8-bit
grey, grey + alpha, RGB and RGBA, any row filters, several IDAT chunks;
the LLFF loader reads every PNG through it, so a scene of PNGs loads on a
machine without an image codec.

The reader undoes filters 0-2 a row at a time, and a file with any
average (3) or Paeth (4) row by anti-diagonal wavefronts, which take
h + w - 1 numpy steps and are much slower (both are timed on a 29-view
scene by chip_smoke.py's trainer phase).  OpenCV's `imwrite`, which writes
the preprocess cache (`data/preprocess.py`) and the minified `images_N/`
the loader reads, gives every row the sub filter (1) by default; writers
that choose a filter per row (libpng's heuristic, Pillow) may put average
and Paeth rows in."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG colour type (0 grey, 2 RGB)
# colour type -> channels of the types the reader takes (4 grey + alpha, 6 RGBA)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left a, up b and upper-left c (int arrays)."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_bytes(image: np.ndarray, filters=0) -> bytes:
    """The PNG file of a uint8 image [H, W], [H, W, 1] or [H, W, 3], row y
    filtered with filters[y] (0 none, 1 sub, 2 up, 3 average, 4 Paeth), or
    every row with one int."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"png_bytes: uint8 image expected, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in COLOR_TYPE:
        raise ValueError(f"png_bytes: [H, W], [H, W, 1] or [H, W, 3] expected, got {image.shape}")
    h, w, c = img.shape
    filt = np.broadcast_to(np.asarray(filters, np.intp), (h,))
    if filt.min(initial=0) < 0 or filt.max(initial=0) > 4:
        raise ValueError(f"png_bytes: row filters are 0-4, got {sorted(set(filt.tolist()))}")
    x = img.astype(np.int16)
    up = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]
    data = x.copy()
    for f in np.unique(filt[filt > 0]):  # each filter's prediction on its rows only
        ys = np.flatnonzero(filt == f)
        a, b = np.pad(x[ys], ((0, 0), (1, 0), (0, 0)))[:, :-1], up[ys]
        if f == 4:
            data[ys] -= _paeth(a, b, np.pad(b, ((0, 0), (1, 0), (0, 0)))[:, :-1])
        else:
            data[ys] -= (a, b, (a + b) >> 1)[f - 1]
    data = (data & 0xFF).astype(np.uint8)
    rows = np.concatenate([filt.astype(np.uint8)[:, None], data.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: str | Path, image: np.ndarray) -> None:
    Path(path).write_bytes(png_bytes(image))


def _unfilter_rows(filt: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Rows of filters 0 (none), 1 (sub) and 2 (up) only: [H, W, C] uint8."""
    out = np.empty_like(data)
    prev = np.zeros_like(data[0])
    for y, f in enumerate(filt):
        if f == 0:
            out[y] = data[y]
        elif f == 1:
            out[y] = np.cumsum(data[y], axis=0, dtype=np.uint8)
        else:
            out[y] = data[y] + prev
        prev = out[y]
    return out


def _unfilter_wavefront(filt: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Any row filters, average (3) and Paeth (4) among them: [H, W, C]
    uint8.  A byte depends on its left, upper and upper-left neighbours
    only, so the pixels of one anti-diagonal (x + y = k) decode together.
    They lie w apart in the flat image with a zero row and column before
    it, so each diagonal and its three neighbours are strided views."""
    h, w, c = data.shape
    stride = w + 1
    out = np.zeros(((h + 1) * stride, c), np.int16)  # pixel (y, x) at (y + 1) * stride + x + 1
    raw = data.reshape(h * w, c).astype(np.int16)
    masks = [(filt == f)[:, None] for f in (1, 2, 3, 4)]
    for k in range(h + w - 1):
        y0, y1 = max(0, k - w + 1), min(h, k + 1)
        s = y0 * w + k + w + 2  # pixel (y0, k - y0)
        e = s + (y1 - y0 - 1) * w + 1
        a, b, ul = out[s - 1:e - 1:w], out[s - stride:e - stride:w], out[s - stride - 1:e - stride - 1:w]
        m1, m2, m3, m4 = (m[y0:y1] for m in masks)
        pred = a * m1 + b * m2 + ((a + b) >> 1) * m3 + _paeth(a, b, ul) * m4
        r = y0 * (w - 1) + k  # raw pixel (y0, k - y0)
        out[s:e:w] = (raw[r:r + (y1 - y0 - 1) * (w - 1) + 1:max(w - 1, 1)] + pred) & 0xFF
    return out.reshape(h + 1, stride, c)[1:, 1:].astype(np.uint8)


def read_png(path: str | Path) -> np.ndarray:
    """The uint8 pixels of an 8-bit, non-interlaced PNG: [H, W] grey, [H, W,
    2] grey + alpha, [H, W, 3] RGB or [H, W, 4] RGBA, as imageio reads them
    (ancillary chunks such as gAMA are not applied).  Raises ValueError,
    naming the file, for anything else: another bit depth, a palette, an
    interlaced file, a broken chunk."""
    path = Path(path)
    blob = path.read_bytes()
    if not blob.startswith(PNG_SIGNATURE):
        raise ValueError(f"read_png: {path} is not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(blob):
        n, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        body, crc = blob[pos + 8:pos + 8 + n], blob[pos + 8 + n:pos + 12 + n]
        if len(crc) != 4 or struct.unpack(">I", crc)[0] != zlib.crc32(tag + body):
            raise ValueError(f"read_png: {path}: chunk {tag!r} is truncated or corrupt")
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"read_png: {path} has no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"read_png: {path} is {depth}-bit; only 8-bit PNGs are supported")
    if ctype == 3:
        raise ValueError(f"read_png: {path} is a palette PNG; palettes are not supported")
    if ctype not in CHANNELS:
        raise ValueError(f"read_png: {path} has colour type {ctype}, which is not supported")
    if interlace:
        raise ValueError(f"read_png: {path} is interlaced (Adam7); interlacing is not supported")
    c = CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"read_png: {path}: {raw.size} bytes of pixels, expected "
                         f"{h * (1 + w * c)}")
    rows = raw.reshape(h, 1 + w * c)
    filt, data = rows[:, 0], rows[:, 1:].reshape(h, w, c)
    if filt.max(initial=0) > 4:
        raise ValueError(f"read_png: {path} has a row filter {filt.max()} (0-4 exist)")
    img = (_unfilter_rows(filt, data) if filt.max(initial=0) <= 2
           else _unfilter_wavefront(filt, data))
    return img[..., 0] if c == 1 else img
