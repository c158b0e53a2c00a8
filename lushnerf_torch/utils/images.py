"""An 8-bit PNG writer on zlib and struct (no image package): RGB
[H, W, 3] or grey [H, W] uint8, every row with filter 0 (none).  Eval,
render_only and the warped-ray images write through it, so they need no
image codec."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG colour type (0 grey, 2 RGB)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def png_bytes(image: np.ndarray) -> bytes:
    """The PNG file of a uint8 image [H, W], [H, W, 1] or [H, W, 3]."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"png_bytes: uint8 image expected, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in COLOR_TYPE:
        raise ValueError(f"png_bytes: [H, W], [H, W, 1] or [H, W, 3] expected, got {image.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: str | Path, image: np.ndarray) -> None:
    Path(path).write_bytes(png_bytes(image))
