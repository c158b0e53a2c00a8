"""lushnerf_torch/utils/images.read_png and the LLFF loader on it: the
reader against imageio.v2.imread (bit for bit) on PNGs from `write_png`,
from imageio, from cv2.imwrite (the preprocess cache's writer) and
encoded here with each row filter 0-4 (8-bit L, LA, RGB and RGBA, several
IDAT chunks), its refusals (16-bit, palette, interlaced), its two
unfiltering paths against each other; `png_bytes`'s row filters against
the encoder here; then a scene written by `write_llff_scene` loaded with
imageio and cv2 unimportable, equal to the same scene in memory."""

import struct
import sys
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from lushnerf_torch.data.llff import load_llff_data, write_llff_scene
from lushnerf_torch.utils.images import (PNG_SIGNATURE, _unfilter_rows, _unfilter_wavefront,
                                         png_bytes, read_png, write_png)

COLOR_TYPES = {"L": (0, 1), "LA": (4, 2), "RGB": (2, 3), "RGBA": (6, 4)}


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img, filters, ctype, depth=8, interlace=0, idat_parts=3, plte=b""):
    """A PNG of img [H, W, C] uint8 with row y filtered by filters[y] (the
    spec's forward filters), its IDAT split into idat_parts chunks."""
    h, w, c = img.shape
    x = img.astype(np.int32)
    rows = []
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros((1, c), np.int32), cur[:-1]])
        upleft = np.concatenate([np.zeros((1, c), np.int32), up[:-1]])
        pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1, 4: _paeth(left, up, upleft)}
        f = filters[y]
        rows.append(bytes([f]) + ((cur - pred[f]) & 0xFF).astype(np.uint8).tobytes())
    data = zlib.compress(b"".join(rows))
    cut = np.linspace(0, len(data), idat_parts + 1).astype(int)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + (_chunk(b"PLTE", plte) if plte else b"")
            + b"".join(_chunk(b"IDAT", data[a:b]) for a, b in zip(cut[:-1], cut[1:]))
            + _chunk(b"IEND", b""))


def _image(rng, h, w, c):
    """Smooth gradients with noise: neighbouring bytes close, as a photo's,
    and every byte value reached."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(7 * xx + 3 * yy + 40 * k) for k in range(c)], -1)
    return ((base + rng.integers(0, 24, (h, w, c))) % 256).astype(np.uint8)


def _same_as_imageio(path, want):
    got = read_png(path)
    ref = imageio.imread(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed"])
@pytest.mark.parametrize("mode", list(COLOR_TYPES))
def test_read_png_each_filter_matches_imageio(mode, filters, tmp_path):
    ctype, c = COLOR_TYPES[mode]
    h, w = 19, 23
    img = _image(np.random.default_rng(ctype * 10 + len(filters)), h, w, c)
    fs = [y % 5 for y in range(h)] if filters == "mixed" else [int(filters)] * h
    path = tmp_path / f"{mode}_{filters}.png"
    path.write_bytes(encode_png(img, fs, ctype))
    _same_as_imageio(path, img[..., 0] if c == 1 else img)


@pytest.mark.parametrize("shape", [(31, 17), (31, 17, 3)], ids=["grey", "rgb"])
def test_read_png_of_write_png(shape, tmp_path):
    img = _image(np.random.default_rng(1), 31, 17, 1 if len(shape) == 2 else 3).reshape(shape)
    write_png(tmp_path / "a.png", img)
    _same_as_imageio(tmp_path / "a.png", img)
    assert png_bytes(read_png(tmp_path / "a.png")) == (tmp_path / "a.png").read_bytes()


@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed"])
@pytest.mark.parametrize("shape", [(21, 13), (21, 13, 3)], ids=["grey", "rgb"])
def test_png_bytes_row_filters(shape, filters, tmp_path):
    """png_bytes with per-row filters: the same file as the encoder here
    (one IDAT), read back by read_png and imageio as the image."""
    h = shape[0]
    img = _image(np.random.default_rng(5), h, shape[1], 1 if len(shape) == 2 else 3).reshape(shape)
    fs = [y % 5 for y in range(h)] if filters == "mixed" else [int(filters)] * h
    blob = png_bytes(img, fs if filters == "mixed" else int(filters))
    ctype = 0 if len(shape) == 2 else 2
    assert blob == encode_png(img.reshape(h, shape[1], -1), fs, ctype, idat_parts=1)
    (tmp_path / "a.png").write_bytes(blob)
    _same_as_imageio(tmp_path / "a.png", img)
    with pytest.raises(ValueError, match="row filters"):
        png_bytes(img, 5)


@pytest.mark.parametrize("shape", [(17, 29, 3), (1, 9, 4), (9, 1, 2), (1, 1, 1)])
def test_unfilter_paths_agree(shape):
    """The row path (filters 0-2) and the wavefront (any filter) give the
    same pixels on rows of filters 0-2 in any order."""
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, shape, dtype=np.uint8)
    for filt in (rng.integers(0, 3, shape[0]), np.zeros(shape[0]), np.ones(shape[0]),
                 np.full(shape[0], 2)):
        filt = filt.astype(np.uint8)
        np.testing.assert_array_equal(_unfilter_wavefront(filt, data), _unfilter_rows(filt, data))


@pytest.mark.parametrize("channels", [1, 3], ids=["grey", "rgb"])
def test_read_png_of_cv2_imwrite(channels, tmp_path):
    """What OpenCV writes into the preprocess cache, read as cv2 reads it."""
    cv2 = pytest.importorskip("cv2")
    img = _image(np.random.default_rng(7), 37, 26, channels)
    img = img[..., 0] if channels == 1 else img
    assert cv2.imwrite(str(tmp_path / "a.png"), img)
    want = cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED)
    got = read_png(tmp_path / "a.png")
    np.testing.assert_array_equal(got, want if channels == 1 else want[..., ::-1])
    np.testing.assert_array_equal(got, img if channels == 1 else img[..., ::-1])


@pytest.mark.parametrize("mode", list(COLOR_TYPES))
def test_read_png_of_imageio(mode, tmp_path):
    _, c = COLOR_TYPES[mode]
    img = _image(np.random.default_rng(2), 40, 33, c)
    img = img[..., 0] if c == 1 else img
    imageio.imwrite(tmp_path / "a.png", img)
    _same_as_imageio(tmp_path / "a.png", img)


def test_read_png_refusals(tmp_path):
    img = _image(np.random.default_rng(3), 6, 5, 1)
    cases = {
        "16-bit": (encode_png(img, [0] * 6, 0, depth=16), "16-bit"),
        "palette": (encode_png(img, [0] * 6, 3, plte=bytes(range(256)) * 3), "palette"),
        "interlaced": (encode_png(img, [0] * 6, 0, interlace=1), "interlaced"),
    }
    for name, (blob, what) in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(blob)
        with pytest.raises(ValueError, match=what) as e:
            read_png(path)
        assert str(path) in str(e.value)
    corrupt = bytearray(png_bytes(img[..., 0]))
    corrupt[40] ^= 0xFF  # inside the IDAT chunk
    (tmp_path / "corrupt.png").write_bytes(bytes(corrupt))
    with pytest.raises(ValueError, match="corrupt"):
        read_png(tmp_path / "corrupt.png")


def test_llff_scene_loads_without_image_codecs(tmp_path, monkeypatch):
    """write_llff_scene's directory, read with imageio and cv2 unimportable:
    the images are the scene's uint8 values / 255 bit for bit, the poses
    and bounds the scene's; with the loader's defaults (recentering, the
    bounds' rescale) the same arrays as a load with the codecs present."""
    rng = np.random.default_rng(4)
    n, h, w = 5, 12, 20
    images = _image(rng, n * h, w, 3).reshape(n, h, w, 3)
    c2w = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    c2w[:, :, 3] = rng.uniform(-0.2, 0.2, (n, 3))
    angle = rng.uniform(-0.1, 0.1, n)
    c2w[:, 0, 0], c2w[:, 0, 2] = np.cos(angle), np.sin(angle)
    c2w[:, 2, 0], c2w[:, 2, 2] = -np.sin(angle), np.cos(angle)
    bds = np.stack([rng.uniform(1.0, 1.5, n), rng.uniform(5.0, 6.0, n)], -1).astype(np.float32)
    root = write_llff_scene(tmp_path / "scene", images, c2w, bds, focal=15.0)
    with_codecs = load_llff_data(root)
    for name in ("imageio", "imageio.v2", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    data = load_llff_data(root, recenter=False, bd_factor=None)
    np.testing.assert_array_equal(data.images, (images / 255.0).astype(np.float32))
    np.testing.assert_allclose(data.poses[:, :, :4], c2w, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(data.poses[:, :, 4], np.tile([h, w, 15.0], (n, 1)))
    np.testing.assert_array_equal(data.bds, bds)
    again = load_llff_data(root)
    for a, b in zip(again, with_codecs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_llff_scene_row_filters_load_the_same(tmp_path, monkeypatch):
    """A scene whose images/ mix filters 0-4 and whose cache has sub rows
    only, as OpenCV writes it: both load, without the codecs, as the
    scene's uint8 values."""
    rng = np.random.default_rng(8)
    n, h, w = 3, 10, 14
    images = _image(rng, n * h, w, 3).reshape(n, h, w, 3)
    c2w = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    c2w[:, :, 3] = rng.uniform(-0.2, 0.2, (n, 3))
    bds = np.tile(np.array([[1.0, 5.0]], np.float32), (n, 1))
    root = write_llff_scene(tmp_path / "scene", images, c2w, bds, focal=9.0,
                            filters=np.arange(h) % 5, cache_filters=1)
    for name in ("imageio", "imageio.v2", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    for preprocess in (True, False):
        data = load_llff_data(root, recenter=False, bd_factor=None, preprocess=preprocess)
        np.testing.assert_array_equal(data.images, (images / 255.0).astype(np.float32))
