"""Native JPEG decoder (native/jpegdec.cpp, stb_image role) and PIL-free
image loading.  The reference's two assets exercise both JPEG coding modes:
earthmap.jpg is baseline (SOF0), capsule.jpg is progressive (SOF2); the
``ref_assets`` fixture writes seeded stand-ins of both (tests/assetgen.py)."""

import sys

import numpy as np
import pytest

from another_raytracer.utils import assets, imageio, native


def _pil_or_skip():
    try:
        from PIL import Image
        return Image
    except ImportError:
        pytest.skip("PIL unavailable for cross-checking")


@pytest.mark.parametrize("asset", ["earthmap", "capsule"])
def test_native_jpeg_matches_pil(asset, ref_assets, native_lib):
    path = (assets.earthmap_path() if asset == "earthmap"
            else assets.capsule_obj_path().parent / "capsule.jpg")
    Image = _pil_or_skip()
    assert Image.open(path).info.get("progressive", 0) == (asset == "capsule")
    a = native.decode_jpeg(path)
    assert a is not None, "native decode failed"
    b = np.asarray(Image.open(path).convert("RGB"))
    assert a.shape == b.shape
    d = np.abs(a.astype(int) - b.astype(int))
    # Decoders legitimately differ by a few LSBs (IDCT + rounding variants);
    # libjpeg vs libjpeg-turbo differ similarly.
    assert d.max() <= 4 and d.mean() < 0.1


def test_load_image_without_pil(tmp_path, monkeypatch, ref_assets,
                                native_lib):
    """load_image must decode real files even with PIL absent: JPEG via the
    native decoder, PNG via the stdlib decoder."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL disabled for test")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    monkeypatch.delitem(sys.modules, "PIL", raising=False)
    monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)

    # PNG round-trip entirely without PIL.
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(9, 13, 3), dtype=np.uint8)
    p = tmp_path / "x.png"
    with open(p, "wb") as f:
        f.write(imageio._encode_png(img))
    back = imageio.load_image(p)
    assert back is not None
    np.testing.assert_array_equal((back * 255.0).round().astype(np.uint8), img)

    # JPEG through the native decoder.
    arr = imageio.load_image(assets.earthmap_path())
    assert arr is not None and arr.shape[2] == 3 and arr.max() <= 1.0


def test_png_decoder_all_filters():
    """Exercise sub/up/average/paeth explicitly (the encoder only emits
    filter 0, so synthesize rows with each filter type)."""
    import struct
    import zlib

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, size=(5, 6, 3), dtype=np.uint8)
    stride = 6 * 3

    # build raw stream applying filter f to row f (valid per PNG spec)
    raw = b""
    prev = np.zeros(stride, np.int64)
    for r in range(5):
        f = r % 5
        cur = img[r].reshape(-1).astype(np.int64)
        enc = np.zeros(stride, np.int64)
        for i in range(stride):
            a = cur[i - 3] if i >= 3 else 0
            b = prev[i]
            c = prev[i - 3] if i >= 3 else 0
            if f == 0:
                enc[i] = cur[i]
            elif f == 1:
                enc[i] = cur[i] - a
            elif f == 2:
                enc[i] = cur[i] - b
            elif f == 3:
                enc[i] = cur[i] - (a + b) // 2
            else:
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                enc[i] = cur[i] - pred
        raw += bytes([f]) + bytes((enc & 0xFF).astype(np.uint8))
        prev = cur

    def chunk(typ, data):
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", 6, 5, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    out = imageio._decode_png(png)
    np.testing.assert_array_equal(out, img)
