"""Host image IO: stdlib PNG fallback round-trips exactly.

The reference ships its own PNG encoder (vendored stb_image_write); here
PIL is an optional fast path and the stdlib zlib encoder the guarantee.
"""

import numpy as np

from another_raytracer.utils import imageio


def test_stdlib_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(13, 17, 3), dtype=np.uint8)
    p = tmp_path / "x.png"
    with open(p, "wb") as f:
        f.write(imageio._encode_png(img))
    back = imageio.load_image(p)
    assert back is not None
    np.testing.assert_array_equal((back * 255.0).round().astype(np.uint8), img)


def test_save_png_writes_decodable_file(tmp_path):
    img = np.zeros((4, 6, 3), np.uint8)
    img[..., 1] = 200
    p = tmp_path / "g.png"
    imageio.save_png(p, img)
    back = imageio.load_image(p)
    np.testing.assert_array_equal((back * 255.0).round().astype(np.uint8), img)


def test_load_missing_returns_none(tmp_path):
    assert imageio.load_image(tmp_path / "nope.png") is None


def test_load_missing_is_silent_but_corrupt_warns(tmp_path, recwarn):
    import warnings

    # Missing file: expected degradation (texture.h:91-92) — no warning.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert imageio.load_image(tmp_path / "absent.jpg") is None

    # Present-but-undecodable file: the reference's stb always decodes real
    # files, so silently rendering cyan would hide a capability gap.
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image at all")
    import pytest

    with pytest.warns(RuntimeWarning, match="exists but"):
        assert imageio.load_image(bad) is None
