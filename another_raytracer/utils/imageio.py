"""Host-side image IO.

The reference vendors stb_image / stb_image_write for JPEG/PNG decode/encode
(SURVEY §2.7) — cold-path host work.  Here decode feeds texture atlases at
scene-build time and encode writes the final gathered framebuffer; the device
never touches an image codec.
"""

from __future__ import annotations

import numpy as np


def load_image(path) -> "np.ndarray | None":
    """Decode an image file to [h, w, 3] float64 in [0,1]; None on failure
    (callers degrade to the cyan fallback texture, texture.h:91-92).

    The cyan fallback is the reference's contract for *missing* files only
    (texture.h:91-92); its stb_image always decodes files that exist.  When a
    present-on-disk file cannot be decoded here (no PIL, corrupt data), that
    is a capability gap, not expected degradation — warn loudly instead of
    silently rendering cyan.
    """
    import os
    import warnings

    exists = os.path.exists(path)
    if not exists:
        return None

    pil_error = None
    try:
        from PIL import Image

        try:
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB"), np.float64) / 255.0
        except Exception as e:  # decode failure; try the native decoders
            pil_error = e
    except ImportError:
        pass

    # Native/stdlib decoders (PIL-free path — the stb_image role):
    # native/jpegdec.cpp handles baseline + progressive JPEG (both reference
    # assets); _decode_png handles our own PNG output.
    head = open(path, "rb").read(8)
    if head[:2] == b"\xff\xd8":
        from another_raytracer.utils import native

        arr = native.decode_jpeg(path)
        if arr is not None:
            return arr.astype(np.float64) / 255.0
    if head == b"\x89PNG\r\n\x1a\n":
        try:
            return _decode_png(open(path, "rb").read()).astype(np.float64) / 255.0
        except Exception as e:
            pil_error = pil_error or e

    warnings.warn(
        f"image file {path!r} exists but could not be decoded"
        + (f" ({pil_error})" if pil_error else " (no decoder for this format)")
        + "; falling back to the solid-cyan texture (the reference's "
        "stb_image would have decoded a valid file)",
        RuntimeWarning, stacklevel=2,
    )
    return None


def _decode_png(data: bytes) -> "np.ndarray":
    """Minimal stdlib PNG decoder: 8-bit gray/RGB/RGBA, all five filter
    types, no interlacing — enough to read back anything `_encode_png` (or a
    typical screenshot tool) writes without PIL."""
    import struct
    import zlib

    pos = 8
    idat = b""
    w = h = None
    color_type = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        typ = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if typ == b"IHDR":
            w, h, depth, color_type, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", body)
            if depth != 8 or interlace:
                raise ValueError("only 8-bit non-interlaced PNG supported")
            nchan = {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type)
            if nchan is None:
                raise ValueError("palette PNG not supported")
        elif typ == b"IDAT":
            idat += body
        elif typ == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * nchan
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    p = 0
    for row in range(h):
        f = raw[p]
        line = np.frombuffer(raw, np.uint8, stride, p + 1).astype(np.int64)
        p += 1 + stride
        # Row-vectorized unfiltering.  Filters 0 (none), 2 (up), and 1 (sub,
        # a per-channel running sum = cumsum mod 256) are O(1) Python work
        # per row; 3 (average) and 4 (Paeth) depend on the *decoded* previous
        # pixel through a nonlinear op, so they walk pixels (channels
        # vectorized, O(w) per row).  Our own encoder emits filter 0 only,
        # so round-trips never hit the slow rows.
        if f == 0:
            cur = line
        elif f == 1:
            cur = np.cumsum(line.reshape(w, nchan), axis=0).reshape(stride) & 0xFF
        elif f == 2:
            cur = (line + prev) & 0xFF
        else:
            px_line = line.reshape(w, nchan)
            px_prev = prev.reshape(w, nchan)
            px_cur = np.zeros((w, nchan), np.int64)
            a = np.zeros(nchan, np.int64)
            c = np.zeros(nchan, np.int64)
            for i in range(w):
                b = px_prev[i]
                if f == 3:
                    x = px_line[i] + (a + b) // 2
                else:  # Paeth
                    pp = a + b - c
                    pa, pb, pc = np.abs(pp - a), np.abs(pp - b), np.abs(pp - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                    x = px_line[i] + pred
                a = px_cur[i] = x & 0xFF
                c = b
            cur = px_cur.reshape(stride)
        out[row] = cur
        prev = cur
    img = out.reshape(h, w, nchan)
    if nchan == 1:
        img = np.repeat(img, 3, axis=-1)
    elif nchan == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    else:
        img = img[..., :3]
    return img


def _encode_png(img: "np.ndarray") -> bytes:
    """Minimal stdlib PNG encoder (8-bit RGB, zlib-deflated, no filtering).

    Keeps PNG output self-contained like the reference's vendored
    stb_image_write (SURVEY §2.7) — PIL is preferred for speed but never
    required.
    """
    import struct
    import zlib

    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_png(path, image_uint8) -> None:
    """Encode a [h, w, 3] uint8 array as PNG (reference: output.png,
    main.cpp:57).  Uses PIL when available, else the stdlib encoder."""
    img = np.ascontiguousarray(np.asarray(image_uint8, np.uint8))
    try:
        from PIL import Image

        Image.fromarray(img, "RGB").save(path)
    except ImportError:
        with open(path, "wb") as f:
            f.write(_encode_png(img))


def save_ppm(path, image_uint8) -> None:
    """Plain PPM writer (no dependencies), for debugging."""
    img = np.asarray(image_uint8, np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())
