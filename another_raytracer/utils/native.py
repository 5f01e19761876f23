"""ctypes bridge to the native C++ runtime library (native/).

The reference's cold-path runtime (obj parsing via rapidobj, image codecs via
stb) is native C++; this framework keeps the same split: device compute in
XLA/Pallas, host runtime in C++ where it pays.  The library is optional —
every caller has a pure-Python fallback — so the framework runs anywhere
even without a toolchain.

Build it from the checkout root with the C++ compiler on PATH:

    python -m another_raytracer.utils.native

which compiles ``native/*.cpp`` into ``native/build/libartpu_native.so``
(``native/build/`` is listed in .gitignore).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
LIB_PATH = NATIVE_DIR / "build" / "libartpu_native.so"
_LIB_PATHS = (
    LIB_PATH,
    Path(__file__).resolve().parent.parent / "_native" / "libartpu_native.so",
)

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    for p in _LIB_PATHS:
        if p.exists():
            try:
                lib = ctypes.CDLL(str(p))
                lib.artpu_parse_obj.restype = ctypes.c_void_p
                lib.artpu_parse_obj.argtypes = [ctypes.c_char_p]
                lib.artpu_mesh_num_triangles.restype = ctypes.c_longlong
                lib.artpu_mesh_num_triangles.argtypes = [ctypes.c_void_p]
                lib.artpu_mesh_num_materials.restype = ctypes.c_longlong
                lib.artpu_mesh_num_materials.argtypes = [ctypes.c_void_p]
                lib.artpu_mesh_fill.restype = None
                lib.artpu_mesh_fill.argtypes = [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_double),  # tri_pos [T*9]
                    ctypes.POINTER(ctypes.c_double),  # tri_uv [T*6]
                    ctypes.POINTER(ctypes.c_longlong),  # tri_mat [T]
                ]
                lib.artpu_mesh_material.restype = ctypes.c_char_p
                lib.artpu_mesh_material.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
                lib.artpu_mesh_free.restype = None
                lib.artpu_mesh_free.argtypes = [ctypes.c_void_p]
                if hasattr(lib, "artpu_decode_jpeg"):
                    lib.artpu_decode_jpeg.restype = ctypes.c_void_p
                    lib.artpu_decode_jpeg.argtypes = [
                        ctypes.c_char_p,
                        ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_int),
                    ]
                    lib.artpu_image_free.restype = None
                    lib.artpu_image_free.argtypes = [ctypes.c_void_p]
                _lib = lib
                break
            except OSError:
                continue
    return _lib


def available() -> bool:
    return _load() is not None


def build(compiler: str = "c++") -> Path:
    """Compile the native sources into LIB_PATH and return it.

    The library is written to a per-process temporary name and renamed into
    place, so concurrent builds (e.g. test workers) never load a
    half-written file."""
    global _lib, _tried
    sources = sorted(str(p) for p in NATIVE_DIR.glob("*.cpp"))
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f".{LIB_PATH.name}.{os.getpid()}.tmp")
    subprocess.run(
        [compiler, "-std=c++20", "-O2", "-shared", "-fPIC", "-o", str(tmp),
         *sources],
        check=True)
    os.replace(tmp, LIB_PATH)
    _lib, _tried = None, False
    return LIB_PATH


def parse_obj(path) -> Optional[tuple]:
    """Parse via the native library.  Returns (tri_pos [T,3,3] f64,
    tri_uv [T,3,2] f64, tri_mat [T] i64, materials) or None on failure."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.artpu_parse_obj(str(path).encode())
    if not handle:
        return None
    try:
        t = int(lib.artpu_mesh_num_triangles(handle))
        nm = int(lib.artpu_mesh_num_materials(handle))
        tri_pos = np.zeros((t, 3, 3), np.float64)
        tri_uv = np.zeros((t, 3, 2), np.float64)
        tri_mat = np.zeros((t,), np.int64)
        lib.artpu_mesh_fill(
            handle,
            tri_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tri_uv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tri_mat.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        )
        from another_raytracer.models.mesh import MtlMaterial

        materials = []
        for i in range(nm):
            # name|ka_r,ka_g,ka_b|kd_r,kd_g,kd_b|map_kd
            raw = lib.artpu_mesh_material(handle, i).decode(errors="replace")
            name, ka, kd, map_kd = raw.split("|")
            materials.append(
                MtlMaterial(
                    name=name,
                    ka=tuple(float(x) for x in ka.split(",")),
                    kd=tuple(float(x) for x in kd.split(",")),
                    map_kd=map_kd,
                )
            )
        return tri_pos, tri_uv, tri_mat, materials
    finally:
        lib.artpu_mesh_free(handle)


def decode_jpeg(path) -> "Optional[np.ndarray]":
    """Decode a JPEG via the native decoder (native/jpegdec.cpp — baseline +
    progressive, the stb_image role).  Returns [h, w, 3] uint8 or None."""
    lib = _load()
    if lib is None or not hasattr(lib, "artpu_decode_jpeg"):
        return None
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    ptr = lib.artpu_decode_jpeg(str(path).encode(), ctypes.byref(w), ctypes.byref(h))
    if not ptr:
        return None
    try:
        n = w.value * h.value * 3
        buf = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_ubyte * n)).contents
        return np.frombuffer(bytes(buf), np.uint8).reshape(h.value, w.value, 3).copy()
    finally:
        lib.artpu_image_free(ptr)


if __name__ == "__main__":
    print(build())
