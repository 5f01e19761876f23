"""Seeded stand-ins for the reference's asset files.

The reference ships earthmap.jpg (a baseline JPEG) and the textured
capsule mesh (capsule.obj + capsule.mtl + capsule.jpg, a progressive JPEG).
Tests that exercise the JPEG decoder, the .obj/.mtl parser and the mesh
scene build equivalent files from a seed instead, in the layout
utils/assets.py resolves.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np


def smooth_image(h: int, w: int, seed: int) -> np.ndarray:
    """[h, w, 3] uint8: a few random low-frequency waves per channel."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(3):
            fx, fy, ph = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.uniform(0, 6.3)
            img[..., c] += np.sin(2 * np.pi * (fx * x + fy * y) + ph)
    img = (img - img.min()) / (img.max() - img.min())
    return (255 * img).round().astype(np.uint8)


def write_jpeg(path: Path, seed: int, progressive: bool, h=48, w=96) -> Path:
    """4:4:4 chroma, so decoders differ only by IDCT rounding (chroma
    upsampling filters differ between decoders by design)."""
    from PIL import Image

    Image.fromarray(smooth_image(h, w, seed)).save(
        path, "JPEG", quality=92, progressive=progressive, subsampling=0)
    return path


def write_textured_obj(directory: Path, seed: int, stem="capsule",
                       n_lat=8, n_lon=12, radius=0.8) -> Path:
    """A UV-mapped sphere of quads (fan-triangulated by the parser) with an
    mtl whose map_Kd is a progressive JPEG next to it."""
    directory.mkdir(parents=True, exist_ok=True)
    write_jpeg(directory / f"{stem}.jpg", seed, progressive=True)
    (directory / f"{stem}.mtl").write_text(
        f"newmtl skin\nKa 0.1 0.1 0.1\nKd 0.8 0.8 0.8\nmap_Kd {stem}.jpg\n")
    lines = [f"mtllib {stem}.mtl"]
    for i in range(n_lat + 1):
        th = math.pi * i / n_lat
        for j in range(n_lon + 1):
            ph = 2 * math.pi * j / n_lon
            lines.append(f"v {radius * math.sin(th) * math.cos(ph):.6f} "
                         f"{radius * math.cos(th):.6f} "
                         f"{radius * math.sin(th) * math.sin(ph):.6f}")
            lines.append(f"vt {j / n_lon:.6f} {1 - i / n_lat:.6f}")
    lines.append("usemtl skin")
    row = n_lon + 1
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * row + j + 1
            b, c, d = a + row, a + row + 1, a + 1
            lines.append(f"f {a}/{a} {b}/{b} {c}/{c} {d}/{d}")
    path = directory / f"{stem}.obj"
    path.write_text("\n".join(lines) + "\n")
    return path


def write_asset_tree(root: Path, seed: int = 0) -> Path:
    """textures/earthmap.jpg + models/capsule/capsule.{obj,mtl,jpg}."""
    (root / "textures").mkdir(parents=True, exist_ok=True)
    write_jpeg(root / "textures" / "earthmap.jpg", seed, progressive=False)
    write_textured_obj(root / "models" / "capsule", seed + 1)
    return root
