"""Wavefront .obj/.mtl ingestion into flat triangle arrays.

Replaces the reference's rapidobj + ``mesh::build`` pipeline (mesh.h:31-145):
parse, fan-triangulate, then emit per-triangle vertex positions, per-vertex
texcoords, and materials following the reference's three material paths:
  (a) mtl with map_Kd  -> textured lambertian with per-vertex texcoords
      (the barycentric_image_texture path, mesh.h:103-123),
  (b) mtl without map  -> lambertian(Ka + Kd) (mesh.h:124-130),
  (c) no materials     -> lambertian(random color) per triangle (mesh.h:132-138).

A native C++ parser (native/objparser.cpp) accelerates the cold path when
built; this module transparently falls back to the pure-Python parser.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

from another_raytracer.utils import imageio


@dataclasses.dataclass
class MtlMaterial:
    name: str
    ka: tuple = (0.0, 0.0, 0.0)
    kd: tuple = (0.8, 0.8, 0.8)
    map_kd: str = ""


@dataclasses.dataclass
class MeshData:
    """Triangulated mesh: [T,3,3] vertex positions, [T,3,2] texcoords,
    [T] material ids (-1 = none), and the mtl material list."""

    tri_pos: np.ndarray
    tri_uv: np.ndarray
    tri_mat: np.ndarray
    materials: list
    work_dir: Path

    @property
    def num_triangles(self) -> int:
        return self.tri_pos.shape[0]


def _parse_mtl(path: Path) -> list:
    materials = []
    cur = None
    try:
        text = path.read_text(errors="replace")
    except OSError:
        return materials
    for line in text.splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        tag = parts[0]
        if tag == "newmtl":
            cur = MtlMaterial(name=parts[1] if len(parts) > 1 else "")
            materials.append(cur)
        elif cur is None:
            continue
        elif tag == "Ka" and len(parts) >= 4:
            cur.ka = tuple(float(x) for x in parts[1:4])
        elif tag == "Kd" and len(parts) >= 4:
            cur.kd = tuple(float(x) for x in parts[1:4])
        elif tag == "map_Kd" and len(parts) >= 2:
            cur.map_kd = parts[-1]
    return materials


def _parse_obj_python(path: Path):
    """Pure-Python .obj parse with fan triangulation (rapidobj::Triangulate
    fans polygons the same way)."""
    positions, texcoords = [], []
    faces = []  # (list of (vi, ti), material_id)
    materials = []
    mat_by_name = {}
    cur_mat = -1

    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        tag = parts[0]
        if tag == "v":
            positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "vt":
            texcoords.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
        elif tag == "f":
            corners = []
            for tok in parts[1:]:
                comp = tok.split("/")
                vi = int(comp[0])
                ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
                corners.append((vi, ti))
            faces.append((corners, cur_mat))
        elif tag == "mtllib":
            mtl_path = path.parent / parts[1]
            for m in _parse_mtl(mtl_path):
                mat_by_name[m.name] = len(materials)
                materials.append(m)
        elif tag == "usemtl":
            cur_mat = mat_by_name.get(parts[1] if len(parts) > 1 else "", -1)

    pos = np.asarray(positions, np.float64) if positions else np.zeros((0, 3))
    uv = np.asarray(texcoords, np.float64) if texcoords else np.zeros((0, 2))

    def resolve(idx, n):
        # obj indices are 1-based; negative counts from the end.
        return idx - 1 if idx > 0 else n + idx

    tri_pos, tri_uv, tri_mat = [], [], []
    for corners, mat in faces:
        # fan triangulation: (0, i, i+1)
        for i in range(1, len(corners) - 1):
            tri = [corners[0], corners[i], corners[i + 1]]
            tri_pos.append([pos[resolve(vi, len(pos))] for vi, _ in tri])
            tri_uv.append([
                uv[resolve(ti, len(uv))] if ti != 0 and len(uv) else (0.0, 0.0)
                for _, ti in tri
            ])
            tri_mat.append(mat)

    return (
        np.asarray(tri_pos, np.float64).reshape(-1, 3, 3),
        np.asarray(tri_uv, np.float64).reshape(-1, 3, 2),
        np.asarray(tri_mat, np.int64).reshape(-1),
        materials,
    )


def parse(mesh_path) -> MeshData:
    """Parse + triangulate an .obj (native parser when available, else
    Python).  Raises on unreadable files, mirroring the reference's throw on
    parse failure (scene_manager.cpp:257)."""
    path = Path(mesh_path)
    if not path.exists():
        raise FileNotFoundError(f"cannot parse mesh file: {path}")
    from another_raytracer.utils import native

    parsed = native.parse_obj(path) if native.available() else None
    if parsed is None:
        parsed = _parse_obj_python(path)
    tri_pos, tri_uv, tri_mat, materials = parsed
    return MeshData(
        tri_pos=tri_pos, tri_uv=tri_uv, tri_mat=tri_mat,
        materials=materials, work_dir=path.parent,
    )


def add_to_builder(builder, mesh: MeshData, rand_color_rng=None):
    """Emit triangles into a SceneBuilder following mesh.h:67-145.

    Texture maps are cached per filename like material_map_handler
    (mesh.h:9-27); a missing/undecodable map becomes the cyan fallback
    texture.  Returns the number of triangles added.
    """
    rng = rand_color_rng or builder.rand

    tex_cache = {}

    def image_tex(map_name: str) -> int:
        if map_name not in tex_cache:
            img = imageio.load_image(mesh.work_dir / map_name)
            tex_cache[map_name] = builder.image_texture(img)
        return tex_cache[map_name]

    mat_cache = {}

    def material_for(mid: int, tri_idx: int) -> tuple:
        """Returns (material_id, textured: bool)."""
        if mid >= 0 and mid < len(mesh.materials):
            m = mesh.materials[mid]
            if m.map_kd:
                if ("tex", mid) not in mat_cache:
                    mat_cache[("tex", mid)] = builder.lambertian(texture=image_tex(m.map_kd))
                return mat_cache[("tex", mid)], True
            if ("flat", mid) not in mat_cache:
                ka, kd = np.asarray(m.ka), np.asarray(m.kd)
                mat_cache[("flat", mid)] = builder.lambertian(color=tuple(ka + kd))
            return mat_cache[("flat", mid)], False
        # No materials: per-triangle random lambertian (mesh.h:132-138).
        return builder.lambertian(color=tuple(rng.uniform(0, 1, 3))), False

    for i in range(mesh.num_triangles):
        mat, textured = material_for(int(mesh.tri_mat[i]), i)
        uvs = mesh.tri_uv[i] if textured else None
        builder.triangle(
            mesh.tri_pos[i, 0], mesh.tri_pos[i, 1], mesh.tri_pos[i, 2],
            material=mat, uvs=uvs,
        )
    return mesh.num_triangles
