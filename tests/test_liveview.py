"""Live HTTP viewer: the headless analog of the reference's dynamic_gui
(gui.cpp:25-58) — page, frame endpoint, status, and integration with
ProgressivePreview."""

import json
import urllib.request

import numpy as np

from another_raytracer.utils.liveview import LiveViewer


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read(), r.headers.get("Content-Type")


def test_viewer_serves_page_frame_and_status():
    v = LiveViewer(port=0)
    port = v.start()
    try:
        assert port > 0
        img = np.zeros((4, 6, 3), np.uint8)
        img[..., 0] = 123
        v.update(img, samples_done=7)

        page, ctype = _get(v.url)
        assert ctype.startswith("text/html") and b"frame.png" in page

        png, ctype = _get(v.url + "frame.png")
        assert ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n"
        from another_raytracer.utils import imageio

        assert png == imageio._encode_png(img)

        status, ctype = _get(v.url + "status")
        s = json.loads(status)
        assert s == {"updates": 1, "samples_done": 7}

        # frame updates replace the served bytes
        v.update(img * 0 + 9, samples_done=9)
        png2, _ = _get(v.url + "frame.png")
        assert png2 != png
    finally:
        v.stop()


def test_progressive_preview_pushes_to_viewer(tmp_path):
    import jax.numpy as jnp

    from another_raytracer.config import RenderConfig
    from another_raytracer.models.scene import SceneBuilder
    from another_raytracer.ops import camera as camera_lib
    from another_raytracer.utils import preview as preview_lib

    W, H = 24, 12
    b = SceneBuilder(background=(0.6, 0.7, 0.9), seed=4)
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.4, 0.7, 0.3)))
    scene = b.build()
    cam = camera_lib.make_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -1),
                                 vfov=60, aspect_ratio=W / H)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=4, max_depth=3,
                       samples_per_pass=2, seed=3)

    v = LiveViewer(port=0)
    v.start()
    try:
        # path=None: viewer-only sink, no snapshot files
        prev = preview_lib.ProgressivePreview(None, W, H, viewer=v)
        img, _ = preview_lib.render_progressive(scene, cam, cfg, prev, None)
        status, _ = _get(v.url + "status")
        s = json.loads(status)
        assert s["updates"] == 2  # one per chunk (4 spp / 2 per pass)
        assert s["samples_done"] == 4
        png, _ = _get(v.url + "frame.png")
        from another_raytracer.utils import imageio

        assert png == imageio._encode_png(img)
    finally:
        v.stop()
