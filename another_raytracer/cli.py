"""Command-line renderer.

The reference's CLI is one unvalidated integer scene index with everything
else compile-time constant (main.cpp:17-59).  Here every knob is a flag.

    python -m another_raytracer.cli --scene 6 --width 720 --height 540 \
        --spp 100 --max-depth 50 --mode single --out output.png
"""

from __future__ import annotations

import argparse
import sys
import time

from another_raytracer.config import RenderConfig, RenderMode
from another_raytracer.models import library
from another_raytracer.ops import camera as camera_lib
from another_raytracer.ops import render as render_lib
from another_raytracer.utils import imageio


def main(argv=None):
    p = argparse.ArgumentParser(description="JAX path tracer for the GPU")
    p.add_argument("--scene", type=int, default=9,
                   help="scene alias 1..9 (default 9 = mesh, matching main.cpp:20)")
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--spp", type=int, default=100)
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--samples-per-pass", type=int, default=1)
    p.add_argument("--mode", choices=[m.value for m in RenderMode],
                   default=RenderMode.ADAPTIVE.value,
                   help="render mode (default adaptive, matching main.cpp:44)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="output.png")
    p.add_argument("--scene-seed", type=int, default=1234)
    p.add_argument("--obj", default=None, metavar="PATH",
                   help="mesh scene (9): render this .obj instead of the "
                        "capsule (e.g. the reference's models/cow.obj or "
                        "models/dino.obj; ressources.h.in:7-9)")
    p.add_argument("--preview", default=None, metavar="PNG",
                   help="write a live progress snapshot PNG between passes "
                        "(headless equivalent of the reference's dynamic_gui)")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="persist/resume render state (exact resume via "
                        "counter-based RNG)")
    p.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace of the render")
    p.add_argument("--live", type=int, default=None, metavar="PORT", nargs="?",
                   const=0,
                   help="serve a live progress view over HTTP while rendering "
                        "(0/omitted value = pick a free port; analog of the "
                        "reference's dynamic_gui window, gui.cpp:25-58)")
    p.add_argument("--view", action="store_true",
                   help="after rendering, keep serving the final frame over "
                        "HTTP until ^C (analog of the blocking gui::display, "
                        "gui.cpp:13-23 / main.cpp:55)")
    args = p.parse_args(argv)

    from another_raytracer.utils import compcache

    compcache.enable()

    cfg = RenderConfig(
        width=args.width, height=args.height, samples_per_pixel=args.spp,
        max_depth=args.max_depth, seed=args.seed,
        samples_per_pass=args.samples_per_pass, mode=RenderMode(args.mode),
    )
    if args.obj is not None and args.scene == library.SceneAlias.MESH.value:
        scene, cam_params = library.mesh_scene(seed=args.scene_seed, obj_path=args.obj)
    else:
        scene, cam_params = library.build(args.scene, seed=args.scene_seed)
    cam = camera_lib.make_camera(aspect_ratio=cfg.aspect_ratio, **cam_params)

    print(f"rendering scene {args.scene} at {cfg.width}x{cfg.height} "
          f"spp={cfg.samples_per_pixel} depth={cfg.max_depth} mode={cfg.mode.value}")

    viewer = None
    if args.live is not None or args.view:
        from another_raytracer.utils.liveview import LiveViewer

        viewer = LiveViewer(port=args.live or 0)
        viewer.start()
        print(f"live view at {viewer.url}")

    def do_render():
        """Compose render mode x progress/checkpoint sinks.

        The render MODE always stays what --mode says (the reference's
        adaptive default shows live progress too, engine.h:307):
          * adaptive + live/preview -> per-level streaming of the work frame;
          * single + live/preview/checkpoint -> per-pass progressive loop
            (utils/preview.render_progressive, supports exact resume);
          * unsupported combinations fail loudly instead of silently
            switching strategy (a silent mode change alters the image:
            adaptive interpolates, single doesn't).
        """
        if args.preview or args.checkpoint or args.live is not None:
            from another_raytracer.utils import preview as preview_lib

            prev = (preview_lib.ProgressivePreview(
                        args.preview, cfg.width, cfg.height, viewer=viewer)
                    if args.preview or args.live is not None else None)
            ckpt = preview_lib.RenderCheckpoint(args.checkpoint) if args.checkpoint else None
            if cfg.mode == RenderMode.SINGLE:
                return preview_lib.render_progressive(scene, cam, cfg, prev, ckpt)
            if ckpt is not None:
                p.error(f"--checkpoint requires --mode single "
                        f"(mode {cfg.mode.value} has no pass-resume stream)")
            return render_lib.render(scene, cam, cfg, progress=prev)
        return render_lib.render(scene, cam, cfg)

    t0 = time.time()
    if args.profile_dir:
        from another_raytracer.utils import profiling

        with profiling.trace(args.profile_dir):
            img, stats = do_render()
    else:
        img, stats = do_render()
    elapsed = time.time() - t0
    segments = stats.get("segments", 0)
    # Honest rays/s: actual traced ray segments including bounces — unlike
    # the reference's nominal primary-only kRay/s (main.cpp:50-53).
    print(f"finished in {elapsed*1000:.0f} ms "
          f"({segments/elapsed/1e6:.2f} Mrays/s, {segments} segments)")
    imageio.save_png(args.out, img)
    print(f"wrote {args.out}")
    if args.view:
        viewer.update(img)
        print(f"serving final frame at {viewer.url} (^C to exit)")
        viewer.serve_forever()
    elif viewer is not None:
        viewer.update(img)
        viewer.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
