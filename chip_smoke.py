"""End-to-end check of the path tracer on one NVIDIA GPU.

    python chip_smoke.py                 # phases 1-3 on one card
    python chip_smoke.py --four-cards    # the multi-card phase only (4 GPUs)
    python chip_smoke.py --block-sweep   # megakernel block sizes only

Everything runs in this one process.  Phases:

1. device  — platform, kind, count, card name and power limit, JAX version.
2. parity  — at real width against the plain XLA reference: the Triton
   megakernel vs integrator.trace_regenerative on the Cornell box and on a
   lens/motion/metal/dielectric/checker scene (360x270, spp 16, depth 8),
   and the fused fwd+bwd vs XLA autodiff on the Cornell box (loss,
   d/d tex_ca, d/d background).
3. main    — the CLI renders scene 6 at 720x540 spp 100 depth 50 adaptive;
   scenes 1 (sphere BVH) and 3 (Perlin) render at 720x540 spp 16 depth 50;
   diff.make_train_step takes 5 adam steps; bench.py's step runs; the
   step's memory analysis and peak device memory; then kernel against XLA
   in turns (megakernel vs XLA wavefront on the Cornell forward, fused vs
   autodiff on the Cornell fwd+bwd).

Each result is one JSON line carrying the card's name and power limit.  Any
failure exits non-zero and the final line is not printed; on success the
final line is exactly
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Exits non-zero without a result when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

CARD = None
FAILURES = []


def report(phase, **fields):
    print(json.dumps({"phase": phase, **fields, "card": CARD}, default=str),
          flush=True)


def check(phase, cond, **fields):
    """Report a named check; a false condition fails the run at the end."""
    report(phase, ok=bool(cond), **fields)
    if not cond:
        FAILURES.append(phase)


def timed(fn, *args):
    """(result, seconds) of fn(*args), waiting for the device."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def run_phase(name, fn, *args):
    try:
        fn(*args)
    except Exception:  # a failed phase is reported and fails the run
        traceback.print_exc()
        report(name, ok=False, error=traceback.format_exc(limit=3)[-2000:])
        FAILURES.append(name)


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def phase_device():
    from another_raytracer.utils import profiling

    info = profiling.device_info()
    print(f"card: {info['card']}", flush=True)
    report("device", jax=jax.__version__, platform=info["platform"],
           kind=info["kind"], count=info["count"])


# ---------------------------------------------------------------------------
# Phase 2: parity at real width
# ---------------------------------------------------------------------------

PW, PH, PSPP, PDEPTH = 360, 270, 16, 8


def _mixed_scene():
    """tests/test_mega.py's lens/motion/metal/dielectric/checker scene."""
    from another_raytracer.models.scene import SceneBuilder

    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -100.5, -1), 100,
             b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9))))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.moving_sphere((0, 0.8, -1), (0, 1.0, -1), 0, 1, 0.2,
                    b.lambertian(color=(0.9, 0.2, 0.2)))
    cam = dict(lookfrom=(0, 0.5, 1.5), lookat=(0, 0, -1), vfov=60.0,
               aperture=0.1, focus_dist=2.5, time0=0.0, time1=1.0)
    return b.build(), cam


def forward_fns(scene, cam, width, height, spp, depth):
    """Jitted (megakernel, XLA wavefront) forwards over one lane per pixel,
    each lane tracing samples [0, spp) — render_radiance's layout."""
    from another_raytracer.ops import integrator
    from another_raytracer.ops.pallas import mega_kernel

    pix = jnp.arange(width * height, dtype=jnp.uint32)
    samp0 = jnp.zeros_like(pix)
    kw = dict(width=width, height=height, sample_stride=1, sample_end=spp,
              spp_cap=spp, max_depth=depth, t_min=1e-3)

    def make(fn, **extra):
        return jax.jit(lambda s, c: fn(s, c, pix, samp0, jnp.uint32(3),
                                       **kw, **extra))

    return (make(mega_kernel.trace_regenerative_mega),
            make(integrator.trace_regenerative))


def _parity_forward(name, scene, cam_params):
    from another_raytracer.ops import camera as camera_lib
    from another_raytracer.ops import vec3

    cam = camera_lib.make_camera(aspect_ratio=PW / PH, **cam_params)
    mega, xla = forward_fns(scene, cam, PW, PH, PSPP, PDEPTH)
    (got, gs), t_mega = timed(mega, scene, cam)
    (ref, rs), t_xla = timed(xla, scene, cam)
    got, ref = vec3.to_numpy(got), vec3.to_numpy(ref)
    gs, rs = int(gs), int(rs)
    diff = np.abs(got - ref)
    frac_bad = float((diff > 2e-2).mean())
    med = float(np.median(diff))
    # tests/test_mega.py::_check
    ok = (abs(gs - rs) <= max(4, 0.01 * rs) and frac_bad <= 0.02
          and med < 1e-5 and np.isfinite(got).all())
    check(f"parity_forward_{name}", ok, shape=f"{PW}x{PH} spp{PSPP} "
          f"depth{PDEPTH}", segments_kernel=gs, segments_xla=rs,
          frac_over_2em2=frac_bad, median_abs_diff=med,
          max_abs_diff=float(diff.max()), first_call_kernel_s=t_mega,
          first_call_xla_s=t_xla)


def loss_and_grads(scene, cam, target, fused: bool, width, height, spp,
                   depth):
    """Jitted (loss, (d/d tex_ca, d/d background)) of diff.render_loss,
    with the fused path forced on or off."""
    from another_raytracer.grad import diff
    from another_raytracer.ops import render as render_lib
    from another_raytracer.ops.pallas import mega_diff

    mega_diff.FUSED_DIFF = fused
    render_lib.clear_trace_caches()
    params = {"tex_ca": scene.tex_ca, "background": scene.background}
    fn = jax.jit(lambda p: jax.value_and_grad(diff.render_loss)(
        p, scene, cam, target, jnp.uint32(5), width=width, height=height,
        spp=spp, samples_per_pass=1, max_depth=depth, t_min=1e-3))
    fn = fn.lower(params).compile()  # trace now, while the switch is set
    mega_diff.FUSED_DIFF = None
    return lambda: fn(params)


def phase_parity():
    from another_raytracer.models import library
    from another_raytracer.ops import camera as camera_lib

    scene, cam_params = library.cornell_box()
    _parity_forward("cornell", scene, cam_params)
    _parity_forward("mixed", *_mixed_scene())

    cam = camera_lib.make_camera(aspect_ratio=PW / PH, **cam_params)
    target = jnp.asarray(np.random.default_rng(0).uniform(
        0.0, 1.0, (PW * PH, 3)), jnp.float32)
    t0 = time.perf_counter()
    fused = loss_and_grads(scene, cam, target, True, PW, PH, PSPP, PDEPTH)
    t_fused = time.perf_counter() - t0
    t0 = time.perf_counter()
    auto = loss_and_grads(scene, cam, target, False, PW, PH, PSPP, PDEPTH)
    t_auto = time.perf_counter() - t0
    (v_f, g_f), (v_a, g_a) = jax.block_until_ready((fused(), auto()))
    v_f, v_a = float(v_f), float(v_a)
    gca_f, gca_a = np.asarray(g_f["tex_ca"]), np.asarray(g_a["tex_ca"])
    gbg_f, gbg_a = np.asarray(g_f["background"]), np.asarray(g_a["background"])
    sca = float(np.abs(gca_a).max())
    sbg = float(max(1e-9, np.abs(gbg_a).max()))
    gaps = dict(loss_rel_gap=abs(v_f - v_a) / abs(v_a),
                tex_ca_gap=float(np.max(np.abs(gca_f - gca_a)
                                        / (sca + np.abs(gca_a)))),
                background_gap=float(np.max(np.abs(gbg_f - gbg_a)
                                            / (sbg + np.abs(gbg_a)))))
    # tests/test_mega_diff.py::test_grads_match_autodiff holds the two to
    # 1e-5 (loss) and 2e-4 (grads); those hold on the card at test size.
    # At this size the two primals (Triton kernel, XLA scan) take different
    # discrete decisions on ~0.1% of lanes, each an O(1) change of that
    # lane's radiance, so sums over all lanes may differ by ~1e-3 of their
    # scale: the card check allows 1e-4 (loss) and 2e-3 (grads).  PERF.md
    # records the measured gaps.
    tight = (gaps["loss_rel_gap"] <= 1e-5 and gaps["tex_ca_gap"] <= 2e-4
             and gaps["background_gap"] <= 2e-4)
    ok = (gaps["loss_rel_gap"] <= 1e-4 and gaps["tex_ca_gap"] <= 2e-3
          and gaps["background_gap"] <= 2e-3 and sca > 0)
    check("parity_fused_vs_autodiff", ok,
          shape=f"{PW}x{PH} spp{PSPP} depth{PDEPTH}", loss_fused=v_f,
          loss_autodiff=v_a, within_test_tolerance=tight,
          compile_fused_s=t_fused, compile_autodiff_s=t_auto, **gaps)


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

W, H = 720, 540


def _render_scene(alias, spp, depth, mode):
    from another_raytracer.config import RenderConfig, RenderMode
    from another_raytracer.models import library
    from another_raytracer.ops import camera as camera_lib
    from another_raytracer.ops import render as render_lib

    scene, cam_params = library.build(alias)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       max_depth=depth, mode=RenderMode(mode))
    cam = camera_lib.make_camera(aspect_ratio=cfg.aspect_ratio, **cam_params)
    (img, stats), t_first = timed(render_lib.render, scene, cam, cfg)
    (img2, stats2), t_warm = timed(render_lib.render, scene, cam, cfg)
    segs = stats2["segments"]
    check(f"render_scene{alias}",
          img.shape == (H, W, 3) and img.max() > 0 and segs > 0
          and np.array_equal(img, img2),
          shape=f"{W}x{H} spp{spp} depth{depth} {mode}",
          compile_and_first_s=t_first, warm_s=t_warm,
          setup_s=t_first - t_warm, segments=segs,
          mrays_per_s=segs / t_warm / 1e6, mean_pixel=float(img.mean()))


def phase_main():
    import os
    import tempfile

    from another_raytracer import cli
    from another_raytracer.grad import diff
    from another_raytracer.models import library
    from another_raytracer.ops import camera as camera_lib

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.png")
        argv = ["--scene", "6", "--width", str(W), "--height", str(H),
                "--spp", "100", "--max-depth", "50", "--mode", "adaptive",
                "--out", out]
        rc1, t_first = timed(cli.main, argv)
        rc2, t_warm = timed(cli.main, argv)
        from another_raytracer.utils import imageio

        img = imageio.load_image(out)
        check("cli_scene6_adaptive",
              rc1 == 0 and rc2 == 0 and img is not None
              and img.shape == (H, W, 3) and img.max() > 0,
              shape=f"{W}x{H} spp100 depth50 adaptive",
              compile_and_first_s=t_first, warm_s=t_warm,
              setup_s=t_first - t_warm)

    _render_scene(1, 16, 50, "single")
    _render_scene(3, 16, 50, "single")

    # Training: 5 adam steps at the phase-2 size.
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=PW / PH, **cam_params)
    target = jnp.asarray(np.random.default_rng(1).uniform(
        0.0, 1.0, (PW * PH, 3)), jnp.float32)
    state0, step = diff.make_train_step(
        scene, cam, target, width=PW, height=PH, spp=PSPP,
        samples_per_pass=1, max_depth=PDEPTH)
    compiled = step.lower(state0, jnp.uint32(0)).compile()
    mem = compiled.memory_analysis()
    state, losses, times = state0, [], []
    for i in range(5):
        (state, loss), dt = timed(step, state, jnp.uint32(i))
        losses.append(float(loss))
        times.append(dt)
    moved = {k: float(jnp.abs(state.params[k] - state0.params[k]).max())
             for k in ("tex_ca", "background")}
    stats = jax.devices()[0].memory_stats() or {}
    check("train_5_adam_steps",
          all(np.isfinite(losses)) and moved["tex_ca"] > 0,
          shape=f"{PW}x{PH} spp{PSPP} depth{PDEPTH}", losses=losses,
          step_s=times, param_max_update=moved,
          temp_bytes=getattr(mem, "temp_size_in_bytes", None),
          argument_bytes=getattr(mem, "argument_size_in_bytes", None),
          output_bytes=getattr(mem, "output_size_in_bytes", None),
          peak_bytes_in_use=stats.get("peak_bytes_in_use"))

    import bench

    rec = bench.run(iters=10, prof_iters=3)
    check("bench_step", np.isfinite(rec["value"]) and rec["value"] > 0,
          **{k: v for k, v in rec.items() if k != "device"})


def phase_timing():
    """Kernel against XLA, in turns in this process (XLA, kernel, kernel,
    XLA), at the phase-3 sizes."""
    from another_raytracer.models import library
    from another_raytracer.ops import camera as camera_lib

    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    mega, xla = forward_fns(scene, cam, W, H, 100, 50)
    fns = {"kernel": mega, "xla": xla}
    for f in fns.values():  # compile + warm
        jax.block_until_ready(f(scene, cam))
    ms = {"kernel": [], "xla": []}
    for name in ("xla", "kernel", "kernel", "xla"):
        _, dt = timed(fns[name], scene, cam)
        ms[name].append(dt * 1e3)
    report("timing_forward", shape=f"{W}x{H} spp100 depth50 single",
           kernel_ms=ms["kernel"], xla_ms=ms["xla"],
           speedup=float(np.mean(ms["xla"]) / np.mean(ms["kernel"])))

    cam = camera_lib.make_camera(aspect_ratio=PW / PH, **cam_params)
    target = jnp.zeros((PW * PH, 3), jnp.float32)
    fns = {"fused": loss_and_grads(scene, cam, target, True, PW, PH, PSPP,
                                   PDEPTH),
           "autodiff": loss_and_grads(scene, cam, target, False, PW, PH,
                                      PSPP, PDEPTH)}
    for f in fns.values():
        jax.block_until_ready(f())
    ms = {"fused": [], "autodiff": []}
    for name in ("autodiff", "fused", "fused", "autodiff"):
        _, dt = timed(fns[name])
        ms[name].append(dt * 1e3)
    report("timing_fwd_bwd", shape=f"{PW}x{PH} spp{PSPP} depth{PDEPTH}",
           fused_ms=ms["fused"], autodiff_ms=ms["autodiff"],
           speedup=float(np.mean(ms["autodiff"]) / np.mean(ms["fused"])))


def phase_block_sweep():
    """Megakernel block sizes on the Cornell forward (phase-3 size)."""
    import functools

    from another_raytracer.models import library
    from another_raytracer.ops import camera as camera_lib
    from another_raytracer.ops.pallas import mega_kernel

    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=100,
              spp_cap=100, max_depth=50, t_min=1e-3)
    fns = {}
    for block in (32, 64, 128, 256, 512):
        fn = functools.partial(mega_kernel.trace_regenerative_mega,
                               block=block, **kw)
        fns[block] = jax.jit(lambda s, c, fn=fn: fn(
            s, c, pix, pix * 0, jnp.uint32(3)))
        jax.block_until_ready(fns[block](scene, cam))
    ms = {b: [] for b in fns}
    for order in (list(fns), list(fns)[::-1]):
        for b in order:
            _, dt = timed(fns[b], scene, cam)
            ms[b].append(dt * 1e3)
    report("block_sweep", shape=f"{W}x{H} spp100 depth50", ms=ms,
           default=mega_kernel.DEFAULT_BLOCK)


# ---------------------------------------------------------------------------
# Phase 4: four cards
# ---------------------------------------------------------------------------


def phase_four_cards():
    import __graft_entry__
    from another_raytracer.config import RenderConfig, RenderMode
    from another_raytracer.models import library
    from another_raytracer.ops import adaptive
    from another_raytracer.ops import camera as camera_lib
    from another_raytracer.parallel import sharding

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devices)}")
    scene, cam_params = library.cornell_box()
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=100,
                       max_depth=50, mode=RenderMode.ADAPTIVE)
    cam = camera_lib.make_camera(aspect_ratio=cfg.aspect_ratio, **cam_params)
    one = sharding.hybrid_mesh(1, 1, devices=devices[:1])
    four_tile = sharding.hybrid_mesh(4, 1, devices=devices[:4])
    four_spp = sharding.hybrid_mesh(1, 4, devices=devices[:4])

    # adaptive: image and segment count, 4-card tile mesh vs one card
    (img1, st1), t1 = timed(adaptive.render_adaptive, scene, cam, cfg, one)
    (img4, st4), t4 = timed(adaptive.render_adaptive, scene, cam, cfg,
                            four_tile)
    _, w1 = timed(adaptive.render_adaptive, scene, cam, cfg, one)
    _, w4 = timed(adaptive.render_adaptive, scene, cam, cfg, four_tile)
    check("four_cards_adaptive",
          np.array_equal(img1, img4) and st1["segments"] == st4["segments"],
          shape=f"{W}x{H} spp100 depth50", segments_1=st1["segments"],
          segments_4=st4["segments"], first_call_1_s=t1, first_call_4_s=t4,
          warm_1_s=w1, warm_4_s=w4,
          pixels_differing=int((img1 != img4).any(-1).sum()))

    kw = dict(width=W, height=H, spp=100, samples_per_pass=1, max_depth=50,
              t_min=1e-3)
    from another_raytracer.ops import vec3

    def sharded(mesh):
        return sharding.render_radiance_sharded(
            scene, cam, jnp.uint32(0), mesh=mesh, **kw)

    (r1, s1), _ = timed(sharded, one)
    _, w1 = timed(sharded, one)
    r1 = vec3.to_numpy(r1)
    for mode, mesh in (("parallel_stripes", four_tile),
                       ("parallel_images", four_spp)):
        (r4, s4), dt = timed(sharded, mesh)
        _, w4 = timed(sharded, mesh)
        r4 = vec3.to_numpy(r4)
        # tests/test_sharding.py tolerance
        close = np.allclose(r4, r1, rtol=1e-5, atol=1e-5)
        check(f"four_cards_{mode}", close and int(s4) == int(s1),
              shape=f"{W}x{H} spp100 depth50", mesh=dict(mesh.shape),
              segments_1=int(s1), segments_4=int(s4),
              max_abs_diff=float(np.abs(r4 - r1).max()), first_call_s=dt,
              warm_1_s=w1, warm_4_s=w4)

    res1 = __graft_entry__.dryrun_multichip(1, PW, PH, PSPP, PDEPTH)
    res4 = __graft_entry__.dryrun_multichip(4, PW, PH, PSPP, PDEPTH)
    ok = all(np.isclose(res4[k], res1[k], rtol=1e-5) for k in
             ("loss", "bvh_loss"))
    check("four_cards_train_step", ok, shape=f"{PW}x{PH} spp{PSPP} "
          f"depth{PDEPTH}", one_card=res1, four_cards=res4)


def main(argv=None):
    global CARD
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-GPU phase (and its 1-card comparison)")
    p.add_argument("--block-sweep", action="store_true",
                   help="run only the megakernel block-size sweep")
    args = p.parse_args(argv)

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"error: chip_smoke.py needs a GPU, JAX found {platform!r}",
              file=sys.stderr)
        return 2

    from another_raytracer.utils import compcache, profiling

    compcache.enable()
    CARD = profiling.card_info()
    phases = {"device": phase_device, "parity": phase_parity,
              "main": phase_main, "timing": phase_timing}
    if args.four_cards:
        todo = ["device", "four_cards"]
        phases["four_cards"] = phase_four_cards
    elif args.block_sweep:
        todo = ["device", "block_sweep"]
        phases["block_sweep"] = phase_block_sweep
    else:
        todo = list(phases)
    for name in todo:
        t0 = time.perf_counter()
        run_phase(name, phases[name])
        report(f"{name}_done", seconds=time.perf_counter() - t0)
    if FAILURES:
        print(f"FAILED: {FAILURES}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
