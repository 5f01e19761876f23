"""Benchmark: Mrays/s, forward + backward, Cornell box, on one GPU.

Prints ONE JSON line:
  {"metric": "cornell_box_fwd_bwd", "value": N, "unit": "Mrays/s", ...,
   "device": {"platform", "kind", "count", "card"}}

Ray counting is honest: actual traced segments including bounce rays
(forward pass), unlike the reference's nominal primary-only kRay/s
(main.cpp:50-53).  The timed region is one full differentiable step:
forward radiance + gradients w.r.t. material/texture parameters.  Besides
the wall time, a profiler trace of a few steps gives the device busy time
per step and the device's idle share (utils/profiling.device_busy).

Exits non-zero unless JAX's first device is a GPU.

    python bench.py
"""

import json
import tempfile
import time

import jax
import jax.numpy as jnp

WIDTH, HEIGHT, SPP, DEPTH = 360, 270, 16, 8


def make_step(width=WIDTH, height=HEIGHT, spp=SPP, depth=DEPTH):
    """(step, args, segments): the jitted loss+grad step on the Cornell box
    and the honest segment count of one forward render."""
    from another_raytracer.grad import diff
    from another_raytracer.models import library
    from another_raytracer.ops import camera as camera_lib
    from another_raytracer.ops import render as render_lib

    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=width / height, **cam_params)
    params, _ = diff.split_params(scene)
    target = jnp.zeros((width * height, 3), jnp.float32)

    _, segments = render_lib.render_radiance(
        scene, cam, jnp.uint32(0), width=width, height=height, spp=spp,
        samples_per_pass=1, max_depth=depth, t_min=1e-3, differentiable=True)
    step = jax.jit(
        lambda p, s, c, t: jax.value_and_grad(diff.render_loss)(
            p, s, c, t, jnp.uint32(0), width=width, height=height, spp=spp,
            samples_per_pass=1, max_depth=depth, t_min=1e-3,
        )
    )
    return step, (params, scene, cam, target), int(segments)


def run(iters=20, prof_iters=5):
    from another_raytracer.utils import compcache, profiling

    profiling.require_gpu()
    compcache.enable()
    step, args, segments = make_step()

    t0 = time.perf_counter()
    jax.block_until_ready(step(*args))
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(step(*args))

    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters

    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir):
            for _ in range(prof_iters):
                out = step(*args)
            jax.block_until_ready(out)
        busy = profiling.device_busy_logdir(logdir)
    device_ms = busy["busy_s"] / prof_iters * 1e3

    return {
        "metric": "cornell_box_fwd_bwd",
        "value": segments / dt / 1e6,
        "unit": "Mrays/s",
        "wall_ms": dt * 1e3,
        "device_busy_ms": device_ms,
        "device_idle_share": busy["idle_share"],
        "first_call_s": compile_s,
        "segments": segments,
        "shape": f"{WIDTH}x{HEIGHT} spp{SPP} depth{DEPTH}",
        "device": profiling.device_info(),
    }


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
