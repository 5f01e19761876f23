"""Two-process jax.distributed rendering on localhost (round-1 VERDICT #6:
parallel/multihost.py was untested glue).

Spawns two worker processes, each with 2 virtual CPU devices, joined by
jax.distributed into a 4-device global mesh; pixels shard across the process
boundary.  Asserts both processes produce the same full framebuffer and that
it is bit-identical to a single-process render of the same scene/config —
the counter-based RNG makes every partition equivalent.
"""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "scripts" / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_render(tmp_path):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), "2", str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=540)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

    r0 = np.load(tmp_path / "radiance_p0.npy")
    r1 = np.load(tmp_path / "radiance_p1.npy")
    np.testing.assert_array_equal(r0, r1)

    # Single-process reference on this process's 8-device mesh: radiance must
    # be bit-identical regardless of process/device partitioning.
    import jax.numpy as jnp

    from another_raytracer.ops import render as render_lib
    from another_raytracer.ops import vec3
    W, H, SPP, DEPTH = 24, 12, 4, 3  # must match multihost_worker.py
    from another_raytracer.models.scene import SceneBuilder
    from another_raytracer.ops import camera as camera_lib

    b = SceneBuilder(background=(0.6, 0.7, 0.9), seed=4)
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.4, 0.7, 0.3)))
    b.sphere((0, 0, -1), 0.5, b.metal((0.8, 0.8, 0.8), 0.1))
    scene = b.build()
    cam = camera_lib.make_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -1),
                                 vfov=60, aspect_ratio=W / H)
    acc, _ = render_lib.render_radiance(
        scene, cam, jnp.uint32(7), width=W, height=H, spp=SPP,
        samples_per_pass=2, max_depth=DEPTH, t_min=1e-3)
    ref = vec3.to_numpy(acc)
    np.testing.assert_array_equal(r0, ref.astype(r0.dtype))
