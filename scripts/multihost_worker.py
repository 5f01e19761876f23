"""Worker for the two-process jax.distributed localhost test (and a template
for real multi-host pod runs).

Each process owns 2 virtual CPU devices; jax.distributed stitches them into
one 4-device global mesh.  The render is the SAME render_radiance_sharded as
single-host (parallel/sharding.py): pixels shard over 'tile' across hosts
(collectives ride the distributed backend), samples over 'spp'.  The full
radiance is allgathered to every process and written to ``outdir``; the test
asserts process outputs are identical to each other and to a single-process
render.

Usage: python scripts/multihost_worker.py <process_id> <num_processes> <port> <outdir>
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DEVICES_PER_PROC = 2
W, H, SPP, DEPTH = 24, 12, 4, 3


def main():
    pid, nproc, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEVICES_PER_PROC}")
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from another_raytracer.parallel import multihost

    # Initialize BEFORE importing render modules: anything that touches a
    # backend pins the process-local device view.
    idx, cnt = multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
        process_id=pid)

    from another_raytracer.parallel import sharding
    assert (idx, cnt) == (pid, nproc), (idx, cnt)
    n_global = len(jax.devices())
    assert n_global == DEVICES_PER_PROC * nproc, n_global

    from another_raytracer.models.scene import SceneBuilder
    from another_raytracer.ops import camera as camera_lib

    b = SceneBuilder(background=(0.6, 0.7, 0.9), seed=4)
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.4, 0.7, 0.3)))
    b.sphere((0, 0, -1), 0.5, b.metal((0.8, 0.8, 0.8), 0.1))
    scene = b.build()
    cam = camera_lib.make_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -1),
                                 vfov=60, aspect_ratio=W / H)

    # numpy (uncommitted) inputs are replicated across the global mesh; all
    # processes pass identical values.
    scene_np = jax.tree.map(np.asarray, scene)
    cam_np = jax.tree.map(np.asarray, cam)

    mesh = sharding.hybrid_mesh(n_global // 2, 2)  # tile spans hosts
    acc, segs = sharding.render_radiance_sharded(
        scene_np, cam_np, np.uint32(7), mesh=mesh, width=W, height=H,
        spp=SPP, samples_per_pass=2, max_depth=DEPTH, t_min=1e-3)

    from jax.experimental import multihost_utils

    # acc is a V3 of global arrays (each host holds only its shards);
    # allgather materializes the full components everywhere.
    full = np.stack(
        [np.asarray(c) for c in multihost_utils.process_allgather(acc, tiled=True)],
        axis=-1,
    )
    # segs is replicated (out_spec P()): read the local shard.
    segs = int(np.asarray(segs.addressable_data(0)))
    outdir.mkdir(parents=True, exist_ok=True)
    np.save(outdir / f"radiance_p{pid}.npy", full)
    (outdir / f"done_p{pid}").write_text(f"segments={segs} mesh={dict(mesh.shape)}\n")
    print(f"proc {pid}/{nproc}: {n_global} global devices, "
          f"mesh={dict(mesh.shape)}, segments={segs}")


if __name__ == "__main__":
    main()
