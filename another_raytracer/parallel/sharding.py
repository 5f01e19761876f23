"""Multi-device rendering over a ``jax.sharding.Mesh``.

The reference's entire parallel runtime is a 4-thread pool with atomics and a
condvar barrier (src/utils/threadpool.h; SURVEY §2.5).  Its two data-parallel
strategies map 1:1 onto device-mesh shardings:

  * ``parallel_stripes`` (engine.h:335-376): image rows split into stripes,
    one per worker  ->  pixel axis sharded over the mesh ('tile' axis); each
    device renders its pixels at full spp; the framebuffer is assembled by
    the output sharding (XLA all_gather where needed).
  * ``parallel_images`` (engine.h:378-445): each worker renders the full
    image at spp/4 into a linear accumulator, then a manual per-pixel sum
    -> sample range sharded over the mesh ('spp' axis) + ``jax.lax.psum``
    over ICI; the linear-sum-then-gamma order is preserved (write_color_raw
    then one write_color, engine.h:401,437).

Because the RNG is counter-based on absolute (pixel, sample) ids, every
sharding produces bit-identical radiance to the single-device render — the
property tested in tests/test_sharding.py (the reference, by contrast, gives
different noise per mode because its threads race on one mt19937).

Hybrid 2D meshes ('tile' × 'spp') compose both axes; ``hybrid_mesh`` builds
one from the available devices.  On a real pod slice the same code spans
hosts: ``jax.distributed.initialize`` + the global device list, with scene
arrays replicated and only pixel/sample axes sharded.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from another_raytracer.config import RenderConfig, RenderMode
from another_raytracer.ops import color as color_lib
from another_raytracer.ops import render as render_lib


def hybrid_mesh(n_tile: int = None, n_spp: int = None, devices=None) -> Mesh:
    """A ('tile', 'spp') mesh over the available devices.  Defaults to all
    devices on the tile axis (stripes) and 1 on the spp axis."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_tile is None and n_spp is None:
        n_tile, n_spp = n, 1
    elif n_tile is None:
        n_tile = n // n_spp
    elif n_spp is None:
        n_spp = n // n_tile
    assert n_tile * n_spp <= n, (n_tile, n_spp, n)
    devs = np.asarray(devices[: n_tile * n_spp]).reshape(n_tile, n_spp)
    return Mesh(devs, ("tile", "spp"))


def _pad_to(x, multiple):
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        x = jnp.concatenate([x, x[:rem]])
    return x, n


@partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "spp", "samples_per_pass",
                     "max_depth", "t_min", "differentiable"),
)
def render_radiance_sharded(scene, cam, seed, *, mesh: Mesh, width, height,
                            spp, samples_per_pass, max_depth, t_min,
                            differentiable=False):
    """Hybrid-sharded radiance: pixels over 'tile', samples over 'spp',
    psum over 'spp'.  Returns (radiance V3 of [H*W], segments int32).

    With mesh shape (N,1) this is parallel_stripes; with (1,N) it is
    parallel_images; rectangular meshes compose both.
    """
    n_tile = mesh.shape["tile"]
    n_spp = mesh.shape["spp"]
    n_pixels = width * height

    # Morton pixel order: each tile shard gets a compact spatial region and
    # ray packets stay coherent (see render.morton_order).
    order, inv = render_lib.morton_order(width, height)
    pixel_ids, real_n = _pad_to(jnp.asarray(order), n_tile)
    spp_local = -(-spp // n_spp)

    def shard_fn(scene, cam, seed, pix_local):
        tile_idx = jax.lax.axis_index("tile")  # noqa: F841  (pixels pre-sharded)
        spp_idx = jax.lax.axis_index("spp")
        acc, segs = render_lib.radiance_batch(
            scene, cam, pix_local, seed, width=width, height=height,
            sample_start=(spp_idx * spp_local).astype(jnp.uint32),
            n_samples=spp_local, spp_cap=spp,
            samples_per_pass=samples_per_pass, max_depth=max_depth,
            t_min=t_min, differentiable=differentiable,
        )
        # parallel_images reduction: sum linear partials over the spp axis
        # (the vectorized engine.h:424-440), then gather tiles.
        acc = jax.lax.psum(acc, "spp")
        segs = jax.lax.psum(segs, ("tile", "spp"))
        return acc, segs

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("tile")),
        out_specs=(P("tile"), P()),
        # Varying-axes checking stays ON: integrator.trace derives its loop
        # carry from the varying ray directions, so the types line up and the
        # checker can catch real sharding bugs.
        check_vma=True,
    )
    acc, segs = fn(scene, cam, seed, pixel_ids)
    inv_j = jnp.asarray(inv)
    return acc.map(lambda c: c[:real_n][inv_j]), segs


def render_sharded(scene, cam, config: RenderConfig, mesh: Mesh = None):
    """Mode-dispatched device-parallel render -> (uint8 image, stats)."""
    if mesh is None:
        n = len(jax.devices())
        if config.mode == RenderMode.PARALLEL_IMAGES:
            mesh = hybrid_mesh(1, n)
        else:
            mesh = hybrid_mesh(n, 1)
    acc, segments = render_radiance_sharded(
        scene, cam, jnp.uint32(config.seed), mesh=mesh,
        width=config.width, height=config.height, spp=config.samples_per_pixel,
        samples_per_pass=config.samples_per_pass, max_depth=config.max_depth,
        t_min=config.t_min,
    )
    from another_raytracer.ops import vec3

    img = np.asarray(color_lib.to_uint8(vec3.to_numpy(acc), config.samples_per_pixel))
    img = img.reshape(config.height, config.width, 3)
    return img, {"segments": int(segments), "mesh": dict(mesh.shape)}
