"""Multi-host initialization for pod-slice rendering.

The reference has no distributed story at all (single process, 4 threads —
SURVEY §5).  Here multi-host is the same ``shard_map`` code as single-host
(parallel/sharding.py): the mesh simply spans the global device list, scene
arrays are replicated per host, and XLA routes `psum`/gather collectives
over ICI within a slice and DCN across slices.

Usage on each host of a slice:

    from another_raytracer.parallel import multihost, sharding
    multihost.initialize()                     # jax.distributed handshake
    mesh = sharding.hybrid_mesh(n_tile, n_spp) # over jax.devices() (global)
    ...render_radiance_sharded(..., mesh=mesh)

Each host computes its devices' shards; ``host_local_image`` gathers the
full framebuffer to host 0 for writing.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """jax.distributed.initialize with env-var fallback.

    Must run before any JAX computation (backend initialization pins the
    process-local view).  A repeated call is a no-op; any other failure
    propagates — silently degrading to single-process here would make every
    downstream shard_map quietly compute 1/N of the frame.  Exercised by the
    two-process localhost test (tests/test_multihost.py)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already initialized" not in str(e).lower():
            raise
    return jax.process_index(), jax.process_count()


def is_primary() -> bool:
    return jax.process_index() == 0


def host_local_image(global_array):
    """Fetch a (possibly sharded) global array fully to this host."""
    import numpy as np

    return np.asarray(jax.device_get(global_array))
