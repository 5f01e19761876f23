"""Differentiable rendering + inverse-rendering training step.

A capability the reference does not have: gradients of pixel radiance with
respect to scene parameters.  Estimator: detached-sampling reparameterization
— every random draw is a counter-based constant w.r.t. parameters, and every
discrete decision (material kind select, dielectric reflect/refract branch,
metal absorption, closest-hit winner, medium acceptance) is a boolean mask
with no gradient; the *selected* branch's arithmetic stays differentiable.
This yields unbiased gradients for shading/texture/material parameters
(albedo texels, fuzz, IOR, emission) and piecewise-correct gradients for
continuous geometry parameters (sphere centers/radii, triangle vertices)
away from visibility discontinuities — edge gradients are biased (no
reparameterized edge sampling), which is documented and tested as such.

The train step is the framework's "flagship model": optimize scene
parameters so the render matches a target image.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from another_raytracer.ops import render as render_lib

# Scene leaves that are trainable by default: everything shading-related.
DEFAULT_TRAINABLE = (
    "tex_ca", "tex_cb", "tex_cc", "mat_fuzz", "mat_ir", "atlas", "background",
)


def split_params(scene, trainable=DEFAULT_TRAINABLE):
    """Split SceneData into (params dict, static scene with zeros in the
    trainable slots)."""
    params = {k: getattr(scene, k) for k in trainable}
    return params, scene


def merge_params(scene, params):
    return scene.replace(**params)


def render_loss(params, scene, cam, target, seed, *, width, height, spp,
                samples_per_pass, max_depth, t_min, remat=False, unroll=None,
                chunk_unroll=1):
    """L2 loss between the rendered radiance mean and a target image
    (linear radiance, [H*W, 3])."""
    s = merge_params(scene, params)
    acc, _ = render_lib.radiance_batch(
        s, cam, jnp.arange(width * height, dtype=jnp.uint32), seed,
        width=width, height=height, sample_start=0, n_samples=spp,
        spp_cap=spp, samples_per_pass=samples_per_pass, max_depth=max_depth,
        t_min=t_min, differentiable=True, remat=remat, unroll=unroll,
        chunk_unroll=chunk_unroll, trainable=tuple(sorted(params)),
    )
    inv = 1.0 / spp
    return (
        jnp.mean((acc.x * inv - target[:, 0]) ** 2)
        + jnp.mean((acc.y * inv - target[:, 1]) ** 2)
        + jnp.mean((acc.z * inv - target[:, 2]) ** 2)
    ) / 3.0


@partial(jax.jit, static_argnames=("width", "height", "spp", "samples_per_pass",
                                   "max_depth", "t_min"))
def render_value_and_grad(params, scene, cam, target, seed, *, width, height,
                          spp, samples_per_pass, max_depth, t_min):
    return jax.value_and_grad(render_loss)(
        params, scene, cam, target, seed, width=width, height=height, spp=spp,
        samples_per_pass=samples_per_pass, max_depth=max_depth, t_min=t_min,
    )


class TrainState(NamedTuple):
    params: dict
    opt_state: object


def make_train_step(scene, cam, target, *, width, height, spp,
                    samples_per_pass, max_depth, t_min=1e-3,
                    learning_rate=1e-2, trainable=DEFAULT_TRAINABLE):
    """Build (init_state, step_fn) for inverse rendering with adam.

    step_fn(state, seed) -> (state, loss); jittable and shardable (see
    parallel/sharding.py for the hybrid-mesh variant used by
    __graft_entry__.dryrun_multichip).
    """
    opt = optax.adam(learning_rate)
    params, _ = split_params(scene, trainable)
    state = TrainState(params=params, opt_state=opt.init(params))

    @jax.jit
    def step(state: TrainState, seed):
        loss, grads = jax.value_and_grad(render_loss)(
            state.params, scene, cam, target, seed, width=width, height=height,
            spp=spp, samples_per_pass=samples_per_pass, max_depth=max_depth,
            t_min=t_min,
        )
        updates, opt_state = opt.update(grads, state.opt_state)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params=params, opt_state=opt_state), loss

    return state, step
