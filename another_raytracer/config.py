"""Render configuration.

The reference hard-codes its configuration at compile time in
``src/core/tracer_constants.h:6-14`` (720x540, 100 spp, max_depth 50, adaptive
mode selected at src/main.cpp:44) plus one unvalidated CLI arg for the scene
index (src/main.cpp:23-26). Here the whole configuration is a first-class
runtime object consumed by ``render()`` and the CLI.
"""

from __future__ import annotations

import dataclasses
import enum


class RenderMode(enum.Enum):
    """Render execution strategies, mirroring ``engine_mode``
    (reference: src/engine/engine.h:10-16).

    * ``SINGLE``          — one pass over all pixels at full spp.
    * ``PARALLEL_STRIPES``— pixel rows sharded across devices (the reference
      splits the image into 4 horizontal stripes over a thread pool,
      engine.h:335-376; here stripes shard over a device mesh axis).
    * ``PARALLEL_IMAGES`` — samples-per-pixel sharded across devices with a
      final sum-reduction (reference: 4 partial full-res accumulators + manual
      per-pixel sum, engine.h:378-445; here spp-sharding + ``psum``).
    * ``ADAPTIVE``        — hierarchical adaptive subsampling: corner pixels of
      12->6->3 square tiles are path traced and flat tiles are interpolated
      (reference: engine.h:96-333; here a masked two-pass formulation).
    """

    SINGLE = "single"
    PARALLEL_STRIPES = "parallel_stripes"
    PARALLEL_IMAGES = "parallel_images"
    ADAPTIVE = "adaptive"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All knobs of a render, promoted from the reference's compile-time
    constants (src/core/tracer_constants.h) to runtime configuration."""

    width: int = 720
    height: int = 540
    samples_per_pixel: int = 100
    max_depth: int = 50
    seed: int = 0
    mode: RenderMode = RenderMode.SINGLE
    # Shadow-acne epsilon: reference uses t_min = 1e-3 (engine.h:455).
    t_min: float = 1e-3
    # Number of samples traced per fused device pass; the sample loop is a
    # lax.scan over ceil(spp / samples_per_pass) passes.  Memory per pass is
    # O(width*height*samples_per_pass).  Not yet tuned on the GPU.
    samples_per_pass: int = 1
    # Adaptive mode parameters (reference: engine.h:96-333).
    adaptive_tile: int = 12
    adaptive_threshold: float = 100.0
    # Samples per pass for adaptive's bucketed pixel batches.  None = use
    # samples_per_pass (traced-pixel values bit-identical to a single-mode
    # render at that spass).  Widening lost where it was tried: the
    # widened buckets are mostly born-dead and early full-width iterations
    # outweigh shorter per-lane sample ranges.
    adaptive_spass: int | None = None

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
