"""Progressive render preview + tile checkpointing.

The reference shows live progress in an X11 window (``dynamic_gui``,
gui.cpp:25-58) and persists nothing — a crash loses the frame (SURVEY §5).
Here both concerns are host-side callbacks around the sample loop:

  * ``ProgressivePreview`` accumulates per-pass radiance and writes a PNG
    snapshot every ``interval`` passes — the headless equivalent of the live
    window (rendering math never depends on it, same as the reference).
  * ``RenderCheckpoint`` persists the accumulator + pass counter + RNG seed
    to an .npz after each chunk; ``resume`` restores it, so an interrupted
    long render continues exactly (counter-based RNG makes the remaining
    samples identical to an uninterrupted run).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from another_raytracer.ops import color as color_lib


@dataclasses.dataclass
class ProgressivePreview:
    """Between-pass progress sink: PNG snapshots to ``path`` and/or a live
    HTTP viewer (utils/liveview.py) — together the headless analog of the
    reference's dynamic_gui window (gui.cpp:25-58)."""

    path: Optional[str]
    width: int
    height: int
    interval: int = 1  # write every N updates
    viewer: object = None  # optional LiveViewer; pushed every update
    _count: int = 0

    def update(self, radiance_sum: np.ndarray, samples_done: int) -> None:
        """Push a linear radiance accumulator (gamma applied here)."""
        self._count += 1
        write_file = self.path is not None and self._count % self.interval == 0
        if not write_file and self.viewer is None:
            return
        img = np.asarray(color_lib.to_uint8(radiance_sum, max(samples_done, 1)))
        img = img.reshape(self.height, self.width, 3)
        self._emit(img, samples_done, write_file)

    def update_image(self, img_uint8: np.ndarray, progress: int) -> None:
        """Push an already-tonemapped snapshot (adaptive mode's gamma-int
        work frame; the reference feeds its live window the same int frame
        per square, engine.h:307)."""
        self._count += 1
        write_file = self.path is not None and self._count % self.interval == 0
        self._emit(np.asarray(img_uint8, np.uint8), progress, write_file)

    def _emit(self, img: np.ndarray, progress: int, write_file: bool) -> None:
        if self.viewer is not None:
            self.viewer.update(img, progress)
        if write_file:
            from another_raytracer.utils import imageio

            imageio.save_png(self.path, img)


def render_fingerprint(scene, cam, config) -> str:
    """Digest identifying a render stream: scene arrays + camera + every
    config knob that changes sample values.  Two renders share partial
    accumulators iff their fingerprints match — resuming across a changed
    seed/scene/camera would silently blend two different renders otherwise.

    ``samples_per_pixel`` is deliberately NOT part of the digest: the RNG
    keys on absolute (pixel, sample) ids, so extending a finished render to a
    higher spp cap is a legitimate resume of the same stream."""
    import hashlib

    import jax

    h = hashlib.sha1()
    for leaf in jax.tree.leaves((scene, cam)):
        a = np.asarray(leaf)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(repr((config.width, config.height, config.samples_per_pass,
                   config.max_depth, config.seed, config.t_min)).encode())
    return h.hexdigest()


@dataclasses.dataclass
class RenderCheckpoint:
    path: str

    def save(self, radiance_sum: np.ndarray, samples_done: int, seed: int,
             width: int, height: int, fingerprint: str = "") -> None:
        tmp = Path(str(self.path) + ".tmp")
        np.savez(
            tmp, radiance=radiance_sum, samples_done=samples_done, seed=seed,
            width=width, height=height, fingerprint=np.str_(fingerprint),
        )
        # np.savez appends .npz to the filename it opens
        Path(str(tmp) + ".npz").replace(self.path)

    def load(self, fingerprint: str = None) -> Optional[dict]:
        """Load the checkpoint; returns None (with a warning) when
        ``fingerprint`` is given and doesn't match the stamped one —
        accumulating samples from a different (seed, scene, camera, config)
        stream would silently corrupt the render."""
        p = Path(self.path)
        if not p.exists():
            return None
        with np.load(p) as z:
            state = {k: z[k] for k in z.files}
        if fingerprint is not None:
            stamped = str(state.get("fingerprint", ""))
            if stamped != fingerprint:
                import warnings

                warnings.warn(
                    f"checkpoint {self.path} was produced by a different "
                    "render (scene/camera/config fingerprint mismatch); "
                    "ignoring it and starting fresh",
                    RuntimeWarning, stacklevel=2,
                )
                return None
        return state


def render_progressive(scene, cam, config, preview: ProgressivePreview = None,
                       checkpoint: RenderCheckpoint = None):
    """Single-device progressive render with preview + checkpoint/resume.

    Renders ``samples_per_pass`` samples per device call (host loop over
    chunks instead of the fused lax.scan), feeding callbacks between chunks.
    Returns (uint8 image [H,W,3], stats).
    """
    import jax.numpy as jnp

    from another_raytracer.ops import render as render_lib
    from another_raytracer.ops import vec3

    W, H, spp = config.width, config.height, config.samples_per_pixel
    spass = min(config.samples_per_pass, spp)
    pixel_ids = jnp.arange(W * H, dtype=jnp.uint32)

    start_chunk = 0
    acc = np.zeros((W * H, 3), np.float64)
    fp = render_fingerprint(scene, cam, config) if checkpoint is not None else ""
    if checkpoint is not None:
        state = checkpoint.load(fingerprint=fp)
        if state is not None and int(state["width"]) == W and int(state["height"]) == H:
            acc = state["radiance"].astype(np.float64)
            start_chunk = int(state["samples_done"]) // spass

    segments = 0
    n_chunks = -(-spp // spass)
    for chunk in range(start_chunk, n_chunks):
        r, segs = render_lib.radiance_batch(
            scene, cam, pixel_ids, jnp.uint32(config.seed),
            width=W, height=H, sample_start=chunk * spass, n_samples=spass,
            spp_cap=spp, samples_per_pass=spass, max_depth=config.max_depth,
            t_min=config.t_min,
        )
        acc += vec3.to_numpy(r)
        segments += int(segs)
        done = min((chunk + 1) * spass, spp)
        # Console progress % (reference: "\r...%" lines, engine.h:80,320).
        print(f"\rprogress: {done * 100 // spp}% ({done}/{spp} spp)",
              end="" if done < spp else "\n", file=sys.stderr, flush=True)
        if preview is not None:
            preview.update(acc, done)
        if checkpoint is not None:
            checkpoint.save(acc, done, config.seed, W, H, fingerprint=fp)

    img = np.asarray(color_lib.to_uint8(acc, spp)).reshape(H, W, 3)
    return img, {"segments": segments, "resumed_at_chunk": start_chunk}
