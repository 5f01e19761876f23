"""Profiling & metrics.

The reference's only instrumentation is wall-clock brackets + a nominal
kRay/s print (SURVEY §5).  Here:
  * ``trace()`` context manager wraps a region in a ``jax.profiler`` trace;
  * ``device_busy()`` reduces such a trace to the GPU's busy time, idle share
    and per-kernel time (the union of the device planes' op intervals);
  * ``RayStats`` accumulates honest segment counts (bounce rays included)
    and derives Mrays/s;
  * ``timed()`` convenience for wall-clock brackets with block_until_ready.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import subprocess
import sys
import time

import jax

GPU_PLANE_PREFIX = "/device:GPU:"


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W`` (one line per card, joined by
    '; ').  Needs no JAX process."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def device_info() -> dict:
    """What every printed measurement carries: JAX's view of the device and
    the card's name and power limit."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card_info()}


def require_gpu():
    """Exit non-zero unless JAX's first device is a GPU: a measurement
    never carries on on another backend."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"error: needs a GPU, JAX found {platform!r}", file=sys.stderr)
        raise SystemExit(2)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a region (writes xplane protos to log_dir)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str, sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {(time.perf_counter() - t0) * 1000:.1f} ms")


@dataclasses.dataclass
class RayStats:
    """Honest throughput accounting (vs the reference's primary-only
    ``W*H*spp/ms`` at main.cpp:50-53, which ignores bounces and adaptive
    skipping)."""

    segments: int = 0
    seconds: float = 0.0

    def add(self, segments: int, seconds: float):
        self.segments += int(segments)
        self.seconds += seconds

    @property
    def mrays_per_s(self) -> float:
        return self.segments / self.seconds / 1e6 if self.seconds else 0.0


def device_events(profile) -> list:
    """(name, start_ns, end_ns) of every op on the GPU device planes of a
    ``jax.profiler.ProfileData``.  Only the per-stream lines are read when a
    plane has them: derived lines (XLA modules, steps) span idle gaps."""
    out = []
    for plane in profile.planes:
        if not plane.name.startswith(GPU_PLANE_PREFIX):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                out.append((ev.name, ev.start_ns, ev.start_ns + ev.duration_ns))
    return out


def device_busy(profile) -> dict:
    """Busy time, window, idle share and per-kernel device time of a trace.

    The window runs from the first device op's start to the last one's end;
    busy is the union of the op intervals in it, so ops overlapping on
    several streams count once.  Raises ValueError when the trace holds no
    GPU device events (a CPU run, or a trace that missed the device)."""
    events = device_events(profile)
    if not events:
        raise ValueError("no GPU device events in the trace")
    spans = sorted((s, e) for _, s, e in events)
    busy = 0.0
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    kernels = {}
    for name, s, e in events:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-9
    return {
        "busy_s": busy * 1e-9,
        "window_s": window * 1e-9,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "kernel_s": kernels,
    }


def device_busy_logdir(logdir: str) -> dict:
    """:func:`device_busy` of the newest trace that ``trace(logdir)`` wrote."""
    files = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.xplane.pb")))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb trace under {logdir}")
    return device_busy(jax.profiler.ProfileData.from_file(files[-1]))
