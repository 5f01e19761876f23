"""Persistent XLA compilation cache.

The reference pays its compile cost once at C++ build time; the analog here
is JAX's persistent compilation cache, which serializes compiled executables
to disk keyed on (HLO, flags, backend), so a second run of the same program
skips compilation.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set -> JAX uses that directory itself; this
  module sets no other.
* otherwise -> ``.jax_cache/`` at the root of the checkout (a fixed path, so
  later runs of the same checkout hit; listed in .gitignore).
* ``ART_COMPILE_CACHE=0`` (or ``off`` / ``none`` / ``false``) disables the
  cache.

Call :func:`enable` before the first jitted computation (bench.py, the CLI
and chip_smoke.py do).  Safe to call multiple times.
"""

from __future__ import annotations

import os
from pathlib import Path

_DISABLED = {"0", "off", "none", "false"}

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str | None:
    """The directory :func:`enable` uses, or None when the cache is off."""
    if os.environ.get("ART_COMPILE_CACHE", "").strip().lower() in _DISABLED:
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT_CACHE_DIR)


def enable() -> str | None:
    """Enable the persistent compilation cache; returns the dir or None."""
    path = cache_dir()
    if path is None:
        return None

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        Path(path).mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache every program that took noticeable compile time, including the
    # small helper programs of the adaptive mode.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
