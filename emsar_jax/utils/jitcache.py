"""Persistent compile cache shared by the CLIs, bench and tools.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
directory is set here.  Otherwise the cache sits at the fixed path
``<checkout>/bench_cache/jit_cache``: the path is part of what a later
process must find again, so it must not move between runs.

The write thresholds are zeroed so every executable persists: the
builder launches many small kernels whose compile XLA reports as near
zero, yet each costs a trace and a compile in every new process.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "bench_cache", "jit_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    import jax

    if not os.environ.get(ENV):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir()
