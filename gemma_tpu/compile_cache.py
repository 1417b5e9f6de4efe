"""Shared persistent-compile-cache setup.

One helper so the CLI, bench.py, chip_smoke.py and the tools/ scripts share
one cache location and the same source-location-independent keys (kernel
payloads embed source locations incl. caller tracebacks; without
`jax_traceback_in_locations_limit=0`, editing ANY file in the call stack —
even a comment — changes the cache key and forces a full recompile).

Location: when $JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
no directory is set here; otherwise `<repo>/.jax_cache`, a fixed path (the
path is part of the cache key, so a directory that moves never hits).
"""
from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def setup_compile_cache() -> None:
    """Idempotent; call before the first jit."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(REPO_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_traceback_in_locations_limit", 0)
