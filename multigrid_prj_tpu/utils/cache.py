"""Persistent XLA compilation cache, one policy for every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache lives at ``<repo>/.jax_cache`` — a
fixed path, because the directory is part of what makes a later run find
the entries again.  Call :func:`enable_compile_cache` before the first
compile.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    cache_dir = os.environ.get(ENV_VAR)
    if not cache_dir:
        cache_dir = REPO_CACHE
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir
