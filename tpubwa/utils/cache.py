"""Where JAX keeps its persistent compile cache.

JAX_COMPILATION_CACHE_DIR, when set, is the cache: JAX reads it itself and
nothing else is configured.  Otherwise the cache is the fixed
``<checkout>/.jax_cache`` (gitignored): the path is part of the cache key,
so a fixed path is what lets a later process find what an earlier compiled.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory (see module
    docstring); returns that directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
