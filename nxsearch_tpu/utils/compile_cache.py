"""Where the persistent XLA compilation cache lives.

One rule for every entry point (bench.py, the REST service, the
tools): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and no code here names another directory; otherwise the cache goes to
the fixed ``<checkout>/.jax_cache`` (listed in .gitignore).  A fixed
path matters because the directory is part of the cache key: a cache
that moves with a temporary basedir never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Turn the persistent compilation cache on; returns its directory.

    Executables that compiled faster than ``min_compile_secs`` are not
    written (the cache would cost more to read than they cost to
    build)."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
