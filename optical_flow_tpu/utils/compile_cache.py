"""Where the persistent XLA compilation cache lives.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; where it is set, that
directory is the cache and nothing here overrides it. Otherwise the cache
is ``<checkout>/.xla_cache``: a fixed path, because the path is part of
the cache key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_ENV = "JAX_COMPILATION_CACHE_DIR"
_enabled = False


def cache_dir() -> str:
    """The compile-cache directory `enable_persistent_cache` uses."""
    return os.environ.get(_ENV) or os.path.join(_CHECKOUT, ".xla_cache")


def enable_persistent_cache() -> str:
    """Turn on JAX's on-disk compilation cache so repeated runs (bench,
    CLI, tests) reuse compiled executables. Call before the first jit
    compilation. Returns the cache directory."""
    global _enabled
    path = cache_dir()
    if _enabled:
        return path
    import jax

    if not os.environ.get(_ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # the default thresholds skip small programs; cache everything
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _enabled = True
    return path
