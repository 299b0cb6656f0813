"""Placement of JAX's persistent compilation cache.

A cold process spends much of a short run compiling the streaming steps;
the persistent cache lets the next process on the same machine skip that.
The cache directory is part of the cache key, so it is a fixed path, never
one built from a temporary name, a process id or the time.
"""

from __future__ import annotations

import os

__all__ = ["CACHE_ENV", "DEFAULT_CACHE_DIR", "enable_compile_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here.  Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
