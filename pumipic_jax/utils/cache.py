"""Persistent XLA compilation cache for the repository's scripts.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and the
cache lives there.  Otherwise scripts keep it at a fixed ``<root>/.jax_cache``
(listed in ``.gitignore``): the path is part of the cache key, so it is
never built from a temporary name, a pid or the time.
"""
from __future__ import annotations

import os

import jax

CACHE_DIRNAME = ".jax_cache"


def enable_compile_cache(root: str) -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(root), CACHE_DIRNAME)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
