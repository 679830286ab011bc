"""Persistent compilation cache in one place."""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                         ".jax_cache")


def enable_compile_cache() -> str:
    """Keep compiled programs across processes. ``JAX_COMPILATION_CACHE_DIR``
    wins when it is set (JAX reads it itself, so nothing is set here);
    otherwise the cache lives at a fixed ``<repo>/.jax_cache/``, since the
    path is part of the cache key. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
