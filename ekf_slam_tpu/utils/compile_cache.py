"""Persistent XLA compilation cache for the entry points.

`enable_compile_cache()` is called by bench.py, chip_smoke.py and the
examples/ drivers before their first compile. When
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no other
directory is set here; otherwise the cache lives at the fixed
`<checkout>/.jax_cache` (git-ignored). The path is part of what makes a
cache entry reusable, so it is never derived from a temp name, a PID or the
time."""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
