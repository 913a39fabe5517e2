"""Persistent compilation cache location, shared by the scripts and tools.

JAX_COMPILATION_CACHE_DIR wins when it is set (JAX reads it itself);
otherwise the cache lives in a fixed `.jax_cache/` at the checkout root,
so that every process of one checkout finds what the others compiled.
"""
from __future__ import annotations

import os

import jax

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache():
    """Turns the persistent compilation cache on; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
