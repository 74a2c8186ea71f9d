"""Persistent XLA compile cache for the scripts that drive the device.

A flagship (B=128, dz=1000) solve takes tens of seconds to compile.  The
cache lives where ``JAX_COMPILATION_CACHE_DIR`` says; without it, at the
fixed ``<repo>/.jax_cache`` (listed in ``.gitignore``).  The path is part
of the cache key, so it never moves between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

_REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(_REPO_CACHE)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``cache_dir()``."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
