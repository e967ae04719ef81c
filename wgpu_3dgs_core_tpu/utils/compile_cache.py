"""Persistent compilation cache location, shared by every entry point.

Compiling the renderer's step at full size takes a noticeable part of a
cold run, so scripts keep XLA's compiled programs on disk. The cache key
includes the directory, so it lives at one fixed place.
"""

from __future__ import annotations

import os
from pathlib import Path

# <checkout>/.jax_cache (listed in .gitignore), found from this file's own
# location: <checkout>/wgpu_3dgs_core_tpu/utils/compile_cache.py.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return the directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed. Otherwise the cache goes to ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
