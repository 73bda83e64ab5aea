"""JAX's persistent compilation cache at a fixed place.

Every entry point (chip_smoke.py, bench.py, scripts/reference_scale.py,
scripts/demo_hybrid.py) calls enable_compile_cache() before its first
compilation, so repeated runs in one checkout reuse compiled programs.
"""

from __future__ import annotations

import os

import jax

# in the checkout, listed in .gitignore; never a temporary or per-run name,
# because a cache whose directory moves is never hit again
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the cache on and return its directory. Where
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is set
    here; otherwise the cache goes to CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
