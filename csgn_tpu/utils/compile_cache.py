"""JAX's persistent compilation cache for the program's entry points.

Compiling the hot ops at real shapes takes seconds per shape; a cache kept
at a fixed path lets the next process skip it.  The directory is part of the
cache's key, so it never contains a temporary directory, a pid or a time.
"""

from __future__ import annotations

import os
import pathlib

__all__ = ["CACHE_ENV", "enable_compile_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache: this file sits at <checkout>/csgn_tpu/utils/.
_DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it; nothing
    else is set.  Otherwise the cache lives at `<checkout>/.jax_cache`.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(_DEFAULT_DIR))
    return str(_DEFAULT_DIR)
