"""One place that decides where JAX keeps its persistent compile cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing is
set in code.  Otherwise the cache lives at the fixed path
``<checkout>/.jax_cache`` (listed in .gitignore): the directory is part of
the cache key, so a temporary or per-process name would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns the directory in use."""
    import jax

    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return str(DEFAULT_DIR)
