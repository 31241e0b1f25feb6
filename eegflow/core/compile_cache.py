"""Where the persistent XLA compilation cache lives.

A cold process compiles every program it runs; on the full-width model that
is minutes. JAX keeps compiled programs on disk when
``jax_compilation_cache_dir`` is set, and reads the ``JAX_COMPILATION_CACHE_DIR``
environment variable for it at import. The cache directory is part of a
compiled program's cache key, so the default here is a fixed path inside the
checkout (``<repo>/.jax_cache``, git-ignored), never a temporary name.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

#: default cache directory: ``.jax_cache`` at the root of the checkout
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(default_dir: str | Path = REPO_CACHE_DIR) -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and no other
    directory is set. Otherwise the cache goes to ``default_dir``.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(default_dir))
    return str(default_dir)
