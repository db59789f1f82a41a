"""Where JAX keeps its persistent compilation cache for the entry points."""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    directory is set here; otherwise the cache lives in ``<repo>/.jax_cache``
    (a fixed path, so later processes hit it; git ignores it).
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_REPO, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
