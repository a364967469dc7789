"""One place that decides where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Use `$JAX_COMPILATION_CACHE_DIR` when it is set, otherwise the fixed
    `<checkout>/.jax_cache` (a fixed path, because the path is part of the
    cache key). Returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
