"""JAX's persistent compilation cache for the repo's entry points.

Called by ``chip_smoke.py``, ``bench.py`` and the CLI, never at library
import: a library should not decide where its host process caches.
"""

from __future__ import annotations

import os

#: The checkout root (the directory holding the package).
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the cache is keyed on it, so a moving path never hits)."""
    return os.environ.get('JAX_COMPILATION_CACHE_DIR') or os.path.join(
        _CHECKOUT, '.jax_cache'
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return that path."""
    import jax

    path = cache_dir()
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)
    return path
