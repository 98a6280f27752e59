"""Persistent JAX compilation cache location, one rule for every entry
point (bench.py, chip_smoke.py, the scripts and the tests).

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here sets another directory.  Otherwise compiled programs go to
``<checkout>/.jax_cache``: a fixed path, so repeat runs hit the cache
(the directory is part of the cache key).  Programs are keyed by their
HLO, so the cache never changes results.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory compiled programs are cached in."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`cache_dir` and return it."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    return cache_dir()
