"""Persistent compilation cache for the entry points.

Entry points (``chip_smoke.py``, ``bench.py``, ``scripts/run_*.py``,
``examples/*``) call :func:`enable` before their first compile, so a
second run of the same program on the same machine skips most of the
compile time. Importing the package enables nothing: test workers do not
write caches.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# Fixed, checkout-relative: the cache path is part of the cache key, so a
# directory that moves between runs would never hit.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable() -> str:
    """Turn the cache on and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing; otherwise the cache goes to ``.jax_cache/`` at the
    checkout root.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
