"""Where JAX keeps its persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here. Otherwise the cache lives at one fixed path in the checkout,
``.jax_cache/`` (listed in .gitignore): the path is part of the cache key, so
every entry point (the ``biq-steer`` CLI, bench.py, chip_smoke.py, the tests)
uses the same one.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE = Path(__file__).resolve().parents[3] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX at the compile cache; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
