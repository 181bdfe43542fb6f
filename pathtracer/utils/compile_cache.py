"""The persistent XLA compile cache: one place decides where it lives.

A 1080p frame step takes minutes to compile cold, so every entry point (the
CLI, bench.py, chip_smoke.py, the tests) keeps compiled programs across
processes.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing else is
configured (JAX reads that variable itself).  Otherwise the cache goes to
``.jax_cache`` at the checkout's root, a fixed path (the path is part of the
cache key, so a directory that moves never hits) that .gitignore lists.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """The directory the cache uses: the environment's, else DEFAULT_DIR."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR
