"""Persistent XLA compilation cache (opt-in helper).

Caching compiled executables across processes cuts repeat test and
benchmark wall clock.  The cache lives where ``JAX_COMPILATION_CACHE_DIR``
says when it is set, otherwise in the checkout's fixed ``.jax_cache``
(the path is part of the cache key, so it must not move).  Call enable()
AFTER importing jax and before the first jit execution.  Off by default
for library users (global config mutation is the caller's choice);
tests/conftest.py, bench.py and chip_smoke.py opt in.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> None:
    import jax

    jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
