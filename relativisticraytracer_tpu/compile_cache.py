"""JAX's persistent compilation cache, at one well-defined place.

Every CLI run, benchmark and smoke check is a fresh process, and the march
compiles for tens of seconds; a warm cache starts the same configuration in
seconds. The reference pays this cost once at build time (nvcc); the cache
is the JIT-world equivalent.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets no other directory. Otherwise the cache lives at one fixed
directory inside the checkout (`.jax_cache/`, git-ignored): a fixed path,
because the path is part of the cache key. `RRT_COMPILE_CACHE=0` turns the
cache off (the tests do, to stay hermetic).
"""

from __future__ import annotations

import logging
import os
import pathlib
from typing import Optional

DEFAULT_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir() -> Optional[str]:
    """The directory the cache uses, or None when it is turned off."""
    if os.environ.get("RRT_COMPILE_CACHE", "") == "0":
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def enable_compile_cache() -> Optional[str]:
    """Turn the persistent cache on (see the module docstring); returns
    its directory, or None when it is off or unavailable."""
    path = cache_dir()
    if path is None:
        return None
    try:
        import jax

        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception as e:  # noqa: BLE001 — the cache is an optimization only
        logging.getLogger("relativisticraytracer_tpu").debug(
            "compilation cache unavailable: %s", e
        )
        return None
    return path
