"""Persistent XLA compilation cache for the entry points.

Every process that runs the pipeline recompiles its programs unless a
persistent cache holds them. The CLI, the multihost initializer,
`bench.py`, `chip_smoke.py` and the test suite call
`enable_compilation_cache()` before their first compile, so a second
process over the same shapes loads its executables instead.

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX
reads it into `jax_compilation_cache_dir`, which this module leaves
alone), otherwise one fixed directory inside the checkout,
`<repo>/.jax_cache` (git-ignored). Entries are found again only in the
directory that wrote them, so the fallback path is fixed, never derived
from the host or the device.
"""
from __future__ import annotations

import os
import pathlib

__all__ = ["CHECKOUT_CACHE_DIR", "enable_compilation_cache"]

CHECKOUT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str | None:
    """Turn on the persistent compilation cache (idempotent).

    Respects an existing `jax_compilation_cache_dir` (set by the
    application or by `JAX_COMPILATION_CACHE_DIR`); disable entirely with
    DENSEPOINTS_NO_CACHE=1. Returns the directory in use (None if
    disabled).
    """
    if os.environ.get("DENSEPOINTS_NO_CACHE") == "1":
        return None
    import jax

    cache_dir = jax.config.jax_compilation_cache_dir
    if not cache_dir:
        cache_dir = str(CHECKOUT_CACHE_DIR)
        pathlib.Path(cache_dir).mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
