"""Persistent XLA compile cache, shared by every entry point.

Compiling a 12 MPix encode takes seconds, and every process (test
worker, benchmark, smoke run, CLI) compiles the same programs. JAX keys
its on-disk cache by the directory path, so the directory must not move
between runs: it is $JAX_COMPILATION_CACHE_DIR when the environment sets
it (JAX reads that variable itself), else `.jax_cache/` at the root of
this checkout.
"""
from __future__ import annotations

import os

CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable() -> str:
    """Point JAX's persistent compile cache at its directory and return
    that directory. Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_DIR)
    # cache every program: the suite and the smoke run compile many
    # small ones, each costing more to compile than to load
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return CHECKOUT_DIR
