"""Zigzag scan (device, JAX).

A static gather along the last axis — free for XLA to fuse. The DSP port
spends a vector-permute kernel on this (dsp zigzag.c:33-114); under XLA
it fuses into the surrounding elementwise work.
"""
from __future__ import annotations

import jax.numpy as jnp

from .. import tables

def zigzag_scan(blocks: jnp.ndarray) -> jnp.ndarray:
    """[..., 8, 8] -> [..., 64] coefficients in zigzag order
    (reference zigzag.c:21-65)."""
    flat = blocks.reshape(*blocks.shape[:-2], 64)
    # NB: the order constant stays numpy at module scope — a module-level
    # jnp.asarray would initialize the default backend at import time.
    return flat[..., jnp.asarray(tables.ZIGZAG_ORDER)]


def inverse_zigzag(zz: jnp.ndarray) -> jnp.ndarray:
    """[..., 64] zigzag -> [..., 8, 8] raster."""
    inv = jnp.asarray(tables.INV_ZIGZAG)
    return zz[..., inv].reshape(*zz.shape[:-1], 8, 8)
