"""Fused tiled transform: level shift -> 2D DCT -> quantize -> zigzag.

The naive formulation (`ops/dct.py`) runs 8x8 matmuls batched over
blocks — products too small for a matrix unit to fill. This module uses
the BLOCK-DIAGONAL embedding: a [T, T] matrix with the 8-point DCT basis
repeated along the diagonal applies the per-8-row (and per-8-column)
transform of a whole TxT pixel tile as ONE dense matmul:

    F_tile = BD(T8) @ X_tile @ BD(T8)^t ,  T = 128 (16 blocks per side)

The 16x MAC redundancy (dense vs 8-banded) buys dense matrix products.
Quantization (true division + round-half-away, the reference's roundf,
quantization.c:36) and the zigzag gather fuse into the same XLA program;
only the int32 levels are materialized. The products run at
Precision.HIGHEST: a TF32 product keeps ~10 mantissa bits and would
move levels off the natural_c goldens.

This is the DSP port's central discovery — DCT as matmul (dsp
dct.c:78-103) — at tile scale.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .. import tables

TILE = 128  # pixels per tile side = 16 blocks


@functools.lru_cache(maxsize=4)
def _blockdiag_basis(bitexact: bool) -> np.ndarray:
    t8 = (
        tables.dct_basis_reference(np.float32)
        if bitexact
        else tables.dct_basis(np.float32)
    )
    bd = np.zeros((TILE, TILE), np.float32)
    for g in range(TILE // 8):
        bd[8 * g : 8 * g + 8, 8 * g : 8 * g + 8] = t8
    return bd


def padded_dims_tile(h: int, w: int) -> tuple[int, int]:
    return (-(-h // TILE) * TILE, -(-w // TILE) * TILE)


def transform_tiled(
    img: jnp.ndarray, qtable: jnp.ndarray, bitexact: bool = True,
    out_blocks: tuple[int, int] | None = None,
) -> jnp.ndarray:
    """uint8/int image [PH, PW] (PH, PW multiples of TILE) -> zigzag
    levels [nbh * nbw, 64] int32, blocks in raster order.

    out_blocks = (nbh, nbw) trims the result when the tile padding added
    whole block rows/cols beyond the real (8-aligned) image.
    """
    ph, pw = img.shape
    a, b = ph // TILE, pw // TILE
    bd = jnp.asarray(_blockdiag_basis(bitexact))
    x = img.astype(jnp.float32).reshape(a, TILE, b, TILE) - 128.0
    # F = BD @ X @ BD^t per tile, contracted as one einsum pair.
    f = jnp.einsum(
        "ij,ajbk,lk->aibl", bd, x, bd, precision=jax.lax.Precision.HIGHEST
    )
    # quantize: true division (preserves the reference's exact F/Q value at
    # rounding boundaries — the DSP's reciprocal multiply is what costs it
    # 2 dB, SURVEY §6.3) + round half away from zero (roundf)
    qtile = jnp.tile(qtable.astype(jnp.float32), (TILE // 8, TILE // 8))
    scaled = f / qtile[None, :, None, :]
    levels = jnp.where(
        scaled >= 0, jnp.floor(scaled + 0.5), jnp.ceil(scaled - 0.5)
    ).astype(jnp.int32)
    # blockify: [a, 16, 8, b, 16, 8] -> [nb, 64], raster block order
    g = TILE // 8
    lv = levels.reshape(a, g, 8, b, g, 8).transpose(0, 1, 3, 4, 2, 5)
    lv = lv.reshape(a * g, b * g, 64)
    if out_blocks is not None:
        lv = lv[: out_blocks[0], : out_blocks[1]]
    zz = lv.reshape(-1, 64)[:, jnp.asarray(tables.ZIGZAG_ORDER)]
    return zz
