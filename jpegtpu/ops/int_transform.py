"""Integer-mode transform: bit-deterministic across every backend.

The float DCT path is faithful to the reference but leaves coefficients
that sit exactly on a 0.5 rounding boundary at the mercy of each
backend's summation order (SURVEY.md §7.3 #2). This mode makes the
whole transform integer-exact, so the SAME stream comes out of every
backend and any device count:

  * basis scaled to 11-bit fixed point: T_i = round(T * 2^11), |T_i| < 2^11
  * row pass   Y1 = T_i @ X        (|sum| <= 8 * 2^11 * 128 = 2^22)
  * descale    Y1' = (Y1 + 2^10) >> 11
  * col pass   Y2 = Y1' @ T_i^T    (|sum| <= 8 * 2^10 * 2^11 = 2^24)
  * descale -> F, quantize with integer round-half-away: (2|F| + Q) / 2Q

Every intermediate stays below 2^24, so the arithmetic is exact even
when a backend lowers integer dots through float32 units. The 11-bit
basis costs < 0.05 dB PSNR vs the float path (tested).

Uses the same block-diagonal embedding as the float path
(ops/fused_transform.py).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .. import tables
from .fused_transform import TILE, padded_dims_tile

_FRAC = 11
_HALF = 1 << (_FRAC - 1)


@functools.lru_cache(maxsize=4)
def _blockdiag_basis_int(bitexact: bool) -> np.ndarray:
    t8 = (
        tables.dct_basis_reference(np.float64)
        if bitexact
        else tables.dct_basis(np.float64)
    )
    t_i = np.round(t8 * (1 << _FRAC)).astype(np.int32)
    bd = np.zeros((TILE, TILE), np.int32)
    for g in range(TILE // 8):
        bd[8 * g : 8 * g + 8, 8 * g : 8 * g + 8] = t_i
    return bd


def transform_tiled_int(
    img: jnp.ndarray, qtable: jnp.ndarray, bitexact: bool = True,
    out_blocks: tuple[int, int] | None = None,
) -> jnp.ndarray:
    """uint8/int image [PH, PW] (multiples of TILE) -> zigzag levels
    [nb, 64] int32 — integer-exact, backend-independent."""
    ph, pw = img.shape
    a, b = ph // TILE, pw // TILE
    bd = jnp.asarray(_blockdiag_basis_int(bitexact))
    x = img.astype(jnp.int32).reshape(a, TILE, b, TILE) - 128
    y1 = jnp.einsum("ij,ajbk->aibk", bd, x, preferred_element_type=jnp.int32)
    y1 = (y1 + _HALF) >> _FRAC
    y2 = jnp.einsum("ajbk,lk->ajbl", y1, bd, preferred_element_type=jnp.int32)
    f = (y2 + _HALF) >> _FRAC
    # integer round-half-away-from-zero division by the quant table
    q = jnp.tile(qtable.astype(jnp.int32), (TILE // 8, TILE // 8))
    qq = q[None, :, None, :]
    mag = (2 * jnp.abs(f) + qq) // (2 * qq)
    levels = jnp.where(f < 0, -mag, mag)
    g = TILE // 8
    lv = levels.reshape(a, g, 8, b, g, 8).transpose(0, 1, 3, 4, 2, 5)
    lv = lv.reshape(a * g, b * g, 64)
    if out_blocks is not None:
        lv = lv[: out_blocks[0], : out_blocks[1]]
    return lv.reshape(-1, 64)[:, jnp.asarray(tables.ZIGZAG_ORDER)]
