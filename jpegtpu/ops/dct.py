"""2D 8x8 DCT as batched matmuls (device, JAX).

The reference computes an O(N^4) scalar quadruple loop per block
(natural_c dct.c:63-96); its DSP port already discovered the separable
matmul form F = T X T^T (dsp_port dct.c:78-103), which here is one
einsum over thousands of blocks at once.

Precision: float32 with HIGHEST matmul precision (int8-range inputs are
exact in f32; coefficient parity verified against the reference's quantized
outputs — see tables.dct_basis_reference).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def dct_blocks(blocks: jnp.ndarray, basis: jnp.ndarray) -> jnp.ndarray:
    """[..., 8, 8] level-shifted samples -> [..., 8, 8] DCT coefficients.

    F = T @ X @ T.T with T = `basis` ([8, 8] f32).
    """
    x = blocks.astype(basis.dtype)
    # Row pass then column pass; einsum keeps it one fused contraction pair.
    return jnp.einsum(
        "ux,...xy,vy->...uv",
        basis,
        x,
        basis,
        precision=jax.lax.Precision.HIGHEST,
    )
