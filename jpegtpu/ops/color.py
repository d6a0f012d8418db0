"""Color conversion ops (device, JAX).

Two Y paths:
  * `rgb_to_y_reference`: the reference's integer approximation
    Y = (77 R + 150 G + 29 B) >> 8 (natural_c converter.c:51 and the DSP's
    vectorized identical math, color_space.c:35-54). Used for bit-parity.
  * `rgb_to_ycbcr`: full-range JFIF/BT.601 conversion for the color path,
    a capability the reference discards (chroma dropped at converter.c:51).
"""
from __future__ import annotations

import jax.numpy as jnp


def rgb_to_y_reference(rgb: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] uint8 -> [...] uint8 luma via the reference's integer approx."""
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    return ((77 * r + 150 * g + 29 * b) >> 8).astype(jnp.uint8)


def rgb_to_ycbcr(rgb: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] uint8 -> [..., 3] uint8 full-range JFIF YCbCr.

    Y  =  0.299 R + 0.587 G + 0.114 B
    Cb = -0.168736 R - 0.331264 G + 0.5 B + 128
    Cr =  0.5 R - 0.418688 G - 0.081312 B + 128
    Computed in fixed point (16-bit scale) for determinism across backends.
    """
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + half) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + half) >> 16
    out = jnp.stack(
        [y, jnp.clip(cb + 128, 0, 255), jnp.clip(cr + 128, 0, 255)], axis=-1
    )
    return out.astype(jnp.uint8)


def rgb_planar_to_ycbcr(rgbp: jnp.ndarray):
    """Channel-PLANAR [3, H, W] uint8 -> (y, cb, cr) 2D uint8 planes.

    The planar layout is the device-boundary contract for the color path:
    each channel is one contiguous plane, so a channel read is a plain
    slice. The reference's DSP host made the same call — planar R/G/B
    channels in shared DDR (dsp bmp_handler.c:78-80).
    Same fixed-point math as rgb_to_ycbcr.
    """
    r = rgbp[0].astype(jnp.int32)
    g = rgbp[1].astype(jnp.int32)
    b = rgbp[2].astype(jnp.int32)
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = jnp.clip(((-11059 * r - 21709 * g + 32768 * b + half) >> 16) + 128, 0, 255)
    cr = jnp.clip(((32768 * r - 27439 * g - 5329 * b + half) >> 16) + 128, 0, 255)
    return y.astype(jnp.uint8), cb.astype(jnp.uint8), cr.astype(jnp.uint8)


def subsample_420(chan: jnp.ndarray) -> jnp.ndarray:
    """2x2 box-average chroma subsampling. [H, W] -> [H/2, W/2] uint8.

    H and W must be even (pad with pad_edge(multiple=2) first).
    Rounds to nearest (adds 2 before >> 2), matching libjpeg's box filter.

    Lowered as a native 2x2/stride-2 reduce_window (XLA pooling) rather
    than a reshape to [H/2, 2, W/2, 2] or four stride-2 slices.
    """
    import jax.lax as lax

    s = lax.reduce_window(
        chan.astype(jnp.int32), 0, lax.add,
        window_dimensions=(2, 2), window_strides=(2, 2), padding="VALID",
    )
    return ((s + 2) >> 2).astype(jnp.uint8)


def subsample_422(chan: jnp.ndarray) -> jnp.ndarray:
    """Horizontal-only 2x box averaging for 4:2:2. [H, W] -> [H, W/2]
    uint8; W must be even. Round to nearest ((a+b+1)>>1). Same native
    reduce_window lowering rationale as subsample_420."""
    import jax.lax as lax

    s = lax.reduce_window(
        chan.astype(jnp.int32), 0, lax.add,
        window_dimensions=(1, 2), window_strides=(1, 2), padding="VALID",
    )
    return ((s + 1) >> 1).astype(jnp.uint8)


def level_shift(y: jnp.ndarray) -> jnp.ndarray:
    """uint8 -> int32 centered at zero (reference converter.c:60-90)."""
    return y.astype(jnp.int32) - 128
