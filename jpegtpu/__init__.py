"""jpegtpu — a baseline JPEG encode engine on an accelerator, in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
strbac-damjan/jpeg-image-compression (BMP in -> baseline JFIF out): the
8x8 block pipeline (level shift, 2D DCT as block-diagonal matmuls,
quantization, zigzag, RLE, Huffman bit packing) runs over thousands of
blocks at once on the device, sharded across devices via jax.sharding
with restart-marker stream stitching.
"""
from .config import EncodeConfig
from .pipeline import encode_file, encode_grayscale, grayscale_coefficients

__version__ = "0.1.0"

__all__ = [
    "EncodeConfig",
    "encode_file",
    "encode_grayscale",
    "encode_color",
    "encode_stream",
    "grayscale_coefficients",
]


def encode_color(image, config=None):
    """RGB [H, W, 3] uint8 -> color baseline JFIF bytes (420/444).

    Deferred import: the color layout tables only build when used.
    """
    from . import color_pipeline

    return color_pipeline.encode_color(image, config)


def encode_stream(images, config=None, *, color=False, depth=2):
    """Pipelined serving encode: overlap device compute of image i+1
    with host fetch/stuff/assembly of image i (see jpegtpu.serving)."""
    from . import serving

    return serving.encode_stream(images, config, color=color, depth=depth)
