"""Pipelined serving dispatch: overlapped device/host execution for
image streams.

`encode_stream` keeps up to `depth` encodes in flight: while the device
runs the jitted encode of image i+1 (JAX dispatch is asynchronous), the
host fetches, bit-stuffs, and JFIF-assembles image i, hiding the
host-side work behind device compute — the serving pattern of the
reference's deployment (host service + DSP offload, dsp main.c:433-519,
where the host writes JPEG n while the DSP crunches n+1). The gain on a
given card is not measured yet.

Correctness: output order is input order (FIFO); each stream is
byte-identical to the corresponding single-image `encode_grayscale` /
`encode_color` (asserted by tests/test_serving.py). Capacity overflow
(pathological content) falls back to the blocking ladder encode for
that image only.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import jax.numpy as jnp

from . import color_pipeline
from .config import EncodeConfig
from .entropy import device as entropy_device
from .io import jfif
from .ops import blocks
from . import pipeline


def _submit_gray(image: np.ndarray, cfg: EncodeConfig, host_stuff: bool):
    is_rgb = image.ndim == 3
    h, w = image.shape[:2]
    ph, pw = blocks.padded_dims(h, w)
    if (ph, pw) != (h, w):
        pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (image.ndim - 2)
        image = np.pad(image, pad, mode="edge")
    # same history key as the blocking encoder (_encode_segment_device):
    # an overflow discovered by the fallback teaches later submissions.
    cap = pipeline.capacity_ladder(cfg, (ph, pw, cfg, is_rgb))[0]
    fn = pipeline._encode_gray_device(
        ph, pw, cfg, is_rgb, cap, stuff=not host_stuff
    )
    out, count, overflowed = fn(jnp.asarray(image), entropy_device.standard_luts())
    return {
        "out": out, "count": count, "overflow": overflowed,
        "w": w, "h": h, "spec_key": (ph, pw, cfg, "serve"),
    }


def _submit_color(image: np.ndarray, cfg: EncodeConfig, host_stuff: bool):
    h, w = image.shape[:2]
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    ph, pw = color_pipeline.padded_dims_color(h, w, cfg.subsampling)
    if (ph, pw) != (h, w):
        image = np.pad(
            image, [(0, ph - h), (0, pw - w), (0, 0)], mode="edge"
        )
    # same history key as color_pipeline.encode_color's device site
    cap = pipeline.capacity_ladder(cfg, (ph, pw, cfg, "color"))[0]
    fn = color_pipeline._encode_color_device(
        ph, pw, cfg, cap, stuff=not host_stuff
    )
    planar = jnp.asarray(np.ascontiguousarray(np.moveaxis(image, -1, 0)))
    out, count, overflowed = fn(planar, entropy_device.standard_luts())
    return {
        "out": out, "count": count, "overflow": overflowed,
        "w": w, "h": h, "spec_key": (ph, pw, cfg, "serve-color"),
    }


def _finish(pend: dict, image: np.ndarray, cfg: EncodeConfig,
            host_stuff: bool, color: bool) -> bytes:
    if host_stuff:
        from . import native

        words, total_bits = pipeline.fetch_stream_words(
            pend["out"], pend["count"], pend["overflow"],
            spec_key=pend["spec_key"],
        )
        if words is not None:
            seg = native.words_to_stuffed(words, total_bits)
            return jfif.assemble(pend["w"], pend["h"], cfg, [seg])
    elif not bool(pend["overflow"]):
        seg = pipeline.fetch_prefix(pend["out"], pend["count"]).tobytes()
        return jfif.assemble(pend["w"], pend["h"], cfg, [seg])
    # capacity overflow (first-rung cap too small for this content):
    # blocking ladder encode for this image only.
    if color:
        return color_pipeline.encode_color(image, cfg)
    return pipeline.encode_grayscale(image, cfg)


def encode_stream(
    images: Iterable[np.ndarray],
    config: EncodeConfig | None = None,
    *,
    color: bool = False,
    depth: int = 2,
) -> Iterator[bytes]:
    """Encode a stream of images with `depth` overlapped dispatches.

    Yields JFIF byte strings in input order. depth=1 degenerates to
    sequential (still one program per image, same bytes). Requires
    `entropy="device"`, no restart markers, no optimize_huffman — the
    single-program serving configuration; anything else falls back to
    the blocking per-image encoder (still streamed, no overlap).
    """
    config = config or EncodeConfig()
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    fallback = (
        config.entropy != "device"
        or bool(config.restart_interval)
        or config.optimize_huffman
    )
    if fallback:
        enc = color_pipeline.encode_color if color else pipeline.encode_grayscale
        for img in images:
            yield enc(img, config)
        return
    host_stuff = config.stuff == "host" and pipeline._native_available()
    submit = _submit_color if color else _submit_gray
    queue: deque = deque()
    for img in images:
        queue.append((submit(img, config, host_stuff), img))
        if len(queue) >= depth:
            pend, im = queue.popleft()
            yield _finish(pend, im, config, host_stuff, color)
    while queue:
        pend, im = queue.popleft()
        yield _finish(pend, im, config, host_stuff, color)


def encode_stream_list(
    images: Iterable[np.ndarray],
    config: EncodeConfig | None = None,
    *,
    color: bool = False,
    depth: int = 2,
) -> list[bytes]:
    """Eager list variant of `encode_stream`."""
    return list(encode_stream(images, config, color=color, depth=depth))
