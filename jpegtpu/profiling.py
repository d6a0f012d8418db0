"""Per-stage profiling harness — the reference's cycle report.

The reference reads the C7x __TSC counter around every pipeline stage and
prints a per-stage cycle table (dsp jpeg_compression.c:125-186, host
pretty-printer main.c:137-172). XLA fuses our stages into one program, so
per-stage numbers require running staged sub-programs: this harness jits
successive PREFIXES of the production encode body and reports deltas.

Device rows are measured dispatch-floor-free with the chain-delta trick
(time a program that runs the prefix k times on perturbed inputs, minus
a 1x run, divided by k-1), so the fixed per-dispatch cost does not land
on the first stage. The host row (stream download + native byte
stuffing) is wall-clock, since that's what production pays.

For real kernel-level traces use `jax.profiler.trace(logdir)` around
`encode_*` and open the Perfetto/TensorBoard view; this module is the
lightweight always-available equivalent of the reference's printf report.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np

from .config import EncodeConfig
from .entropy import device as entropy_device
from . import pipeline


@dataclasses.dataclass
class StageTiming:
    name: str
    total_ms: float  # cumulative prefix time
    stage_ms: float  # delta attributed to this stage
    mpix_per_s: float


def _chain_ms(body, img_dev, reps: int, k: int = 3) -> float:
    """Dispatch-floor-free time of one `body(img)` evaluation."""

    def chain(n):
        @jax.jit
        def fn(img):
            tot = jnp.float32(0)
            for i in range(n):
                r = body(img ^ jnp.uint8(i))
                tot = tot + sum(
                    jnp.sum(x, dtype=jnp.float32) for x in jax.tree.leaves(r)
                )
            return tot

        return fn

    f1, fk = chain(1), chain(k)
    jax.device_get((f1(img_dev), fk(img_dev)))  # compile + warm

    def t(f):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.device_get(f(img_dev))
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    return max((t(fk) - t(f1)) / (k - 1), 1e-9) * 1000


def _rows_from_prefixes(prefixes, img_dev, mpix: float, reps: int):
    results, prev = [], 0.0
    for name, body in prefixes:
        # clamp to monotone: chain-delta noise at sub-ms stages can
        # produce a cumulative reading below the previous prefix
        total = max(_chain_ms(body, img_dev, reps), prev)
        results.append(
            StageTiming(
                name=name,
                total_ms=round(total, 2),
                stage_ms=round(total - prev, 2),
                mpix_per_s=(
                    round(mpix / (total / 1000), 1) if total > 1e-6 else 0.0
                ),
            )
        )
        prev = total
    return results


def profile_encode(
    image: np.ndarray, config: EncodeConfig | None = None, reps: int = 5
) -> list[StageTiming]:
    """Stage-attributed timings of the PRODUCTION grayscale device encode
    (the exact default path of pipeline.encode_grayscale: tiled transform
    to levels -> symbolize + per-block pack -> block-stream concat ->
    host-native byte stuffing)."""
    config = config or EncodeConfig()
    is_rgb = image.ndim == 3
    h, w = image.shape[:2]
    image = pipeline._pad_to_blocks(image)
    ph, pw = image.shape[:2]
    cap = config.capacity_words_per_block
    mpix = h * w / 1e6
    img_dev = jnp.asarray(image)

    def levels(img):
        return pipeline._gray_levels(img, config, is_rgb)

    def block_pack(img):
        zz = levels(img).astype(jnp.int32)
        dcd = entropy_device.dc_differences(zz[:, 0], 0)
        return entropy_device._per_block_words(zz, 0, dcd, cap)

    def full(img):
        words, count, _ = pipeline.gray_encode_body(
            img, config, is_rgb, cap, False
        )
        return words, count

    prefixes = [
        ("transform", levels),
        ("block pack", block_pack),
        ("concat", full),
    ]
    results = _rows_from_prefixes(prefixes, img_dev, mpix, reps)

    # Host finish: stream download + native stuffing (production tail),
    # wall-clock because production pays the transfer here.
    fbody = jax.jit(
        lambda img: pipeline.gray_encode_body(img, config, is_rgb, cap,
                                              False)
    )
    out, count, ovf = fbody(img_dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        words, total_bits = pipeline.fetch_stream_words(
            out, count, ovf, spec_key=(ph, pw, "profile")
        )
        if words is not None:
            from . import native

            if native.available():
                native.words_to_stuffed(words, total_bits)
        ts.append(time.perf_counter() - t0)
    host_ms = min(ts) * 1000
    total = results[-1].total_ms + host_ms
    results.append(
        StageTiming(
            name="fetch+stuff(host)",
            total_ms=round(total, 2),
            stage_ms=round(host_ms, 2),
            mpix_per_s=round(mpix / (total / 1000), 1),
        )
    )
    return results


def profile_encode_color(
    image: np.ndarray, config: EncodeConfig | None = None, reps: int = 5
) -> list[StageTiming]:
    """Stage-attributed timings of the production color encode
    (color_pipeline.encode_color: convert + subsample + per-component
    transforms -> per-class packs + MCU merge + concat)."""
    from . import color_pipeline as cp

    config = config or EncodeConfig(subsampling="420")
    h, w = image.shape[:2]
    image = cp._pad_color(image, config.subsampling)
    cap = config.capacity_words_per_block
    mpix = h * w / 1e6
    img_dev = cp._planar(image)

    def levels(img):
        return cp._component_levels(img, config)

    def full(img):
        words, count, _ = cp.color_encode_body(img, config, cap, False)
        return words, count

    prefixes = [("convert+dct", levels), ("pack+concat", full)]
    return _rows_from_prefixes(prefixes, img_dev, mpix, reps)


def format_report(stages: list[StageTiming], h: int, w: int) -> str:
    """Pretty table, the analog of the reference's print_profiling_stats
    (dsp main.c:137-172)."""
    lines = [f"encode profile {w}x{h} ({h * w / 1e6:.2f} MPix)"]
    lines.append(
        f"{'stage':<16}{'stage ms':>10}{'cum ms':>10}{'cum MPix/s':>12}"
    )
    for s in stages:
        lines.append(
            f"{s.name:<16}{s.stage_ms:>10.2f}{s.total_ms:>10.2f}"
            f"{s.mpix_per_s:>12.1f}"
        )
    return "\n".join(lines)
