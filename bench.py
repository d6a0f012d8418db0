"""Benchmark: JPEG encode throughput on one GPU.

Prints ONE JSON line. Its primary metric is the baseline 4:2:0 color
encode of the reference's 12.19 MPix frame (grad.bmp geometry,
3024x4032), end to end from the caller's side: host pixels in, finished
JFIF bytes out. Secondary rows: grayscale, device-only times (input
already on the device, one scalar read back), restart segments, the
sharded entry point on one device, a 1024x512^2 batch, and 8K frames.
Every row is a median over BENCH_REPS runs after a warm-up, and the line
names the platform, device kind and device count it ran on. With no GPU
it exits non-zero: a measurement never falls back to the CPU.

Baseline (BASELINE.md): the reference's best DSP build encodes grad.bmp
in ~169.5M C7x cycles ~= 72 MPix/s at 1 GHz, for GRAYSCALE — the
reference has no color path (SURVEY.md §2.1).

    python bench.py [H W]
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

BASELINE_MPIX_S = 72.0


def make_image(h: int, w: int, color: bool = False, seed: int = 42):
    """Photographic-complexity synthetic: smooth gradient + structured
    texture + noise (roughly the report's grad.bmp regime)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = (xx + yy) * (255.0 / (h + w))
    tex = 20.0 * np.sin(xx / 3.1) * np.cos(yy / 2.7)
    g = np.clip(grad + tex + rng.normal(0, 6.0, (h, w)), 0, 255).astype(np.uint8)
    if not color:
        return g
    r = np.clip(grad * 0.9 + tex + rng.normal(0, 6.0, (h, w)), 0, 255)
    b = np.clip(grad * 1.1 - tex + rng.normal(0, 6.0, (h, w)), 0, 255)
    return np.stack([r.astype(np.uint8), g, b.astype(np.uint8)], axis=-1)


def _median_s(fn, reps: int) -> float:
    """Median wall time of fn() after one warm-up call (which compiles)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    import jax.numpy as jnp

    from jpegtpu import batch, color_pipeline, compile_cache, pipeline
    from jpegtpu.config import EncodeConfig
    from jpegtpu.entropy import device as entropy_device
    from jpegtpu.parallel import sharding

    compile_cache.enable()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; found {devs[0].platform}")
    device = {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
              "device_count": len(devs)}

    h, w = 3024, 4032
    if len(sys.argv) >= 3:
        h, w = int(sys.argv[1]), int(sys.argv[2])
    reps = int(os.environ.get("BENCH_REPS", "9"))
    mpix = h * w / 1e6
    luts = entropy_device.standard_luts()
    results: dict = {}

    gray = make_image(h, w)
    rgb = make_image(h, w, color=True)
    cfg = EncodeConfig()
    ccfg = EncodeConfig(subsampling="420")
    host = EncodeConfig(entropy="host")
    results["parity_gray"] = (
        pipeline.encode_grayscale(gray, cfg)
        == pipeline.encode_grayscale(gray, host)
    )
    results["parity_color"] = (
        color_pipeline.encode_color(rgb, ccfg)
        == color_pipeline.encode_color(
            rgb, EncodeConfig(subsampling="420", entropy="host"))
    )

    t = _median_s(lambda: pipeline.encode_grayscale(gray, cfg), reps)
    results["gray_e2e_mpix_s"] = mpix / t
    t_color = _median_s(lambda: color_pipeline.encode_color(rgb, ccfg), reps)

    # device only: input resident, one scalar read back
    g_pad = pipeline._pad_to_blocks(gray)
    ph, pw = g_pad.shape
    gfn = pipeline._encode_gray_device(ph, pw, cfg, False, 8, stuff=False)
    g_dev = jnp.asarray(g_pad)
    t = _median_s(lambda: jax.device_get(gfn(g_dev, luts)[1]), reps)
    results["gray_device_mpix_s"] = mpix / t
    cimg = color_pipeline._pad_color(rgb, "420")
    cfn = color_pipeline._encode_color_device(*cimg.shape[:2], ccfg, 8,
                                              stuff=False)
    c_dev = color_pipeline._planar(cimg)
    t = _median_s(lambda: jax.device_get(cfn(c_dev, luts)[1]), reps)
    results["color_device_mpix_s"] = mpix / t

    rcfg = EncodeConfig(restart_interval=pw // 8)  # one MCU row per segment
    t = _median_s(lambda: pipeline.encode_grayscale(gray, rcfg), reps)
    results["gray_restart_e2e_mpix_s"] = mpix / t
    t = _median_s(lambda: sharding.encode_grayscale_sharded(gray, cfg), reps)
    results["gray_sharded_e2e_mpix_s"] = mpix / t

    n_img = int(os.environ.get("BENCH_BATCH", "1024"))
    imgs = [make_image(512, 512, seed=i) for i in range(n_img)]
    t = _median_s(lambda: batch.encode_grayscale_batch(imgs, cfg),
                  max(3, reps // 3))
    results["batch_images"] = n_img
    results["batch_e2e_mpix_s"] = n_img * 512 * 512 / 1e6 / t
    del imgs

    if os.environ.get("BENCH_8K", "1") == "1":
        h8, w8 = 4320, 7680
        g8 = make_image(h8, w8)
        c8 = make_image(h8, w8, color=True)
        t = _median_s(lambda: pipeline.encode_grayscale(g8, cfg), 3)
        results["gray_8k_e2e_mpix_s"] = h8 * w8 / 1e6 / t
        t = _median_s(lambda: color_pipeline.encode_color(c8, ccfg), 3)
        results["color_8k_e2e_mpix_s"] = h8 * w8 / 1e6 / t

    color_mpix_s = mpix / t_color
    print(json.dumps({
        "metric": "color_420_encode_throughput",
        "value": color_mpix_s,
        "unit": "MPix/s",
        "vs_baseline": color_mpix_s / BASELINE_MPIX_S,
        **device,
        "parity": bool(results["parity_gray"] and results["parity_color"]),
        **results,
    }))


if __name__ == "__main__":
    main()
