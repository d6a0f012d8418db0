"""On-card byte parity: device-produced streams vs the numpy host coder.

The CPU suite proves the XLA route at small sizes on XLA:CPU. What it
cannot show is what the GPU compiler makes of the same programs — a
float reduction in another order, a matmul lowered through TF32, a
fused loop that reads past a buffer. These cases re-run the byte-parity
oracles on the card, for every production path: gray, color 4:2:0 /
4:2:2 / 4:4:4, every capacity rung, restart segments, batches, 2-pass
optimal tables, int32 mode and on-device stuffing.

They skip unless JAX's default backend is a GPU (decided in the `gpu`
fixture at run time). chip_smoke.py runs them in its own process on the
card; by hand: `JAX_PLATFORMS=cuda python -m pytest -o addopts= -m gpu
tests/test_gpu_parity.py`.
"""
import dataclasses

import numpy as np
import pytest

from jpegtpu import batch, color_pipeline, pipeline
from jpegtpu.config import EncodeConfig

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]


def _gray(h, w, seed=0):
    """Photographic-complexity content: dense symbol coverage."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.7 + yy * 0.9) % 256 + 25 * np.sin(xx / 2.9) * np.cos(yy / 3.3)
    return np.clip(base + rng.normal(0, 10, (h, w)), 0, 255).astype(np.uint8)


def _rgb(h, w, seed=0):
    return np.stack([_gray(h, w, seed + s) for s in range(3)], axis=-1)


def _spiky(h, w, seed=1):
    """ZRL-stress content: flat background + isolated bright spikes =
    long zero runs and maximal-amplitude coefficients."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 128, np.uint8)
    ys = rng.integers(0, h, 160)
    xs = rng.integers(0, w, 160)
    img[ys, xs] = np.where(rng.random(160) < 0.5, 0, 255).astype(np.uint8)
    return img


# one gray and one color shape throughout, so the cases share compiled
# programs (each new shape costs a compile on the card)
G = (120, 168)
C = (112, 144)


def _host(cfg):
    return dataclasses.replace(cfg, entropy="host")


def _valid_jfif(data: bytes):
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


@pytest.mark.parametrize("quality", [50, 85])
def test_gray_device_bytes_equal_host(quality):
    img = _gray(*G, seed=quality)
    cfg = EncodeConfig(quality=quality)
    dev = pipeline.encode_grayscale(img, cfg)
    assert dev == pipeline.encode_grayscale(img, _host(cfg))
    _valid_jfif(dev)


def test_gray_zrl_stress_bytes_equal_host():
    img = _spiky(*G)
    cfg = EncodeConfig()
    assert pipeline.encode_grayscale(img, cfg) == pipeline.encode_grayscale(
        img, _host(cfg))


def test_gray_rounding_tie_content():
    """Uniform mid-tones land DC terms on .5 rounding boundaries."""
    img = np.tile(np.arange(256, dtype=np.uint8), (G[0], 1))[:, : G[1]]
    cfg = EncodeConfig()
    assert pipeline.encode_grayscale(img, cfg) == pipeline.encode_grayscale(
        img, _host(cfg))


@pytest.mark.parametrize("ss", ["420", "422", "444"])
def test_color_device_bytes_equal_host(ss):
    img = _rgb(*C, seed=7)
    cfg = EncodeConfig(subsampling=ss)
    dev = color_pipeline.encode_color(img, cfg)
    assert dev == color_pipeline.encode_color(img, _host(cfg))
    _valid_jfif(dev)


@pytest.mark.parametrize("cap", [16, 53])
@pytest.mark.parametrize("ss", ["gray", "420"])
def test_capacity_rungs_bytes_equal_host(ss, cap):
    cfg = EncodeConfig(subsampling=ss, capacity_words_per_block=cap)
    if ss == "gray":
        img = _gray(*G, seed=cap)
        got = pipeline.encode_grayscale(img, cfg)
        assert got == pipeline.encode_grayscale(img, _host(cfg))
    else:
        img = _rgb(*C, seed=cap)
        got = color_pipeline.encode_color(img, cfg)
        assert got == color_pipeline.encode_color(img, _host(cfg))


def test_q100_noise_takes_worst_case_rung():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, G, np.uint8)
    cfg = EncodeConfig(quality=100)
    assert pipeline.encode_grayscale(img, cfg) == pipeline.encode_grayscale(
        img, _host(cfg))


def test_gray_restart_device_bytes_equal_host():
    img = _gray(*G, seed=3)
    cfg = EncodeConfig(restart_interval=5)
    assert pipeline.encode_grayscale(img, cfg) == pipeline.encode_grayscale(
        img, _host(cfg))


def test_color_restart_device_bytes_equal_host():
    img = _rgb(*C, seed=4)
    cfg = EncodeConfig(subsampling="420", restart_interval=3)
    assert color_pipeline.encode_color(img, cfg) == color_pipeline.encode_color(
        img, _host(cfg))


def test_gray_batch_bytes_equal_singles():
    imgs = [_gray(*G, seed=s) for s in range(3)] + [_spiky(*G)]
    cfg = EncodeConfig()
    for img, data in zip(imgs, batch.encode_grayscale_batch(imgs, cfg)):
        assert data == pipeline.encode_grayscale(img, cfg)


def test_color_batch_bytes_equal_singles():
    imgs = [_rgb(*C, seed=10 + s) for s in range(3)]
    cfg = EncodeConfig(subsampling="420")
    for img, data in zip(imgs, batch.encode_color_batch(imgs, cfg)):
        assert data == color_pipeline.encode_color(img, cfg)


def test_gray_optimized_device_bytes_equal_host_two_pass():
    img = _gray(*G, seed=5)
    cfg = EncodeConfig(optimize_huffman=True)
    assert pipeline.encode_grayscale(img, cfg) == pipeline.encode_grayscale(
        img, _host(cfg))


def test_gray_restart_optimized_bytes_equal_host_two_pass():
    img = _gray(*G, seed=6)
    cfg = EncodeConfig(optimize_huffman=True, restart_interval=7)
    assert pipeline.encode_grayscale(img, cfg) == pipeline.encode_grayscale(
        img, _host(cfg))


@pytest.mark.parametrize("ss", ["420", "444"])
def test_color_optimized_device_bytes_equal_host_two_pass(ss):
    img = _rgb(*C, seed=6)
    cfg = EncodeConfig(subsampling=ss, optimize_huffman=True)
    assert color_pipeline.encode_color(img, cfg) == color_pipeline.encode_color(
        img, _host(cfg))


def test_int32_mode_stable_and_equals_host_entropy():
    img = _gray(*G, seed=8)
    cfg = EncodeConfig(dct_dtype="int32")
    a = pipeline.encode_grayscale(img, cfg)
    assert a == pipeline.encode_grayscale(img, cfg)  # run-to-run determinism
    assert a == pipeline.encode_grayscale(img, _host(cfg))


def test_int32_levels_equal_numpy_oracle():
    """The integer transform is exact by construction (every intermediate
    below 2^24); on the card its levels must equal a pure numpy int64
    recomputation."""
    from jpegtpu import tables

    img = _gray(*G, seed=21)
    cfg = EncodeConfig(dct_dtype="int32")
    got = pipeline.grayscale_coefficients(img, cfg)
    t8 = np.round(tables.dct_basis_reference(np.float64) * 2048).astype(np.int64)
    x = img.astype(np.int64) - 128
    nbh, nbw = img.shape[0] // 8, img.shape[1] // 8
    blks = x.reshape(nbh, 8, nbw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    y1 = (np.einsum("ux,nxy->nuy", t8, blks) + 1024) >> 11
    f = (np.einsum("nuy,vy->nuv", y1, t8) + 1024) >> 11
    q = cfg.luma_quant.astype(np.int64)
    mag = (2 * np.abs(f) + q) // (2 * q)
    lv = np.where(f < 0, -mag, mag).reshape(-1, 64)[:, tables.ZIGZAG_ORDER]
    np.testing.assert_array_equal(got, lv)


def test_int32_color_stable_and_equals_host_entropy():
    img = _rgb(*C, seed=22)
    for ss in ("420", "444"):
        cfg = EncodeConfig(subsampling=ss, dct_dtype="int32")
        a = color_pipeline.encode_color(img, cfg)
        assert a == color_pipeline.encode_color(img, cfg)
        assert a == color_pipeline.encode_color(img, _host(cfg))


def test_int32_batch_equals_singles():
    cfg = EncodeConfig(dct_dtype="int32")
    imgs = [_gray(*G, seed=50 + s) for s in range(3)]
    for im, o in zip(imgs, batch.encode_grayscale_batch(imgs, cfg)):
        assert o == pipeline.encode_grayscale(im, cfg)


def test_device_stuffing_equals_host_stuffing():
    """stuff="device" (on-device 0xFF stuffing) gives the same bytes as
    the default host stuffer."""
    img = _gray(*G, seed=9)
    assert pipeline.encode_grayscale(img, EncodeConfig(stuff="device")) == (
        pipeline.encode_grayscale(img, EncodeConfig())
    )
