"""Pipelined serving dispatch: order preservation + byte equality."""
import numpy as np
import pytest

from jpegtpu import color_pipeline, pipeline, serving
from jpegtpu.config import EncodeConfig


def _gray(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.clip(
        (xx * 1.3 + yy * 0.7) % 256 + rng.normal(0, 12, (h, w)), 0, 255
    ).astype(np.uint8)


def _rgb(h, w, seed):
    return np.stack([_gray(h, w, seed + s) for s in range(3)], axis=-1)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_gray_bytes_equal_singles_in_order(depth):
    cfg = EncodeConfig()
    # distinct shapes exercise per-shape executables inside one stream
    imgs = [_gray(48, 64, 1), _gray(64, 48, 2), _gray(48, 64, 3),
            _gray(40, 40, 4), _gray(48, 64, 5)]
    outs = list(serving.encode_stream(imgs, cfg, depth=depth))
    assert len(outs) == len(imgs)
    for im, o in zip(imgs, outs):
        assert o == pipeline.encode_grayscale(im, cfg)


@pytest.mark.parametrize("depth", [1, 2])
def test_stream_color_bytes_equal_singles_in_order(depth):
    cfg = EncodeConfig(subsampling="420")
    imgs = [_rgb(48, 64, 10), _rgb(64, 48, 20), _rgb(48, 64, 30)]
    outs = list(serving.encode_stream(imgs, cfg, color=True, depth=depth))
    for im, o in zip(imgs, outs):
        assert o == color_pipeline.encode_color(im, cfg)


def test_stream_is_lazy_generator():
    """Results must stream: after consuming k outputs, at most k + depth
    inputs have been pulled from the source iterator."""
    cfg = EncodeConfig()
    pulled = []

    def src():
        for s in range(6):
            pulled.append(s)
            yield _gray(48, 64, 100 + s)

    it = serving.encode_stream(src(), cfg, depth=2)
    next(it)
    assert len(pulled) <= 1 + 2


def test_stream_fallback_configs_still_stream_in_order():
    """Non-single-program configs (optimize_huffman, restart markers,
    host entropy) fall back to the blocking encoder but keep the
    streaming interface and byte equality."""
    imgs = [_gray(48, 64, 40), _gray(48, 64, 41)]
    for cfg in (
        EncodeConfig(optimize_huffman=True),
        EncodeConfig(restart_interval=4),
        EncodeConfig(entropy="host"),
    ):
        outs = list(serving.encode_stream(imgs, cfg))
        for im, o in zip(imgs, outs):
            assert o == pipeline.encode_grayscale(im, cfg)


def test_stream_overflow_image_falls_back_correctly():
    """An image whose content overflows the first capacity rung must
    still come back byte-equal to the blocking ladder encode, without
    disturbing its neighbors."""
    rng = np.random.default_rng(0)
    # Q=100 (quant divisors ~1) noise maximizes stream size ->
    # overflows the heuristic capacity rung
    hot = rng.integers(0, 256, (48, 64), np.uint8)
    cfg = EncodeConfig(quality=100)
    imgs = [_gray(48, 64, 50), hot, _gray(48, 64, 51)]
    outs = list(serving.encode_stream(imgs, cfg, depth=2))
    for im, o in zip(imgs, outs):
        assert o == pipeline.encode_grayscale(im, cfg)


def test_stream_depth_validation():
    with pytest.raises(ValueError):
        list(serving.encode_stream([_gray(8, 8, 0)], depth=0))


def test_capacity_history_learns_from_overflow():
    """Content-adaptive capacity: after one image at a (shape, config)
    site overflows the heuristic rung, later encodes there start at the
    rung that fit — no retry dispatch per image for a stream of
    pathological content."""
    rng = np.random.default_rng(1)
    hot = rng.integers(0, 256, (40, 48), np.uint8)
    cfg = EncodeConfig(quality=100)
    ref = pipeline.encode_grayscale(hot, cfg)  # pays the retry, records
    from jpegtpu.ops import blocks

    key = (*blocks.padded_dims(40, 48), cfg, False)
    rung = pipeline._cap_history.get(key, [0])[0]
    assert rung > cfg.capacity_words_per_block
    ladder = pipeline.capacity_ladder(cfg, key)
    assert ladder[0] == rung
    # the adapted ladder still produces identical bytes
    assert pipeline.encode_grayscale(hot, cfg) == ref


def test_capacity_history_decays():
    """A single pathological image must not pin an encode site at the
    worst rung forever: every _CAP_DECAY_PERIOD encodes the ladder
    probes one rung lower, and a success there overwrites the history
    (a ratchet-only history would pin the site for the process
    lifetime)."""
    cfg = EncodeConfig()
    key = ("decay-test", cfg)
    pipeline.record_cap(key, 16)  # as if one image needed the mid rung
    start = cfg.capacity_words_per_block
    probed = False
    for _ in range(pipeline._CAP_DECAY_PERIOD + 1):
        ladder = pipeline.capacity_ladder(cfg, key)
        if ladder[0] == start:
            probed = True
            # the probe fits normal content -> history decays
            pipeline.record_cap(key, start)
            break
        assert ladder[0] == 16
    assert probed
    assert pipeline.capacity_ladder(cfg, key)[0] == start
    pipeline._cap_history.pop(key, None)
