"""Multi-chip color encode on the virtual mesh."""
import io

import numpy as np
import pytest
from PIL import Image

from jpegtpu import color_pipeline
from jpegtpu.config import EncodeConfig
from jpegtpu.parallel.sharding import make_mesh


def _rgb(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack(
        [(xx * 1.3) % 256, (yy * 1.7) % 256, ((xx + yy) * 0.9) % 256], axis=-1
    )
    return np.clip(base + rng.normal(0, 9, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("subsampling,n", [("420", 4), ("422", 4), ("444", 8)])
def test_sharded_color_equals_host_restart_stream(subsampling, n):
    """For shard-aligned dims the sharded color encode must be
    byte-identical to the host coder at restart_interval = MCUs/shard."""
    mcu_h, mcu_w = color_pipeline.mcu_dims(subsampling)
    h, w = mcu_h * n * 2, mcu_w * 4
    img = _rgb(h, w)
    got = color_pipeline.encode_color_sharded(
        img, EncodeConfig(subsampling=subsampling), mesh=make_mesh(n)
    )
    mcu_per_shard = (h // n // mcu_h) * (w // mcu_w)
    want = color_pipeline.encode_color(
        img,
        EncodeConfig(
            subsampling=subsampling,
            restart_interval=mcu_per_shard,
            entropy="host",
        ),
    )
    assert got == want


def test_sharded_color_decodes_like_single_chip():
    img = _rgb(100, 120, seed=3)
    single = color_pipeline.encode_color(img, EncodeConfig(subsampling="420"))
    shard = color_pipeline.encode_color_sharded(
        img, EncodeConfig(subsampling="420"), mesh=make_mesh(8)
    )
    a = np.asarray(Image.open(io.BytesIO(single)).convert("RGB"))
    b = np.asarray(Image.open(io.BytesIO(shard)).convert("RGB"))
    assert a.shape == b.shape == img.shape
    np.testing.assert_array_equal(a, b)


def test_sharded_color_optimized_pathological_degrades_gracefully():
    """Color optimize_huffman + dense noise past the 16-word capacity rung
    must not raise: the worst-case retry keeps the runtime tables,
    byte-equal to the host 2-pass at the shard restart interval, and
    decodes to the standard-table pixels."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (64, 64, 3), np.uint8)
    cfg = EncodeConfig(subsampling="420", quality=100, optimize_huffman=True)
    got = color_pipeline.encode_color_sharded(img, cfg, mesh=make_mesh(4))
    host = color_pipeline.encode_color(
        img, EncodeConfig(subsampling="420", quality=100,
                          optimize_huffman=True, restart_interval=4,
                          entropy="host")
    )
    assert got == host
    want = color_pipeline.encode_color_sharded(
        img, EncodeConfig(subsampling="420", quality=100), mesh=make_mesh(4)
    )
    a = np.asarray(Image.open(io.BytesIO(got)).convert("RGB"))
    b = np.asarray(Image.open(io.BytesIO(want)).convert("RGB"))
    np.testing.assert_array_equal(a, b)
