"""Multi-chip sharded encode: equivalence with single-chip semantics.

Runs on the virtual 8-device CPU mesh (conftest). The sharded encoder's
contract: shard = restart segment, so its output must be byte-identical to
the single-device host coder producing the same restart-interval stream,
and must decode to the same pixels as a no-restart single-chip encode.
"""
import io

import numpy as np
import pytest

import jax

from jpegtpu import pipeline
from jpegtpu.config import EncodeConfig
from jpegtpu.parallel import sharding


def _mesh(n):
    return sharding.make_mesh(n)


def _decode(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("L"))


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.7 + yy * 0.9) % 256
    return np.clip(base + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_stream_equals_host_restart_stream(n):
    """For shard-aligned dims, the sharded device encode must produce the
    exact bytes of the host coder at restart_interval = MCUs per shard."""
    h, w = 8 * n * 2, 64
    img = _image(h, w)
    mcu_per_shard = (h // n // 8) * (w // 8)
    got = sharding.encode_grayscale_sharded(img, EncodeConfig(), mesh=_mesh(n))
    want = pipeline.encode_grayscale(
        img, EncodeConfig(restart_interval=mcu_per_shard, entropy="host")
    )
    assert got == want


def test_sharded_decodes_like_single_chip():
    """Restart markers change the container, not the dequantized pixels:
    a sharded encode must decode to exactly the pixels of the single-chip
    no-restart encode (same quantized coefficients)."""
    img = _image(100, 120, seed=3)  # unaligned dims -> exercise padding
    single = pipeline.encode_grayscale(img, EncodeConfig())
    shard8 = sharding.encode_grayscale_sharded(img, EncodeConfig(), mesh=_mesh(8))
    a, b = _decode(single), _decode(shard8)
    # sharded path pads height to a multiple of 8*n; decoded dims match the
    # original in both cases because SOF0 carries original dims
    assert a.shape == b.shape == img.shape
    np.testing.assert_array_equal(a, b)


def test_sharded_lengths_replicated_and_consistent():
    """The all_gathered per-segment bit lengths must be REPLICATED across
    the mesh (every host can compute every offset without touching remote
    shards) and must match the actual packed segment sizes."""
    n = 4
    h, w = 8 * n, 32
    img = _image(h, w, seed=7)
    mesh = _mesh(n)
    cfg = EncodeConfig()
    ph, pw = sharding.shard_padded_dims(h, w, n)
    fn = sharding._sharded_encode_fn(
        mesh, ph, pw, cfg, False, cfg.capacity_words_per_block
    )
    import jax.numpy as jnp

    from jpegtpu.entropy import device as entropy_device

    streams, totals, overflow = fn(jnp.asarray(img),
                                   entropy_device.standard_luts())
    assert not bool(overflow)
    # totals is fully replicated: every device holds the whole [n, k]
    assert totals.sharding.is_fully_replicated
    streams_np, totals_np = jax.device_get((streams, totals))
    nshards, k, _w = streams_np.shape
    assert (nshards, k) == (n, 1)
    # each segment's bit count is byte-aligned and fits its valid words
    segs = sharding.gather_segments_multihost(streams, totals_np)
    host_segs = pipeline.entropy_host.encode_scan(
        pipeline.grayscale_coefficients(img, cfg),
        segment_ids=np.arange((ph // 8) * (pw // 8)) // ((ph // n // 8) * (pw // 8)),
        pad_ones=cfg.pad_ones,
    )
    assert segs == host_segs


def test_restart_subsegments_dri_cap():
    """Shards larger than DRI's 16-bit MCU limit split into equal
    sub-segments with interval <= 65535 (ADVICE round-1 fix)."""
    r = sharding.restart_subsegments(256, 512)  # 4096x4096 on 2 chips
    assert r <= 0xFFFF and 131072 % r == 0
    assert sharding.restart_subsegments(10, 10) == 100
    with pytest.raises(ValueError):
        EncodeConfig(restart_interval=70000)


def test_restart_subsegments_awkward_geometry():
    """No shard geometry may degrade to tiny segments: R is always at
    least one whole MCU row (ADVICE round-2 fix — prime row counts used
    to fall through to R=1)."""
    for rows, mpr in [
        (8191, 17),    # prime rows, total 139247 > 65535
        (7919, 7907),  # prime x prime, total ~62.6M
        (8192, 8191),  # max-geometry composite
        (6151, 31),    # prime rows
        (1, 8191),     # single prime row
        (65537, 1),    # degenerate 1-wide (beyond SOF dims, still legal here)
    ]:
        r = sharding.restart_subsegments(rows, mpr)
        total = rows * mpr
        assert 1 <= r <= 0xFFFF or r == total
        assert total % r == 0, (rows, mpr, r)
        if total > 0xFFFF:
            assert r >= min(mpr, 0xFFFF), (rows, mpr, r)
        else:
            assert r == total


def test_sharded_int32_stream_equals_host_restart_stream():
    """The int32 determinism claim across CHIP COUNTS: an 8-way sharded
    int32 encode must byte-equal the single-device host coder at the
    same restart interval (integer transform -> no mesh/backend can
    split a rounding tie)."""
    n = 8
    h, w = 8 * n * 2, 64
    img = _image(h, w, seed=11)
    mcu_per_shard = (h // n // 8) * (w // 8)
    cfg = EncodeConfig(dct_dtype="int32")
    got = sharding.encode_grayscale_sharded(img, cfg, mesh=_mesh(n))
    want = pipeline.encode_grayscale(
        img,
        EncodeConfig(
            dct_dtype="int32",
            restart_interval=mcu_per_shard,
            entropy="host",
        ),
    )
    assert got == want


def test_sharded_optimized_pathological_degrades_gracefully():
    """optimize_huffman + content past the 16-word capacity rung must
    not raise: the retry at the worst-case rung keeps the runtime tables,
    byte-equal to the host 2-pass at the shard restart interval, and
    decodes to the standard-table pixels."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (64, 64), np.uint8)  # dense noise
    cfg = EncodeConfig(quality=100, optimize_huffman=True)
    got = sharding.encode_grayscale_sharded(img, cfg, mesh=_mesh(8))
    host = pipeline.encode_grayscale(
        img, EncodeConfig(quality=100, optimize_huffman=True,
                          restart_interval=8, entropy="host")
    )
    assert got == host
    want = sharding.encode_grayscale_sharded(
        img, EncodeConfig(quality=100), mesh=_mesh(8)
    )
    assert np.array_equal(_decode(got), _decode(want))
