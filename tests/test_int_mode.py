"""Integer-mode transform: determinism and quality parity."""
import io

import numpy as np
from PIL import Image

from jpegtpu import pipeline
from jpegtpu.analysis import psnr
from jpegtpu.config import EncodeConfig


def _img(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.clip((xx * 1.1 + yy * 1.7) % 256 + rng.normal(0, 15, (h, w)), 0, 255).astype(
        np.uint8
    )


def test_int_mode_decodes_near_float_mode():
    img = _img(128, 160)
    f = pipeline.encode_grayscale(img, EncodeConfig(dct_dtype="float32"))
    i = pipeline.encode_grayscale(img, EncodeConfig(dct_dtype="int32"))
    df = np.asarray(Image.open(io.BytesIO(f)).convert("L"))
    di = np.asarray(Image.open(io.BytesIO(i)).convert("L"))
    pf, pi = psnr(img, df), psnr(img, di)
    # 11-bit fixed-point basis costs a small fraction of a dB at most
    assert pi > pf - 0.2, (pf, pi)


def test_int_mode_levels_are_integer_exact():
    """The int path must equal a pure numpy int64 recomputation exactly —
    the property that makes it backend-independent."""
    from jpegtpu import tables
    from jpegtpu.ops import int_transform

    img = _img(128, 128, seed=4)
    cfg = EncodeConfig(dct_dtype="int32")
    got = pipeline.grayscale_coefficients(img, cfg)

    t8 = np.round(tables.dct_basis_reference(np.float64) * 2048).astype(np.int64)
    x = img.astype(np.int64) - 128
    nbh, nbw = img.shape[0] // 8, img.shape[1] // 8
    blocks = x.reshape(nbh, 8, nbw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    y1 = np.einsum("ux,nxy->nuy", t8, blocks)
    y1 = (y1 + 1024) >> 11
    y2 = np.einsum("nuy,vy->nuv", y1, t8)
    f = (y2 + 1024) >> 11
    q = EncodeConfig().luma_quant.astype(np.int64)
    mag = (2 * np.abs(f) + q) // (2 * q)
    levels = np.where(f < 0, -mag, mag).reshape(-1, 64)[:, tables.ZIGZAG_ORDER]
    np.testing.assert_array_equal(got, levels)


def test_int_mode_stream_stable_across_runs():
    img = _img(96, 96, seed=9)
    cfg = EncodeConfig(dct_dtype="int32")
    a = pipeline.encode_grayscale(img, cfg)
    b = pipeline.encode_grayscale(img, cfg)
    assert a == b


def test_int_mode_color_deterministic_and_close_to_float():
    """dct_dtype='int32' now applies to the color path too: the stream
    must be identical across repeated encodes (determinism) and decode
    within a small PSNR delta of the float path."""
    import io

    from PIL import Image

    from jpegtpu import color_pipeline
    from jpegtpu.analysis import psnr

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    cfg_i = EncodeConfig(subsampling="420", dct_dtype="int32")
    a = color_pipeline.encode_color(img, cfg_i)
    b = color_pipeline.encode_color(img, cfg_i)
    assert a == b
    f = color_pipeline.encode_color(img, EncodeConfig(subsampling="420"))
    da = np.asarray(Image.open(io.BytesIO(a)).convert("RGB"), float)
    df = np.asarray(Image.open(io.BytesIO(f)).convert("RGB"), float)
    for c in range(3):
        pi = psnr(img[..., c].astype(float), da[..., c])
        pf = psnr(img[..., c].astype(float), df[..., c])
        assert abs(pi - pf) < 0.2, (c, pi, pf)


def test_int_levels_match_numpy_oracle_across_tables():
    """The integer transform (ops/int_transform) must equal a pure numpy
    int64 recomputation for every quant table and basis — the property
    that makes dct_dtype='int32' streams identical on every backend."""
    import jax.numpy as jnp

    from jpegtpu import tables
    from jpegtpu.ops import int_transform

    for q, bitexact in ((50, True), (85, True), (25, False)):
        cfg = EncodeConfig(quality=q, dct_dtype="int32", bitexact=bitexact)
        rng = np.random.default_rng(q)
        img = rng.integers(0, 256, (128, 1024), np.uint8)
        got = np.asarray(
            int_transform.transform_tiled_int(
                jnp.asarray(img),
                jnp.asarray(cfg.luma_quant.astype(np.float32)),
                bitexact=bitexact,
            )
        )
        basis = (tables.dct_basis_reference if bitexact
                 else tables.dct_basis)(np.float64)
        t8 = np.round(basis * 2048).astype(np.int64)
        x = img.astype(np.int64) - 128
        blk = x.reshape(16, 8, 128, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        y1 = (np.einsum("ux,nxy->nuy", t8, blk) + 1024) >> 11
        f = (np.einsum("nuy,vy->nuv", y1, t8) + 1024) >> 11
        qt = cfg.luma_quant.astype(np.int64)
        mag = (2 * np.abs(f) + qt) // (2 * qt)
        ref = np.where(f < 0, -mag, mag).reshape(-1, 64)[:, tables.ZIGZAG_ORDER]
        np.testing.assert_array_equal(got, ref)


def test_int_mode_stream_matches_host_coder():
    """End-to-end agreement: the int32 device stream must byte-equal the
    host coder run on the same int levels."""
    from jpegtpu.io import jfif
    from jpegtpu.entropy import host as entropy_host

    img = _img(104, 136, seed=3)
    cfg = EncodeConfig(dct_dtype="int32")
    dev = pipeline.encode_grayscale(img, cfg)
    zz = pipeline.grayscale_coefficients(img, cfg)
    segs = entropy_host.encode_scan(zz, pad_ones=cfg.pad_ones)
    hst = jfif.assemble(img.shape[1], img.shape[0], cfg, segs)
    assert dev == hst


def test_int_mode_batch_matches_single():
    """The batched path in int32 mode must emit per-image streams
    identical to single-image encodes."""
    from jpegtpu import batch

    cfg = EncodeConfig(dct_dtype="int32")
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (4, 64, 64), np.uint8)
    outs = batch.encode_grayscale_batch(imgs, cfg)
    for i in range(4):
        assert outs[i] == pipeline.encode_grayscale(imgs[i], cfg), i


def test_int_mode_color_batch_matches_single():
    from jpegtpu import batch, color_pipeline

    cfg = EncodeConfig(subsampling="420", dct_dtype="int32")
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (2, 64, 64, 3), np.uint8)
    outs = batch.encode_color_batch(imgs, cfg)
    for i in range(2):
        assert outs[i] == color_pipeline.encode_color(imgs[i], cfg), i


def test_int_mode_optimized_device_2pass():
    """optimize_huffman rides the device 2-pass in int32 mode (runtime
    tables); the stream must decode to the same pixels as the
    standard-table int32 stream and be smaller or equal in size for
    natural content."""
    img = _img(96, 128, seed=5)
    cfg_o = EncodeConfig(dct_dtype="int32", optimize_huffman=True)
    cfg_s = EncodeConfig(dct_dtype="int32")
    o = pipeline.encode_grayscale(img, cfg_o)
    s = pipeline.encode_grayscale(img, cfg_s)
    do = np.asarray(Image.open(io.BytesIO(o)).convert("L"))
    ds = np.asarray(Image.open(io.BytesIO(s)).convert("L"))
    np.testing.assert_array_equal(do, ds)
    assert len(o) <= len(s), (len(o), len(s))
