"""Batch encode: output parity with single-image encodes."""
import numpy as np

from jpegtpu import batch, pipeline
from jpegtpu.config import EncodeConfig


def _img(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.clip((xx + 2 * yy) % 256 + rng.normal(0, 10, (h, w)), 0, 255).astype(
        np.uint8
    )


def test_batch_matches_single():
    """Every stream from a mixed-shape batch must be byte-identical to the
    single-image encode of the same image."""
    images = [
        _img(64, 64, 0),
        _img(64, 64, 1),
        _img(48, 80, 2),  # different bucket
        _img(60, 60, 3),  # needs padding
        _img(64, 64, 4),
    ]
    cfg = EncodeConfig()
    got = batch.encode_grayscale_batch(images, cfg)
    for i, img in enumerate(images):
        assert got[i] == pipeline.encode_grayscale(img, cfg), f"image {i}"


def test_batch_data_parallel_over_mesh():
    """Batch axis sharded across the 8-device mesh must produce identical
    files to the single-device batch (pure DP, no collectives)."""
    from jpegtpu.parallel.sharding import make_mesh

    images = [_img(40, 40, s) for s in range(6)]
    cfg = EncodeConfig()
    plain = batch.encode_grayscale_batch(images, cfg)
    sharded = batch.encode_grayscale_batch(images, cfg, mesh=make_mesh(8))
    assert sharded == plain


def test_color_batch_matches_single():
    rng = np.random.default_rng(1)
    imgs = [
        np.clip(rng.normal(128, 40, (48, 64, 3)), 0, 255).astype(np.uint8)
        for _ in range(3)
    ]
    imgs.append(np.clip(rng.normal(100, 30, (32, 32, 3)), 0, 255).astype(np.uint8))
    from jpegtpu import color_pipeline

    cfg = EncodeConfig(subsampling="420")
    got = batch.encode_color_batch(imgs, cfg)
    for i, img in enumerate(imgs):
        assert got[i] == color_pipeline.encode_color(img, cfg), f"image {i}"


def test_batch_bucket_padding_images_ignored():
    """Batch sizes are padded to powers of two with dummy images; the
    dummies must not leak into results (3 images -> bucket of 4)."""
    images = [_img(32, 32, s) for s in range(3)]
    got = batch.encode_grayscale_batch(images)
    assert len(got) == 3
    assert all(isinstance(b, bytes) and b[:2] == b"\xff\xd8" for b in got)


def test_batch_pallas_segment_concat_parity():
    """Per-image block counts that are multiples of 128 (whole radix-4
    tree levels in the batched segment concat) must stay byte-identical
    to single-image encodes."""
    cfg = EncodeConfig()
    # gray: 128x64 -> nb = 16*8 = 128
    images = [_img(128, 64, s) for s in range(3)]
    got = batch.encode_grayscale_batch(images, cfg)
    for i, img in enumerate(images):
        assert got[i] == pipeline.encode_grayscale(img, cfg), f"gray {i}"

    # color 4:2:0: 256x128 -> nmcu = 16*8 = 128 MCU slots per image
    from jpegtpu import color_pipeline

    ccfg = EncodeConfig(subsampling="420")
    rng = np.random.default_rng(9)
    rgbs = [
        rng.integers(0, 256, (256, 128, 3), dtype=np.uint8) for _ in range(2)
    ]
    gotc = batch.encode_color_batch(rgbs, ccfg)
    for i, img in enumerate(rgbs):
        assert gotc[i] == color_pipeline.encode_color(img, ccfg), f"color {i}"


def test_batch_raw_plane_parity():
    """Wide batch shapes (512, 1024 and 2048 columns, pad rows) must
    stay byte-identical to single encodes."""
    cfg = EncodeConfig()
    # 512-wide images
    images = [_img(120, 512, s) for s in range(4)]
    got = batch.encode_grayscale_batch(images, cfg)
    for i, img in enumerate(images):
        assert got[i] == pipeline.encode_grayscale(img, cfg), f"512w {i}"
    # width 1024, non-64-multiple height
    images = [_img(72, 1024, 10 + s) for s in range(2)]
    got = batch.encode_grayscale_batch(images, cfg)
    for i, img in enumerate(images):
        assert got[i] == pipeline.encode_grayscale(img, cfg), f"1024w {i}"
    # 2048-wide images
    images = [_img(64, 2048, 20 + s) for s in range(2)]
    got = batch.encode_grayscale_batch(images, cfg)
    for i, img in enumerate(images):
        assert got[i] == pipeline.encode_grayscale(img, cfg), f"2048w {i}"


def test_batch_raw_plane_parity_over_mesh():
    """The batched path inside shard_map (16 images over 8 devices)
    must match single-image encodes."""
    from jpegtpu.parallel.sharding import make_mesh

    cfg = EncodeConfig()
    images = [_img(64, 512, 30 + s) for s in range(16)]
    got = batch.encode_grayscale_batch(images, cfg, mesh=make_mesh(8))
    for i, img in enumerate(images):
        assert got[i] == pipeline.encode_grayscale(img, cfg), f"mesh {i}"


def _rgb(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.3 + yy * 0.7) % 256
    return np.stack(
        [
            np.clip(base + rng.normal(0, 9, (h, w)) + 15 * c, 0, 255)
            for c in range(3)
        ],
        axis=-1,
    ).astype(np.uint8)


def test_color_batch_raw_plane_parity():
    """Batched color must stay byte-identical to single encodes for
    every subsampling mode over narrow, wide and non-MCU-multiple
    shapes."""
    from jpegtpu import color_pipeline

    cases = [
        ("420", (128, 128), 3),
        ("422", (128, 256), 5),
        ("444", (64, 128), 4),
        ("420", (120, 512), 3),   # non-MCU-multiple height
        ("420", (128, 2048), 2),
        ("420", (64, 4096), 2),
    ]
    for ss, (h, w), n in cases:
        cfg = EncodeConfig(subsampling=ss)
        imgs = [_rgb(h, w, 40 + s) for s in range(n)]
        got = batch.encode_color_batch(imgs, cfg)
        for i, img in enumerate(imgs):
            assert got[i] == color_pipeline.encode_color(img, cfg), (
                ss, (h, w), i,
            )


def test_color_batch_raw_over_mesh():
    """The batched color path inside shard_map must match single-image
    encodes."""
    from jpegtpu import color_pipeline
    from jpegtpu.parallel.sharding import make_mesh

    cfg = EncodeConfig(subsampling="420")
    imgs = [_rgb(128, 128, 60 + s) for s in range(6)]
    got = batch.encode_color_batch(imgs, cfg, mesh=make_mesh(4))
    for i, img in enumerate(imgs):
        assert got[i] == color_pipeline.encode_color(img, cfg), f"mesh {i}"


def test_batch_restart_and_host_entropy_route_per_image():
    """ADVICE r3 (high): the batched bodies emit single-segment streams
    with no RSTn markers and always pack on-device — restart-interval or
    host-entropy configs must ride the per-image encoders (which route
    these correctly), for both plain and optimize_huffman batches."""
    from jpegtpu import color_pipeline

    gimgs = [_img(48, 64, 70), _img(48, 64, 71)]
    cimgs = [np.stack([_img(32, 64, 80 + s + c) for c in range(3)], axis=-1)
             for s in range(2)]
    for cfg in (
        EncodeConfig(restart_interval=4),
        EncodeConfig(entropy="host"),
        EncodeConfig(restart_interval=4, optimize_huffman=True),
        EncodeConfig(entropy="host", optimize_huffman=True),
    ):
        got = batch.encode_grayscale_batch(gimgs, cfg)
        for i, img in enumerate(gimgs):
            assert got[i] == pipeline.encode_grayscale(img, cfg), (cfg, i)
    for cfg in (
        EncodeConfig(subsampling="420", restart_interval=4),
        EncodeConfig(subsampling="420", restart_interval=4,
                     optimize_huffman=True),
    ):
        got = batch.encode_color_batch(cimgs, cfg)
        for i, img in enumerate(cimgs):
            assert got[i] == color_pipeline.encode_color(img, cfg), (cfg, i)


def test_gray_batch_raw_arbitrary_widths():
    """ANY width batches, byte-equal to single encodes (760/640/1366/200
    columns: none a power of two)."""
    cfg = EncodeConfig()
    cases = [(48, 760, 2), (64, 640, 3), (40, 1366, 2), (56, 200, 5)]
    for h, w, n in cases:
        imgs = [_img(h, w, 90 + s) for s in range(n)]
        got = batch.encode_grayscale_batch(imgs, cfg)
        for i, img in enumerate(imgs):
            assert got[i] == pipeline.encode_grayscale(img, cfg), (h, w, i)


def test_color_batch_raw_arbitrary_widths():
    """Color twin of the arbitrary-width coverage: non-pow2 chroma
    widths batch byte-equal to single encodes."""
    from jpegtpu import color_pipeline

    cases = [("420", 48, 760, 2), ("420", 64, 1360, 2),
             ("444", 40, 200, 3), ("422", 48, 328, 3)]
    for ss, h, w, n in cases:
        cfg = EncodeConfig(subsampling=ss)
        imgs = [_rgb(h, w, 120 + s) for s in range(n)]
        got = batch.encode_color_batch(imgs, cfg)
        for i, img in enumerate(imgs):
            assert got[i] == color_pipeline.encode_color(img, cfg), (
                ss, (h, w), i,
            )


def test_mixed_geometry_batch():
    """One call with several arbitrary geometries: every bucket rides
    its own program; files come back in input order, byte-equal."""
    imgs = [_img(48, 760, 1), _img(64, 640, 2), _img(48, 760, 3),
            _img(56, 200, 4), _img(64, 512, 5)]
    cfg = EncodeConfig()
    got = batch.encode_grayscale_batch(imgs, cfg)
    for i, img in enumerate(imgs):
        assert got[i] == pipeline.encode_grayscale(img, cfg), f"image {i}"
