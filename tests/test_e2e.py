"""End-to-end encode: decoder-as-oracle (SURVEY.md §4.3) + PSNR parity vs
the reference's own stream, + restart-marker stream equivalence."""
import io

import numpy as np
import pytest
from PIL import Image

from jpegtpu import EncodeConfig, encode_grayscale
from jpegtpu.io import bmp, jfif


def _decode(data: bytes) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    im.load()
    return np.asarray(im.convert("L")).astype(np.float64)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = ((a - b) ** 2).mean()
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _reference_file(golden) -> bytes:
    """Reconstruct the natural_c encoder's exact output file: its header
    block + the golden entropy stream."""
    cfg = EncodeConfig()
    return jfif.assemble(
        int(golden["orig_width"]),
        int(golden["orig_height"]),
        cfg,
        [golden["stream"].tobytes()],
    )


def test_reference_reconstruction_decodes(golden):
    """Sanity: our header writer + the reference's entropy bytes produce a
    decodable file with the right dimensions (proves header byte layout)."""
    data = _reference_file(golden)
    im = Image.open(io.BytesIO(data))
    im.load()
    assert im.size == (int(golden["orig_width"]), int(golden["orig_height"]))


def test_psnr_matches_reference(golden):
    if golden["bmp_path"] is None:
        pytest.skip("input bmp not available")
    rgb = bmp.read(golden["bmp_path"])
    orig_y = _decode_orig(golden["bmp_path"])
    ours = _decode(encode_grayscale(rgb, EncodeConfig()))
    theirs = _decode(_reference_file(golden))
    p_ours, p_theirs = _psnr(ours, orig_y), _psnr(theirs, orig_y)
    # Identical up to the boundary coin-flip coefficients.
    assert p_ours >= p_theirs - 0.01, (p_ours, p_theirs)


def _decode_orig(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("L")).astype(np.float64)


def test_restart_markers_equivalent(golden):
    """A restart-interval encode must decode to EXACTLY the same pixels as a
    single-segment encode (same coefficients, different stream layout) —
    the multi-chip stitching correctness property (SURVEY.md §5.7)."""
    if golden["bmp_path"] is None:
        pytest.skip("input bmp not available")
    rgb = bmp.read(golden["bmp_path"])
    base = _decode(encode_grayscale(rgb, EncodeConfig()))
    nb = int(golden["total_blocks"])
    interval = (nb + 3) // 4  # 4 segments
    with_rst = _decode(
        encode_grayscale(rgb, EncodeConfig(restart_interval=interval))
    )
    assert np.array_equal(base, with_rst)


def test_restart_device_bytes_equal_host_coder():
    """restart_interval with entropy="device" runs the segment-parallel
    device path (no host-coder fallback) and must emit the host coder's
    exact bytes — ragged final segment included (VERDICT r1 #5)."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (96, 72), dtype=np.uint8)  # 108 blocks
    for interval in (7, 25, 108, 500):
        dev = encode_grayscale(
            img, EncodeConfig(restart_interval=interval, entropy="device")
        )
        host = encode_grayscale(
            img, EncodeConfig(restart_interval=interval, entropy="host")
        )
        assert dev == host, interval


def test_restart_stitched_overflow_ladder():
    """Q100 noise overflows the heuristic capacity rung; the restart
    path must climb the ladder and still emit the host coder's exact
    bytes."""
    from jpegtpu import pipeline

    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    # quality 80: overflows rung 8, fits the rung 16 retry;
    # quality 100: overflows 16 too -> the worst-case rung 53
    for quality, want_rung in ((80, 16), (100, 53)):
        cfg = EncodeConfig(
            quality=quality, restart_interval=8, entropy="device"
        )
        key = (64, 64, cfg, False, "restart")
        pipeline._cap_history.pop(key, None)  # heuristic first rung
        dev = encode_grayscale(img, cfg)
        host = encode_grayscale(
            img,
            EncodeConfig(
                quality=quality, restart_interval=8, entropy="host"
            ),
        )
        assert dev == host, quality
        assert pipeline._cap_history.get(key, [0])[0] == want_rung


def test_restart_stitched_int32_bytes_equal_host_coder():
    """The restart path must hold byte parity in the integer-exact mode
    too."""
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (96, 72), dtype=np.uint8)
    for interval in (7, 54):
        dev = encode_grayscale(
            img,
            EncodeConfig(
                restart_interval=interval, entropy="device",
                dct_dtype="int32",
            ),
        )
        host = encode_grayscale(
            img,
            EncodeConfig(
                restart_interval=interval, entropy="host",
                dct_dtype="int32",
            ),
        )
        assert dev == host, interval


def test_restart_device_color_bytes_equal_host_coder():
    """Color device restart path: byte parity with the host coder across
    subsampling modes and ragged segment tails."""
    from jpegtpu import color_pipeline

    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (72, 56, 3), dtype=np.uint8)
    for ss in ("420", "444"):
        for interval in (2, 5):
            dev = color_pipeline.encode_color(
                img,
                EncodeConfig(
                    subsampling=ss, restart_interval=interval, entropy="device"
                ),
            )
            host = color_pipeline.encode_color(
                img,
                EncodeConfig(
                    subsampling=ss, restart_interval=interval, entropy="host"
                ),
            )
            assert dev == host, (ss, interval)


def test_color_restart_stitched_int32_bytes_equal_host_coder():
    """Color restart path under the integer-exact mode: byte
    parity with the host coder (420 covers the interleaved MCU merge +
    per-component DC resets on the int32 transform)."""
    from jpegtpu import color_pipeline

    rng = np.random.default_rng(15)
    img = rng.integers(0, 256, (72, 56, 3), dtype=np.uint8)
    for ss in ("420", "444"):
        dev = color_pipeline.encode_color(
            img,
            EncodeConfig(
                subsampling=ss, restart_interval=3, entropy="device",
                dct_dtype="int32",
            ),
        )
        host = color_pipeline.encode_color(
            img,
            EncodeConfig(
                subsampling=ss, restart_interval=3, entropy="host",
                dct_dtype="int32",
            ),
        )
        assert dev == host, ss


def test_pad_ones_still_decodes():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 40), dtype=np.uint8)
    for pad_ones in (True, False):
        a = _decode(encode_grayscale(img, EncodeConfig(pad_ones=pad_ones)))
        assert a.shape == (40, 40)


def test_non_multiple_of_8_dims():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (41, 53, 3), dtype=np.uint8)
    data = encode_grayscale(img)
    im = Image.open(io.BytesIO(data))
    assert im.size == (53, 41)


def test_quality_sweep_decodes_and_improves():
    rng = np.random.default_rng(2)
    # smooth-ish image so PSNR responds to quality
    x = np.linspace(0, 255, 64)
    img = np.clip(np.add.outer(x, x) / 2 + rng.normal(0, 8, (64, 64)), 0, 255).astype(np.uint8)
    psnrs, sizes = [], []
    for q in (10, 30, 50, 75, 95):
        data = encode_grayscale(img, EncodeConfig(quality=q))
        psnrs.append(_psnr(_decode(data), img.astype(np.float64)))
        sizes.append(len(data))
    assert psnrs == sorted(psnrs), psnrs
    assert sizes == sorted(sizes), sizes
