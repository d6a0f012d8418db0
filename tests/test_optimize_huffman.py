"""2-pass optimal Huffman tables: legality, decode parity, size wins."""
import io

import numpy as np
import pytest
from PIL import Image

from jpegtpu import color_pipeline, pipeline, tables
from jpegtpu.config import EncodeConfig


def _img(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.7 + yy * 0.9) % 256 + 18 * np.sin(xx / 3) * np.cos(yy / 4)
    return np.clip(base + rng.normal(0, 5, (h, w)), 0, 255).astype(np.uint8)


def test_optimal_spec_legality():
    rng = np.random.default_rng(1)
    for trial in range(5):
        freqs = np.zeros(256, np.int64)
        n = int(rng.integers(1, 180))
        idx = rng.choice(256, n, replace=False)
        freqs[idx] = rng.integers(1, 10000, n)
        bits, values = tables.optimal_spec(freqs)
        assert bits.sum() == n
        assert sorted(values) == sorted(idx)
        # Kraft inequality (strict: the all-ones code is reserved)
        kraft = sum(int(bits[l]) * 2 ** (15 - l) for l in range(16))
        assert kraft < 2 ** 16
        codes, lengths = tables.canonical_codes(bits, values)
        # prefix-free and no all-ones codeword
        seen = set()
        for s in idx:
            L = int(lengths[s])
            assert 1 <= L <= 16
            assert codes[s] != (1 << L) - 1, "all-ones code assigned"
            seen.add((L, int(codes[s])))
        assert len(seen) == n

    # single-symbol alphabet
    freqs = np.zeros(256, np.int64)
    freqs[42] = 7
    bits, values = tables.optimal_spec(freqs)
    assert list(values) == [42] and bits[0] == 1


def test_optimal_tables_beat_standard_rate():
    """Optimal tables must shrink the file while decoding to IDENTICAL
    pixels (same quantized coefficients, different entropy code)."""
    img = _img(96, 120, seed=3)
    cfg_std = EncodeConfig(entropy="host")
    cfg_opt = EncodeConfig(optimize_huffman=True)
    std = pipeline.encode_grayscale(img, cfg_std)
    opt = pipeline.encode_grayscale(img, cfg_opt)
    assert len(opt) < len(std)
    a = np.asarray(Image.open(io.BytesIO(std)).convert("L"))
    b = np.asarray(Image.open(io.BytesIO(opt)).convert("L"))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ss", ["420", "444"])
def test_optimal_tables_color(ss):
    # large enough that the optimal-code scan win clears the ~0.3% cost
    # of the floored table's full symbol coverage (floor_frequencies)
    img = np.stack([_img(128, 160, s) for s in range(3)], axis=-1)
    cfg_std = EncodeConfig(subsampling=ss, entropy="host")
    cfg_opt = EncodeConfig(subsampling=ss, optimize_huffman=True)
    std = color_pipeline.encode_color(img, cfg_std)
    opt = color_pipeline.encode_color(img, cfg_opt)
    assert len(opt) < len(std)
    a = np.asarray(Image.open(io.BytesIO(std)).convert("RGB"))
    b = np.asarray(Image.open(io.BytesIO(opt)).convert("RGB"))
    np.testing.assert_array_equal(a, b)


def test_optimal_tables_with_restart():
    img = _img(64, 64, seed=5)
    cfg = EncodeConfig(optimize_huffman=True, restart_interval=16)
    data = pipeline.encode_grayscale(img, cfg)
    plain = pipeline.encode_grayscale(img, EncodeConfig(entropy="host"))
    a = np.asarray(Image.open(io.BytesIO(plain)).convert("L"))
    b = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    np.testing.assert_array_equal(a, b)


def test_device_two_pass_matches_host_two_pass():
    """The device 2-pass (on-device histograms + runtime tables) must
    produce byte-identical files to the host 2-pass."""
    img = _img(96, 120, seed=3)
    dev = pipeline.encode_grayscale(img, EncodeConfig(optimize_huffman=True))
    host = pipeline.encode_grayscale(
        img, EncodeConfig(optimize_huffman=True, entropy="host")
    )
    assert dev == host


@pytest.mark.parametrize("ss", ["420", "422", "444"])
def test_color_device_two_pass_matches_host_two_pass(ss):
    rng = np.random.default_rng(11)
    img = np.stack([_img(96, 112, s) for s in range(3)], axis=-1)
    dev = color_pipeline.encode_color(
        img, EncodeConfig(subsampling=ss, optimize_huffman=True)
    )
    host = color_pipeline.encode_color(
        img, EncodeConfig(subsampling=ss, optimize_huffman=True,
                          entropy="host")
    )
    assert dev == host
    std = color_pipeline.encode_color(img, EncodeConfig(subsampling=ss))
    assert len(dev) < len(std)
    a = np.asarray(Image.open(io.BytesIO(std)).convert("RGB"))
    b = np.asarray(Image.open(io.BytesIO(dev)).convert("RGB"))
    np.testing.assert_array_equal(a, b)


def _gbatch(h, w, n, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return [
        np.clip((xx * 1.7 + yy * 0.9) % 256 + rng.normal(0, 10, (h, w)),
                0, 255).astype(np.uint8)
        for _ in range(n)
    ]


def test_batched_optimized_gray_shared_tables():
    """Batched 2-pass gray: O(1) dispatches with SHARED optimal tables.
    Oracle: host-encode the levels of each image with tables built from
    the SUMMED frequencies — must be byte-equal."""
    from jpegtpu import batch
    from jpegtpu.entropy import host as entropy_host
    from jpegtpu.io import jfif

    imgs = _gbatch(120, 512, 3)
    cfg = EncodeConfig(optimize_huffman=True)
    outs = batch.encode_grayscale_batch(imgs, cfg)

    zzs = [pipeline.grayscale_coefficients(im, cfg) for im in imgs]
    freqs = None
    for zz in zzs:
        f = entropy_host.symbol_frequencies(zz)
        freqs = f if freqs is None else {k: freqs[k] + f[k] for k in f}
    freqs = tables.floor_frequencies(freqs)  # every 2-pass path floors
    specs = {k: tables.optimal_spec(freqs[k]) for k in ("dc_lum", "ac_lum")}
    luts = tables.huffman_luts_from_specs(specs)
    for i, (im, zz) in enumerate(zip(imgs, zzs)):
        seg = entropy_host.encode_scan(zz, pad_ones=cfg.pad_ones, luts=luts)
        expect = jfif.assemble(im.shape[1], im.shape[0], cfg, seg,
                               huffman_specs=specs)
        assert outs[i] == expect, f"image {i}"
    # smaller than standard tables, and decodable
    plain = batch.encode_grayscale_batch(imgs, EncodeConfig())
    for o, p in zip(outs, plain):
        assert len(o) < len(p)
        Image.open(io.BytesIO(o)).load()


def test_batched_optimized_gray_over_mesh():
    from jpegtpu import batch
    from jpegtpu.parallel.sharding import make_mesh

    imgs = _gbatch(64, 128, 5, seed=12)
    cfg = EncodeConfig(optimize_huffman=True)
    assert batch.encode_grayscale_batch(imgs, cfg, mesh=make_mesh(4)) == (
        batch.encode_grayscale_batch(imgs, cfg)
    )


def test_batched_optimized_color_shared_tables():
    """Batched color 2-pass: shared optimal tables, byte-equal to the
    host coder with the same summed-frequency tables."""
    from jpegtpu import batch
    from jpegtpu.entropy import host as entropy_host
    from jpegtpu.io import jfif

    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[0:120, 0:512]
    base = (xx * 1.3 + yy * 0.7) % 256
    imgs = [
        np.stack(
            [np.clip(base + rng.normal(0, 9, (120, 512)) + 15 * c, 0, 255)
             for c in range(3)], axis=-1,
        ).astype(np.uint8)
        for _ in range(3)
    ]
    cfg = EncodeConfig(subsampling="420", optimize_huffman=True)
    outs = batch.encode_color_batch(imgs, cfg)

    freqs, zts = None, []
    for im in imgs:
        zz, tsel, comp = color_pipeline.color_coefficients(im, cfg)
        zts.append((im, zz, tsel, comp))
        f = entropy_host.symbol_frequencies(
            zz, table_sel=tsel.astype(np.int64), comp_id=comp
        )
        freqs = f if freqs is None else {k: freqs[k] + f[k] for k in f}
    freqs = tables.floor_frequencies(freqs)  # every 2-pass path floors
    specs = tables.optimal_specs_from_frequencies(freqs)
    luts = tables.huffman_luts_from_specs(specs)
    for i, (im, zz, tsel, comp) in enumerate(zts):
        seg = entropy_host.encode_scan(
            zz, table_sel=tsel.astype(np.int64), comp_id=comp,
            pad_ones=cfg.pad_ones, luts=luts,
        )
        expect = jfif.assemble(im.shape[1], im.shape[0], cfg, seg,
                               huffman_specs=specs)
        assert outs[i] == expect, f"image {i}"
        Image.open(io.BytesIO(outs[i])).load()


def test_batched_optimized_staged_shape_falls_back():
    """A bucket of ONE image (each of these shapes differs) shares its
    optimal tables with nobody: its batched 2-pass file must equal the
    single-image 2-pass encode."""
    from jpegtpu import batch

    imgs = _gbatch(48, 80, 1, seed=14) + _gbatch(40, 72, 1, seed=15)
    cfg = EncodeConfig(optimize_huffman=True)
    outs = batch.encode_grayscale_batch(imgs, cfg)
    for im, o in zip(imgs, outs):
        assert o == pipeline.encode_grayscale(im, cfg)


def test_batched_optimized_arbitrary_width_shared_tables():
    """Arbitrary widths ride the batched 2-pass (shared optimal tables)
    — streams must be valid and no larger than the standard-table
    batch."""
    from jpegtpu import batch

    imgs = _gbatch(48, 80, 2, seed=14)
    outs = batch.encode_grayscale_batch(
        imgs, EncodeConfig(optimize_huffman=True)
    )
    plain = batch.encode_grayscale_batch(imgs, EncodeConfig())
    for o, p, im in zip(outs, plain, imgs):
        assert len(o) <= len(p)
        a = np.asarray(Image.open(io.BytesIO(o)).convert("L"))
        b = np.asarray(Image.open(io.BytesIO(p)).convert("L"))
        np.testing.assert_array_equal(a, b)


def test_sharded_optimized_gray():
    """Sharded 2-pass optimal coding: per-shard histograms psum to
    global tables, pass 2 re-encodes with runtime tables. Pass 1 and
    pass 2 are separately compiled XLA programs whose f32 levels may
    split rounding ties, so frequencies are FLOORED
    (tables.floor_frequencies) — byte oracles are therefore
    cross-program-dependent; the contract is decode-equality with the
    standard-table sharded encode, a strictly smaller file, and a
    custom DHT in the header."""
    from jpegtpu.parallel.sharding import encode_grayscale_sharded, make_mesh

    rng = np.random.default_rng(9)
    h, w = 120, 168
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.clip(
        (xx * 1.7 + yy * 0.9) % 256 + rng.normal(0, 10, (h, w)), 0, 255
    ).astype(np.uint8)
    mesh = make_mesh(4)
    out = encode_grayscale_sharded(
        img, EncodeConfig(optimize_huffman=True), mesh=mesh
    )
    plain = encode_grayscale_sharded(img, EncodeConfig(), mesh=mesh)
    a = np.asarray(Image.open(io.BytesIO(out)).convert("L"))
    b = np.asarray(Image.open(io.BytesIO(plain)).convert("L"))
    np.testing.assert_array_equal(a, b)
    assert len(out) < len(plain)
    # floored tables: every emittable symbol must have a code (count the
    # declared AC values: 160 (run,size) + ZRL + EOB = 162, DC 12)
    from jpegtpu.io import jfif as _j  # header sanity via decode only
    assert out[:2] == b"\xff\xd8"


def test_floor_frequencies_covers_all_emittable():
    f = {"dc_lum": np.zeros(256, np.int64), "ac_lum": np.zeros(256, np.int64)}
    out = tables.floor_frequencies(f)
    assert out["dc_lum"][:12].min() == 1 and out["dc_lum"][12:].max() == 0
    ac = out["ac_lum"]
    assert ac[0x00] == 1 and ac[0xF0] == 1
    for r in range(16):
        for s in range(1, 11):
            assert ac[(r << 4) | s] == 1
    # specs from floored freqs must stay T.81-legal (<= 16-bit codes,
    # all-ones unassigned) and cover every symbol
    spec = tables.optimal_spec(out["ac_lum"])
    bits, values = spec
    assert sum(bits) == len(values) == 162


@pytest.mark.parametrize("ss", ["420", "422", "444"])
def test_sharded_optimized_color(ss):
    """Sharded color 2-pass optimal coding: decode-equal to the
    standard-table sharded encode and strictly smaller (see
    test_sharded_optimized_gray for the floored-frequency contract)."""
    from jpegtpu.parallel.sharding import make_mesh

    rng = np.random.default_rng(7)
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.3 + yy * 0.7) % 256
    img = np.stack(
        [np.clip(base + rng.normal(0, 9, (h, w)) + 15 * c, 0, 255)
         for c in range(3)], axis=-1,
    ).astype(np.uint8)
    mesh = make_mesh(4)
    out = color_pipeline.encode_color_sharded(
        img, EncodeConfig(subsampling=ss, optimize_huffman=True), mesh=mesh
    )
    plain = color_pipeline.encode_color_sharded(
        img, EncodeConfig(subsampling=ss), mesh=mesh
    )
    a = np.asarray(Image.open(io.BytesIO(out)).convert("RGB"))
    b = np.asarray(Image.open(io.BytesIO(plain)).convert("RGB"))
    np.testing.assert_array_equal(a, b)
    assert len(out) < len(plain)


def test_restart_device_two_pass_matches_host_two_pass():
    """optimize_huffman + restart_interval rides the device 2-pass
    (runtime-table segment machinery); its output must be byte-identical
    to the host 2-pass with the same config."""
    img = _img(96, 120, seed=21)
    cfg = EncodeConfig(optimize_huffman=True, restart_interval=16)
    dev = pipeline.encode_grayscale(img, cfg)
    host = pipeline.encode_grayscale(
        img, EncodeConfig(optimize_huffman=True, restart_interval=16,
                          entropy="host")
    )
    assert dev == host
    # and still decodes to the standard-table pixels
    plain = pipeline.encode_grayscale(img, EncodeConfig(entropy="host"))
    a = np.asarray(Image.open(io.BytesIO(plain)).convert("L"))
    b = np.asarray(Image.open(io.BytesIO(dev)).convert("L"))
    np.testing.assert_array_equal(a, b)
    assert len(dev) < len(
        pipeline.encode_grayscale(img, EncodeConfig(restart_interval=16))
    )


@pytest.mark.parametrize("ss", ["420", "444"])
def test_color_restart_device_two_pass_matches_host_two_pass(ss):
    img = np.stack([_img(96, 112, 30 + s) for s in range(3)], axis=-1)
    cfg = EncodeConfig(subsampling=ss, optimize_huffman=True,
                       restart_interval=8)
    dev = color_pipeline.encode_color(img, cfg)
    host = color_pipeline.encode_color(
        img, EncodeConfig(subsampling=ss, optimize_huffman=True,
                          restart_interval=8, entropy="host")
    )
    assert dev == host
    Image.open(io.BytesIO(dev)).load()


def test_restart_optimized_pathological_falls_back():
    """Dense noise past the heuristic capacity retries at the worst-case
    rung with the runtime tables, byte-equal to the host 2-pass."""
    rng = np.random.default_rng(17)
    img = rng.integers(0, 256, (64, 64), np.uint8)
    cfg = EncodeConfig(quality=100, optimize_huffman=True,
                       restart_interval=4)
    out = pipeline.encode_grayscale(img, cfg)
    want = pipeline.encode_grayscale(
        img, EncodeConfig(quality=100, optimize_huffman=True,
                          restart_interval=4, entropy="host")
    )
    assert out == want
    Image.open(io.BytesIO(out)).load()
