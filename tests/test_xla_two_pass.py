"""2-pass optimal tables as runtime data on the XLA route.

Pass 1 histograms the levels on the device, the host builds the tables,
and pass 2 runs the same compiled encode with the tables as arguments.
Single images, restart segments, batches (tables shared by a shape
bucket) and sharded encodes must all equal the host 2-pass built from
the same floored frequencies.
"""
import numpy as np
import pytest

from jpegtpu import batch, color_pipeline, pipeline, tables
from jpegtpu.config import EncodeConfig
from jpegtpu.entropy import host
from jpegtpu.io import jfif
from jpegtpu.parallel import sharding


def _photo(h, w, seed, color=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.3 + yy * 0.7) % 256 + 10 * np.sin(xx / 3.7)
    shape = (h, w, 3) if color else (h, w)
    if color:
        base = base[..., None] + np.array([0.0, 15.0, -15.0])
    return np.clip(base + rng.normal(0, 8, shape), 0, 255).astype(np.uint8)


def _oracle(imgs, cfg):
    """Host 2-pass with tables from the SUMMED, floored frequencies of
    every image (what a batch bucket shares)."""
    parts, freqs = [], None
    for im in imgs:
        if cfg.subsampling == "gray":
            zz = pipeline.grayscale_coefficients(im, cfg)
            kw = {}
        else:
            zz, tsel, comp = color_pipeline.color_coefficients(im, cfg)
            kw = dict(table_sel=tsel.astype(np.int64), comp_id=comp)
        f = host.symbol_frequencies(zz, **kw)
        freqs = f if freqs is None else {k: freqs[k] + f[k] for k in f}
        parts.append((im, zz, kw))
    freqs = tables.floor_frequencies(freqs)
    classes = (pipeline.GRAY_CLASSES if cfg.subsampling == "gray"
               else color_pipeline.COLOR_CLASSES)
    specs = {k: tables.optimal_spec(freqs[k]) for k in classes}
    luts = tables.huffman_luts_from_specs(specs)
    return [
        jfif.assemble(im.shape[1], im.shape[0], cfg,
                      host.encode_scan(zz, pad_ones=cfg.pad_ones, luts=luts,
                                       **kw),
                      huffman_specs=specs)
        for im, zz, kw in parts
    ]


def _encode(img, cfg):
    if cfg.subsampling == "gray":
        return pipeline.encode_grayscale(img, cfg)
    return color_pipeline.encode_color(img, cfg)


@pytest.mark.parametrize("mode", ["single", "restart", "batch"])
@pytest.mark.parametrize("ss", ["gray", "420", "422", "444"])
def test_two_pass_device_equals_host(ss, mode):
    color = ss != "gray"
    cfg = EncodeConfig(subsampling=ss, optimize_huffman=True,
                       restart_interval=3 if mode == "restart" else 0)
    if mode == "batch":
        imgs = [_photo(40, 56, seed=s, color=color) for s in range(3)]
        enc = batch.encode_color_batch if color else batch.encode_grayscale_batch
        assert enc(imgs, cfg) == _oracle(imgs, cfg)
        return
    img = _photo(43, 61, seed=7, color=color)
    host_cfg = EncodeConfig(subsampling=ss, optimize_huffman=True,
                            restart_interval=cfg.restart_interval,
                            entropy="host")
    assert _encode(img, cfg) == _encode(img, host_cfg)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("color", [False, True])
def test_mixed_size_batch(color, optimize):
    """Several shape buckets in one call: files come back in input order;
    plain files equal single-image encodes, 2-pass files equal the host
    2-pass with the tables their bucket shares."""
    sizes = [(40, 56), (24, 88), (40, 56), (17, 33), (24, 88)]
    imgs = [_photo(h, w, seed=i, color=color) for i, (h, w) in enumerate(sizes)]
    cfg = EncodeConfig(subsampling="420" if color else "gray",
                       optimize_huffman=optimize)
    enc = batch.encode_color_batch if color else batch.encode_grayscale_batch
    got = enc(imgs, cfg)
    if not optimize:
        assert got == [_encode(im, cfg) for im in imgs]
        return
    for size in set(sizes):
        idx = [i for i, s in enumerate(sizes) if s == size]
        want = _oracle([imgs[i] for i in idx], cfg)
        assert [got[i] for i in idx] == want, size


@pytest.mark.parametrize("ss", ["gray", "420"])
def test_sharded_two_pass_equals_host_restart(ss):
    """Sharded 2-pass: psum'd histograms give the host 2-pass tables at
    the shard restart interval, byte for byte (4-device mesh)."""
    mesh = sharding.make_mesh(4)
    cfg = EncodeConfig(subsampling=ss, optimize_huffman=True)
    if ss == "gray":
        img = _photo(64, 48, seed=3)
        got = sharding.encode_grayscale_sharded(img, cfg, mesh=mesh)
        seg = (64 // 4 // 8) * (48 // 8)
    else:
        img = _photo(128, 48, seed=4, color=True)
        got = color_pipeline.encode_color_sharded(img, cfg, mesh=mesh)
        seg = (128 // 4 // 16) * (48 // 16)
    want = _encode(img, EncodeConfig(subsampling=ss, optimize_huffman=True,
                                     restart_interval=seg, entropy="host"))
    assert got == want
