"""The XLA device route at every capacity rung, against the host coder.

Every device encode is one XLA program per (shape, config, capacity
rung): transform, symbolize, per-block shift-or pack, block or segment
concat. These cases drive each layout (gray, 4:2:0, 4:2:2, 4:4:4) at
each rung of the capacity ladder (8, 16 and the worst case, 53 words per
block), with and without restart segments, at sizes that are not whole
MCUs, and require the numpy host coder's exact bytes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jpegtpu import color_pipeline, pipeline, tables
from jpegtpu.config import EncodeConfig
from jpegtpu.entropy import device, host


def _photo(h, w, seed, color=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.7 + yy * 0.9) % 256 + 12 * np.sin(xx / 2.9) * np.cos(yy / 3.3)
    shape = (h, w, 3) if color else (h, w)
    noise = rng.normal(0, 6, shape)
    if color:
        base = base[..., None] + np.array([0.0, 20.0, -20.0])
    return np.clip(base + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("restart", [0, 1])
@pytest.mark.parametrize("cap", [8, 16, 53])
@pytest.mark.parametrize("ss", ["gray", "420", "422", "444"])
def test_device_equals_host_coder(ss, cap, restart):
    cfg = EncodeConfig(subsampling=ss, capacity_words_per_block=cap,
                       restart_interval=5 * restart)
    hcfg = dataclasses.replace(cfg, entropy="host")
    if ss == "gray":
        img = _photo(37, 53, seed=cap + restart)
        key = (40, 56, cfg, False) + (("restart",) if restart else ())
        got = pipeline.encode_grayscale(img, cfg)
        want = pipeline.encode_grayscale(img, hcfg)
    else:
        img = _photo(45, 71, seed=cap + restart, color=True)
        ph, pw = color_pipeline.padded_dims_color(45, 71, ss)
        key = (ph, pw, cfg, "color-restart" if restart else "color")
        got = color_pipeline.encode_color(img, cfg)
        want = color_pipeline.encode_color(img, hcfg)
    assert got == want
    # the requested rung itself encoded (no overflow retry)
    assert pipeline._cap_history[key][0] == cap


@pytest.mark.parametrize("tsel", ["luma", "chroma", "per_block"])
def test_ac_lookup_matches_table_gather(tsel):
    """The AC code lookup picks each block's table and symbol."""
    sym = np.arange(256 * 63, dtype=np.int32).reshape(256, 63) % 256
    ac_codes, ac_lens = device.standard_luts()[2:]
    ac_codes, ac_lens = jnp.asarray(ac_codes), jnp.asarray(ac_lens)
    if tsel == "per_block":
        sel = np.arange(256) % 2
        arg = jnp.asarray(sel)
    else:
        sel = np.full(256, 0 if tsel == "luma" else 1)
        arg = int(sel[0])
    codes, lens = device._ac_lookup(jnp.asarray(sym), arg, ac_codes, ac_lens)
    want_codes, want_lens = device.standard_luts()[2:]
    for j in range(0, 256 * 63, 97):
        b, k = divmod(j, 63)
        assert int(codes[b, k]) == want_codes[sel[b], sym[b, k]]
        assert int(lens[b, k]) == want_lens[sel[b], sym[b, k]]


def test_runtime_tables_default_to_annex_k():
    """luts=None and the explicit Annex-K stacked tables give one stream."""
    rng = np.random.default_rng(3)
    zz = (rng.standard_normal((70, 64)) * np.geomspace(150, 0.3, 64)).astype(
        np.int32)
    fn = jax.jit(device.encode_scan_device)
    a = fn(jnp.asarray(zz))
    b = fn(jnp.asarray(zz), luts=tables.stacked_luts())
    assert int(a[1]) == int(b[1])
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


def test_stacked_luts_fill_missing_classes():
    """A grayscale 2-pass table set (luma only) keeps Annex-K chroma."""
    freqs = {"dc_lum": np.arange(256) < 12, "ac_lum": np.ones(256, np.int64)}
    specs = {k: tables.optimal_spec(tables.floor_frequencies(
        {k: np.asarray(v, np.int64)})[k]) for k, v in freqs.items()}
    custom = tables.huffman_luts_from_specs(specs)
    dc_c, dc_l, ac_c, ac_l = tables.stacked_luts(custom)
    std = tables.huffman_luts()
    np.testing.assert_array_equal(ac_c[0], custom["ac_lum"][0])
    np.testing.assert_array_equal(ac_l[1], std["ac_chrom"][1])
    np.testing.assert_array_equal(dc_c[1], std["dc_chrom"][0][:16])
    assert dc_c.shape == (2, 16) and ac_l.shape == (2, 256)


def test_segment_streams_equal_host_segments():
    """encode_segments_device: one byte-aligned stream per restart
    segment, ragged last segment zero-padded, each equal to the host
    coder's segment."""
    rng = np.random.default_rng(5)
    nb, seg = 45, 8
    zz = (rng.standard_normal((nb, 64)) * np.geomspace(200, 0.3, 64)).astype(
        np.int32)
    n_total = -(-nb // seg) * seg
    zp = np.pad(zz, ((0, n_total - nb), (0, 0)))
    dcd = device.dc_differences(jnp.asarray(zp[:, 0]), seg)
    streams, totals, ovf = jax.jit(
        lambda z, d: device.encode_segments_device(z, seg, nb, 0, d, 16)
    )(jnp.asarray(zp), dcd)
    assert not bool(ovf)
    got = pipeline.segments_from_streams(np.asarray(streams), np.asarray(totals))
    want = host.encode_scan(zz, segment_ids=np.arange(nb) // seg)
    assert got == want
