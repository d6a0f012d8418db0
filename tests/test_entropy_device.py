"""On-device entropy coder vs the host reference implementation.

The host coder (jpegtpu.entropy.host) is itself locked to the reference's
semantics by test_entropy_host.py and the golden `stream` fixtures; the
device coder must reproduce its output byte-for-byte.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jpegtpu.entropy import device, host


def _device_stream(zz, seg_len=0, pad_ones=True, table_sel=0, packer="tree"):
    nb = zz.shape[0]
    fn = jax.jit(
        functools.partial(
            device.encode_scan_device,
            seg_len=seg_len,
            pad_ones=pad_ones,
            capacity_words=nb * device.MAX_WORDS_PER_BLOCK,
            table_sel=table_sel,
            packer=packer,
        )
    )
    buf, n, overflow = fn(jnp.asarray(zz))
    assert not bool(overflow)
    return bytes(np.asarray(buf)[: int(n)])


def _random_levels(nb, seed=0, scale=200.0):
    rng = np.random.default_rng(seed)
    zz = (
        rng.standard_normal((nb, 64)) * np.geomspace(scale, 0.3, 64)[None, :]
    ).astype(np.int32)
    zz[nb // 3] = 0  # all-zero block -> immediate EOB
    zz[nb // 2, 1:] = 0  # DC-only block
    if nb > 7:
        zz[7, 1:] = 0
        zz[7, 63] = 99  # no-EOB block with maximal run (3 ZRLs + escape)
    return zz


@pytest.mark.parametrize("packer", ["tree", "scatter"])
@pytest.mark.parametrize("nb", [1, 3, 64, 257])
def test_matches_host_random(nb, packer):
    zz = _random_levels(nb, seed=nb)
    ref = host.encode_scan(zz, pad_ones=True)[0]
    assert _device_stream(zz, packer=packer) == ref


def test_matches_host_pad_zeros():
    zz = _random_levels(33, seed=9)
    ref = host.encode_scan(zz, pad_ones=False)[0]
    assert _device_stream(zz, pad_ones=False) == ref


def test_matches_host_chrominance_tables():
    zz = _random_levels(65, seed=3, scale=60.0)
    ref = host.encode_scan(zz, table_sel=np.ones(65, np.int64), pad_ones=True)[0]
    assert _device_stream(zz, table_sel=1) == ref


def test_extreme_amplitudes_fit_capacity():
    """Max-magnitude coefficients everywhere: the static worst-case capacity
    bound must hold and the stream must still match the host coder."""
    zz = np.full((16, 64), 1023, dtype=np.int32)
    zz[::2] *= -1
    ref = host.encode_scan(zz, pad_ones=True)[0]
    assert _device_stream(zz) == ref


def test_dc_segment_reset_matches_host_segments():
    """seg_len resets the DC predictor exactly like per-segment host encodes;
    with byte-aligned per-segment packing the concatenation of host segments
    equals the device stream only when each segment is packed separately, so
    compare segment-by-segment."""
    seg = 8
    zz = _random_levels(40, seed=5)
    seg_ids = np.arange(40) // seg
    ref_segments = host.encode_scan(zz, segment_ids=seg_ids, pad_ones=True)
    for s in range(5):
        part = zz[s * seg : (s + 1) * seg]
        assert _device_stream(part) == ref_segments[s]
    # and the device seg_len path must produce segment-local DC diffs
    dc_dev = np.asarray(device.dc_differences(jnp.asarray(zz[:, 0]), seg))
    dc_ref = host.dc_differences(zz[:, 0], segment_ids=seg_ids)
    np.testing.assert_array_equal(dc_dev, dc_ref)


def test_golden_stream_parity(golden):
    """Device entropy output must byte-match the reference encoder's entropy
    stream captured from natural_c (pad bits are 0s there, huffman.c:65-81)."""
    zz = golden["zigzag"].astype(np.int32)
    got = _device_stream(zz, pad_ones=False)
    assert got == golden["stream"].tobytes()


class TestMergeStreams:
    """The MCU-interleave merges (treepack.merge_adjacent_t /
    merge_two_t) against a big-integer concatenation of the streams."""

    def test_matches_numpy_concat(self):
        from jpegtpu.entropy import treepack

        rng = np.random.default_rng(7)
        n, e, cap = 300, 6, 4
        # random streams: bit length 0..cap*32, MSB-aligned, zero beyond
        bits = rng.integers(0, cap * 32 + 1, size=(n, e)).astype(np.int32)
        bits[::7, 2] = 0  # empty streams merge too
        words = rng.integers(0, 1 << 32, size=(n, e, cap), dtype=np.uint64)
        words = words.astype(np.uint32)
        for i in range(n):
            for s in range(e):
                b = int(bits[i, s])
                for j in range(cap):
                    lo = max(0, min(32, b - 32 * j))
                    mask = (0xFFFFFFFF << (32 - lo)) & 0xFFFFFFFF if lo else 0
                    words[i, s, j] &= np.uint32(mask)

        def ref_merge(ws, bs):
            big = 0
            tot = 0
            for s in range(e):
                b = int(bs[s])
                val = 0
                for j in range(cap):
                    val = (val << 32) | int(ws[s, j])
                val >>= cap * 32 - b  # right-align the b valid bits
                big = (big << b) | val
                tot += b
            out = np.zeros(e * cap, np.uint32)
            big <<= e * cap * 32 - tot  # MSB-align
            for j in range(e * cap - 1, -1, -1):
                out[j] = big & 0xFFFFFFFF
                big >>= 32
            return out, tot

        # streams 0..3 as adjacent column pairs (the 4:2:0 Y fold), then
        # 4||5 (Cb||Cr), then Y||C — the color MCU merge order
        w_t = jnp.asarray(words[:, :4].reshape(n * 4, cap).T)
        b_t = jnp.asarray(bits[:, :4].reshape(n * 4))
        w_y, b_y = treepack.merge_adjacent_t(w_t, b_t)
        w_y, b_y = treepack.merge_adjacent_t(w_y, b_y)
        w_c = jnp.asarray(words[:, 4:].reshape(n * 2, cap).T)
        b_c = jnp.asarray(bits[:, 4:].reshape(n * 2))
        w_c, b_c = treepack.merge_adjacent_t(w_c, b_c)
        merged, tot = treepack.merge_two_t(w_y, b_y, w_c, b_c)
        merged = np.asarray(merged).T
        tot = np.asarray(tot)
        for i in range(0, n, 7):
            exp_w, exp_b = ref_merge(words[i], bits[i])
            assert tot[i] == exp_b
            np.testing.assert_array_equal(merged[i], exp_w, err_msg=f"row {i}")
