"""Native C++ host runtime vs the numpy reference implementations."""
import numpy as np
import pytest

from jpegtpu import native
from jpegtpu.entropy import host

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native runtime unavailable (no g++?)"
)


def test_stuff_bytes_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 4096, 65537):
        raw = rng.integers(0, 256, n, dtype=np.uint8)
        raw[::17] = 0xFF  # force plenty of stuffing
        assert native.stuff_bytes(raw) == host.stuff_bytes(raw)


def test_stuff_all_ff():
    raw = np.full(1000, 0xFF, dtype=np.uint8)
    out = native.stuff_bytes(raw)
    assert len(out) == 2000
    assert out == host.stuff_bytes(raw)


def test_pack_codes_matches_numpy():
    rng = np.random.default_rng(1)
    for n in (1, 100, 50_000):
        lengths = rng.integers(0, 27, n).astype(np.int64)
        values = rng.integers(0, 1 << 26, n).astype(np.uint64) & (
            (np.uint64(1) << lengths.astype(np.uint64)) - np.uint64(1)
        )
        for pad_ones in (True, False):
            got = native.pack_codes(
                values.astype(np.uint32), lengths.astype(np.uint8), pad_ones
            )
            want = host._pack_bits_numpy(values, lengths, pad_ones)
            assert got == want


def test_words_to_stuffed_matches_numpy():
    rng = np.random.default_rng(2)
    words = rng.integers(0, 1 << 32, 5000, dtype=np.int64).astype(np.uint32)
    for total_bits in (0, 8, 31 * 8, 5000 * 32, 4999 * 32 + 8):
        nbytes = (total_bits + 7) // 8
        raw = (
            np.stack(
                [(words >> 24) & 0xFF, (words >> 16) & 0xFF,
                 (words >> 8) & 0xFF, words & 0xFF],
                axis=1,
            )
            .astype(np.uint8)
            .reshape(-1)[:nbytes]
        )
        assert native.words_to_stuffed(words, total_bits) == host.stuff_bytes(raw)


def test_host_pack_bits_uses_native_transparently():
    """encode_scan output must be identical whichever packer backs it."""
    rng = np.random.default_rng(3)
    zz = (rng.standard_normal((64, 64)) * 40).astype(np.int32)
    a = host.encode_scan(zz)[0]
    sym = host.symbolize(zz)
    # recompute via the numpy-only path
    import jpegtpu.entropy.host as h

    orig = native.available
    try:
        native_available_false = lambda: False
        native.available = native_available_false
        b = host.encode_scan(zz)[0]
    finally:
        native.available = orig
    assert a == b


def test_native_bmp_decode_matches_numpy():
    """The C++ BMP pixel pass must equal the numpy slicing path bit for
    bit (flip + BGR->RGB), including 4-byte row padding."""
    import numpy as np
    from jpegtpu import native
    from jpegtpu.io import bmp

    if not native.available():
        import pytest

        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(5)
    for h, w in ((7, 5), (16, 33), (1, 1)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        data = bmp.encode(img)
        dec = bmp.decode(data)
        np.testing.assert_array_equal(dec, img)
        # numpy reference path
        import struct

        _, _, _, offset = struct.unpack_from("<HIII", data, 0)
        stride = (w * 3 + 3) & ~3
        raw = np.frombuffer(data, np.uint8, count=stride * h, offset=offset)
        rows = raw.reshape(h, stride)[:, : w * 3].reshape(h, w, 3)[::-1]
        np.testing.assert_array_equal(dec, rows[..., ::-1])
