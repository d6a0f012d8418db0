"""On-device entropy coder: RLE symbolization + Huffman bit packing in JAX.

The reference's entropy tail is serial scalar code (natural_c rle.c:51-131,
huffman.c:121-192; DSP rle.c:50-199, huffman.c:190-260 — a 64-bit
accumulator BitWriter). Here both stages are reformulated as dense,
fixed-shape tensor ops so the whole encode — pixels to stuffed entropy
bytes — runs on device and only the final compressed bytes cross the host
boundary (SURVEY.md §7.1 step 3).

Design:
  * Symbolization is per-lane slot assignment: dense fixed-shape tensors
    of (Huffman-code value, bit length) pairs in exact emission order.
    Two layouts: [nb, 65, 3] (symbolize_slots, the scatter packer's) and
    the power-of-two [nb, 64, 5] (symbolize_elements64: DC fused into
    element 0, EOB into element 62 — every element <= 83 bits). Empty
    slots have length 0 and contribute nothing, so no compaction /
    ragged shapes are ever materialized (SURVEY.md §7.4 #4).
  * Bit packing (default `packer="tree"`): the sub-slots fuse
    elementwise into 3-word elements, each block's 64 elements reduce in
    a log-depth shift-or tree, and the per-block streams merge the same
    way (entropy.treepack). Stuffing runs on-device (prefix-sum +
    scatter) or, by default, on the host via the native C++ runtime
    (caller passes stuff=False).
  * `packer="scatter"` keeps the direct formulation — exclusive cumsum
    of slot bit lengths, then a scatter-add of each slot's one-or-two
    word contributions (bit-disjoint, so add == or); retained as the
    cross-check implementation.
  * Huffman tables are DATA (`luts`, tables.stacked_luts), so one
    compiled program serves the Annex-K tables and every 2-pass optimal
    table set.

Everything is shape-static under jit; the only dynamic quantity is the
returned byte count.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables
from ..ops.scan import cumsum_1d

_ZRL = 0xF0
_EOB = 0x00

# Worst-case entropy bits for one 8x8 block (SURVEY.md §7.4 capacity note):
# DC <= 11-bit code (chroma table) + 11 amplitude bits = 22; budgeted here
# as 20 with the slack argument below. 63 AC lanes <= 16 + 10 each; <= 3
# ZRLs of 11 bits; EOB 4. The summed terms cannot co-occur (63 maximal ACs
# leave no zero runs for any ZRL, and a block ending in a nonzero AC emits
# no EOB), so the true worst case is ~1660 bits — the 2-bit DC shortfall
# vs the chroma table sits well inside that ~35-bit slack. Overflow is
# detected (AssertionError), never silent corruption.
MAX_BITS_PER_BLOCK = 20 + 63 * 26 + 3 * 11 + 4  # = 1695
MAX_WORDS_PER_BLOCK = (MAX_BITS_PER_BLOCK + 31) // 32  # = 53


@functools.lru_cache(maxsize=None)
def standard_luts():
    """Annex-K tables in the stacked device form (tables.stacked_luts).

    Kept numpy (not jnp) so the lru_cache never captures trace-time
    values — each trace embeds its own constant (jax
    UnexpectedTracerError otherwise)."""
    return tables.stacked_luts()


def _ac_lookup(sym: jnp.ndarray, tsel, ac_codes, ac_lens):
    """Huffman (code, length) for AC symbol bytes: a gather from the
    [2, 256] tables. (A one-hot (run, size) contraction against the
    tables measured 7-10x slower on an NVIDIA H100.)
    sym: [nb, 63] int32; tsel: static int or [nb] table selector.
    Returns (codes u32, lens i32).
    """
    if isinstance(tsel, int):
        return ac_codes[tsel][sym], ac_lens[tsel][sym]
    return ac_codes[tsel[:, None], sym], ac_lens[tsel[:, None], sym]


def magnitude_category(v: jnp.ndarray) -> jnp.ndarray:
    """JPEG size category = bit length of |v| (rle.c:9-22), via count-
    leading-zeros — the DSP port's __norm trick (dsp rle.c:10-19)."""
    mag = jnp.abs(v).astype(jnp.int32)
    return (32 - jax.lax.clz(mag)).astype(jnp.int32)


def amplitude_code(v: jnp.ndarray, size: jnp.ndarray) -> jnp.ndarray:
    """Amplitude bits: v if v > 0 else v - 1, masked to `size` bits
    (rle.c:24-35)."""
    raw = jnp.where(v > 0, v, v - 1).astype(jnp.int32)
    mask = (jnp.uint32(1) << size.astype(jnp.uint32)) - 1
    return raw.astype(jnp.uint32) & mask


def dc_differences(dc: jnp.ndarray, seg_len: int) -> jnp.ndarray:
    """DC difference along scan order with the predictor reset at each
    restart-segment start (T.81 F.1.2.3). seg_len=0 -> single chain, the
    reference's global lastDC (rle.c:59-70)."""
    nb = dc.shape[0]
    prev = jnp.concatenate([jnp.zeros((1,), dc.dtype), dc[:-1]])
    if seg_len:
        idx = jnp.arange(nb)
        prev = jnp.where(idx % seg_len == 0, 0, prev)
    return dc - prev


def _lane_codes(
    zz: jnp.ndarray,
    table_sel: jnp.ndarray | int = 0,
    dc_diff: jnp.ndarray | None = None,
    seg_len: int = 0,
    luts=None,
):
    """Shared per-lane code assignment (RLE + Huffman, rle.c:84-123).

    luts: the 4 stacked table arrays (tables.stacked_luts; traced or
    constant), default the Annex-K tables.
    Returns dict of per-block / per-AC-lane (value, length) pieces:
    dc [nb], zrl_a/zrl_b/ac [nb, 63], eob [nb].
    """
    zz = zz.astype(jnp.int32)
    nb = zz.shape[0]
    dc_codes, dc_lens, ac_codes, ac_lens = (
        jnp.asarray(a) for a in (standard_luts() if luts is None else luts)
    )
    tsel = jnp.broadcast_to(jnp.asarray(table_sel, jnp.int32), (nb,))

    # --- DC ---
    if dc_diff is None:
        dc_diff = dc_differences(zz[:, 0], seg_len)
    dc_size = magnitude_category(dc_diff)
    dc_amp = amplitude_code(dc_diff, dc_size)
    dch = dc_codes[tsel, dc_size]
    dchl = dc_lens[tsel, dc_size]
    dc_val = (dch << dc_size.astype(jnp.uint32)) | dc_amp
    dc_len = dchl + dc_size

    # --- AC lanes 1..63 ---
    ac = zz[:, 1:]
    lanes = jnp.arange(1, 64)
    nz = ac != 0
    pos = jnp.where(nz, lanes[None, :], 0)
    # previous nonzero lane before k (DC counts as lane 0)
    prev = jax.lax.cummax(
        jnp.concatenate([jnp.zeros((nb, 1), jnp.int32), pos], axis=1), axis=1
    )[:, :-1]
    run = lanes[None, :] - prev - 1
    zrl_cnt = jnp.where(nz, run >> 4, 0)  # 0..3
    rem = jnp.where(nz, run & 15, 0)
    ac_size = magnitude_category(ac)
    sym = jnp.where(nz, (rem << 4) | ac_size, 0)
    ac_amp = amplitude_code(ac, ac_size)
    ach, achl = _ac_lookup(
        sym, table_sel if isinstance(table_sel, int) else tsel,
        ac_codes, ac_lens,
    )
    achl = jnp.where(nz, achl, 0)
    ac_val = (ach << ac_size.astype(jnp.uint32)) | ac_amp
    ac_len = achl + jnp.where(nz, ac_size, 0)

    zrl_code = ac_codes[tsel, _ZRL].astype(jnp.uint32)  # [nb]
    zrl_len = ac_lens[tsel, _ZRL]
    # ZRL sub-slot A: one or two ZRLs; sub-slot B: the third.
    n_a = jnp.minimum(zrl_cnt, 2)
    zc, zl = zrl_code[:, None], zrl_len[:, None]
    val_a = jnp.where(n_a == 2, (zc << zl.astype(jnp.uint32)) | zc, zc)
    len_a = n_a * zl
    val_b = zc
    len_b = jnp.where(zrl_cnt == 3, zl, 0)

    # --- EOB ---
    last_nz = jnp.max(pos, axis=1)
    eob = last_nz < 63
    eob_val = ac_codes[tsel, _EOB]
    eob_len = jnp.where(eob, ac_lens[tsel, _EOB], 0)

    return {
        "dc": (dc_val, dc_len),
        "zrl_a": (val_a, len_a),
        "zrl_b": (val_b, len_b),
        "ac": (ac_val, ac_len),
        "eob": (eob_val, eob_len),
        "nb": nb,
    }


def symbolize_slots(
    zz: jnp.ndarray,
    table_sel: jnp.ndarray | int = 0,
    dc_diff: jnp.ndarray | None = None,
    seg_len: int = 0,
    luts=None,
):
    """[nb, 64] zigzag levels -> per-slot (values u32, lengths i32) of shape
    [nb, 65, 3], in exact reference emission order (rle.c:84-123).

    Slot layout per lane: [:, :, 0] = first+second ZRL, [:, :, 1] = third
    ZRL, [:, :, 2] = the coded symbol (DC at lane 0, AC elsewhere, EOB at
    lane 64). table_sel selects luminance (0) / chrominance (1) tables per
    block. dc_diff overrides the internally computed running difference
    (used by interleaved color scans where the chain runs per component).
    """
    c = _lane_codes(zz, table_sel, dc_diff, seg_len, luts)
    nb = c["nb"]
    values = jnp.zeros((nb, 65, 3), jnp.uint32)
    lengths = jnp.zeros((nb, 65, 3), jnp.int32)
    values = values.at[:, 0, 2].set(c["dc"][0])
    lengths = lengths.at[:, 0, 2].set(c["dc"][1])
    values = values.at[:, 1:64, 0].set(c["zrl_a"][0])
    lengths = lengths.at[:, 1:64, 0].set(c["zrl_a"][1])
    values = values.at[:, 1:64, 1].set(c["zrl_b"][0])
    lengths = lengths.at[:, 1:64, 1].set(c["zrl_b"][1])
    values = values.at[:, 1:64, 2].set(c["ac"][0])
    lengths = lengths.at[:, 1:64, 2].set(c["ac"][1])
    values = values.at[:, 64, 2].set(c["eob"][0])
    lengths = lengths.at[:, 64, 2].set(c["eob"][1])
    return values, lengths


def symbolize_elements64(
    zz: jnp.ndarray,
    table_sel: jnp.ndarray | int = 0,
    dc_diff: jnp.ndarray | None = None,
    seg_len: int = 0,
    luts=None,
):
    """Power-of-two element layout for the tree packer: 64 elements per
    block, element e (0..62) = AC lane e+1 carrying sub-slots
    [DC-prefix (e==0 only), ZRLx2, ZRL, symbol, EOB-suffix (e==62 only)],
    element 63 all-empty padding. Same emission order as the reference;
    the even element count keeps every reduction level carry-free.

    Returns (values [nb, 64, 5] u32, lengths [nb, 64, 5] i32). Max element
    bits: 20 + 22 + 11 + 26 + 4 = 83 (3 words).
    """
    c = _lane_codes(zz, table_sel, dc_diff, seg_len, luts)
    nb = c["nb"]
    values = jnp.zeros((nb, 64, 5), jnp.uint32)
    lengths = jnp.zeros((nb, 64, 5), jnp.int32)
    values = values.at[:, 0, 0].set(c["dc"][0])
    lengths = lengths.at[:, 0, 0].set(c["dc"][1])
    values = values.at[:, 0:63, 1].set(c["zrl_a"][0])
    lengths = lengths.at[:, 0:63, 1].set(c["zrl_a"][1])
    values = values.at[:, 0:63, 2].set(c["zrl_b"][0])
    lengths = lengths.at[:, 0:63, 2].set(c["zrl_b"][1])
    values = values.at[:, 0:63, 3].set(c["ac"][0])
    lengths = lengths.at[:, 0:63, 3].set(c["ac"][1])
    values = values.at[:, 62, 4].set(c["eob"][0])
    lengths = lengths.at[:, 62, 4].set(c["eob"][1])
    return values, lengths


def pack_bits_device(values: jnp.ndarray, lengths: jnp.ndarray, capacity_words: int,
                     pad_ones: bool = True):
    """Concatenate variable-length codes MSB-first into a uint32 word
    stream — the parallel form of the reference's BitWriter (huffman.c:35-62).

    values/lengths: flat [S] uint32 / int32 (length 0 slots allowed).
    capacity_words: static output capacity.
    Returns (words u32 [capacity_words], total_bits i32) where total_bits
    includes the final 1s (or 0s) padding to a byte boundary.
    """
    values = values.reshape(-1)
    lengths = lengths.reshape(-1)
    ends = cumsum_1d(lengths)
    total = ends[-1] if lengths.size else jnp.int32(0)
    offsets = ends - lengths
    # Final-byte padding as one extra virtual slot (dsp huffman.c:179-187).
    padlen = (-total) % 8
    padval = ((jnp.uint32(1) << padlen.astype(jnp.uint32)) - 1) if pad_ones else jnp.uint32(0)
    values = jnp.concatenate([values, padval[None]])
    lengths = jnp.concatenate([lengths, padlen[None]])
    offsets = jnp.concatenate([offsets, total[None]])

    w0 = offsets >> 5
    r = offsets & 31
    end = r + lengths  # 1..63
    # Word w0 gets the slot's bits aligned to position r from the MSB.
    sh_lo = jnp.clip(32 - end, 0, 31).astype(jnp.uint32)
    sh_rt = jnp.clip(end - 32, 0, 31).astype(jnp.uint32)
    part0 = jnp.where(end <= 32, values << sh_lo, values >> sh_rt)
    sh_hi = jnp.clip(64 - end, 1, 31).astype(jnp.uint32)
    part1 = jnp.where(end > 32, values << sh_hi, 0)
    part0 = jnp.where(lengths > 0, part0, 0)
    part1 = jnp.where(lengths > 0, part1, 0)

    words = jnp.zeros((capacity_words + 1,), jnp.uint32)
    words = words.at[w0].add(part0, indices_are_sorted=True, mode="drop")
    words = words.at[w0 + 1].add(part1, indices_are_sorted=True, mode="drop")
    return words[:capacity_words], total + padlen


def stuff_bytes_device(words: jnp.ndarray, total_bits: jnp.ndarray):
    """0xFF -> 0xFF 00 byte stuffing (huffman.c:26-32) as a prefix-sum
    scatter. Returns (bytes u8 [2 * 4 * words], nbytes i32)."""
    n = words.shape[0] * 4
    sh = jnp.array([24, 16, 8, 0], jnp.uint32)
    raw = ((words[:, None] >> sh[None, :]) & 0xFF).astype(jnp.uint8).reshape(-1)
    nbytes = (total_bits + 7) >> 3
    valid = jnp.arange(n) < nbytes
    is_ff = (raw == 0xFF) & valid
    cum_ff = cumsum_1d(is_ff.astype(jnp.int32))
    dest = jnp.arange(n) + cum_ff - is_ff
    out = jnp.zeros((2 * n,), jnp.uint8)
    out = out.at[dest].add(
        jnp.where(valid, raw, 0), indices_are_sorted=True, mode="drop"
    )
    return out, nbytes + jnp.sum(is_ff)


def _per_block_words(zz, table_sel, dc_diff, cap_per_block: int,
                     luts=None):
    """Per-block packed streams: [nslots, 64] levels (+ per-block DC
    diffs) -> (words_t [cap, nslots], bits [nslots], overflow), via the
    staged symbolize + block shift-or reduction. table_sel: static int
    or (numpy or traced) per-slot 0/1 selectors; luts as _lane_codes."""
    from . import treepack

    zz = zz.astype(jnp.int32)
    values, lengths = symbolize_elements64(zz, table_sel, dc_diff,
                                           luts=luts)
    words_t, bits_t = treepack._fuse_subslots(values, lengths, 3)
    return treepack._block_reduce(
        words_t, bits_t, 64, 3, cap_per_block, zz.shape[0]
    )


def encode_segments_device(
    zz: jnp.ndarray,
    seg_slots: int,
    n_valid: int,
    table_sel: np.ndarray | int,
    dc_diff: jnp.ndarray,
    cap_per_block: int,
    pad_ones: bool = True,
    deposit_threshold: int = 256,
    luts=None,
):
    """Segment-parallel entropy encode: S independent byte-aligned streams
    in ONE program — the mechanism behind single-device restart-interval
    encodes (T.81 DRI semantics, each segment resetting the DC predictor)
    and the batched image encode (each image = one 'segment').

    zz: [S*seg_slots, 64] scan-order levels, zero-padded past n_valid
    (padded blocks contribute ZERO bits — masked after the block pack).
    dc_diff must already encode the per-segment / per-component predictor
    resets. Returns (streams [S, seg_slots*cap_per_block] u32,
    total_bits [S] i32 incl. tail padding, overflow).
    """
    n_total = zz.shape[0]
    assert n_total % seg_slots == 0
    w_t, bits, overflow = _per_block_words(
        zz, table_sel, dc_diff, cap_per_block, luts=luts
    )
    if n_valid < n_total:
        mask = jnp.arange(n_total) < n_valid
        bits = jnp.where(mask, bits, 0)
        w_t = jnp.where(mask[None, :], w_t, 0)
    return segment_streams(w_t, bits, seg_slots, seg_slots * cap_per_block,
                           pad_ones, overflow,
                           deposit_threshold=deposit_threshold)


def segment_streams(w_t, bits, seg: int, out_words_per_seg: int,
                    pad_ones: bool, overflow, deposit_threshold: int = 256):
    """Per-unit packed streams (words_t [C, S*seg], bits [S*seg]; a unit
    is a block or an MCU) -> S byte-aligned segment streams
    (treepack.concat_segments_tree + tail padding). Returns (streams
    [S, out_words_per_seg] u32, total_bits [S] i32, overflow)."""
    from . import treepack

    c, n = w_t.shape
    s = n // seg
    streams, totals = treepack.concat_segments_tree(
        w_t.reshape(c, s, seg), bits.reshape(s, seg),
        out_words_per_seg=out_words_per_seg,
        deposit_threshold=deposit_threshold,
    )
    return (*treepack.apply_tail_padding_segments(streams, totals, pad_ones),
            overflow)


def encode_scan_device(
    zz: jnp.ndarray,
    table_sel: jnp.ndarray | int = 0,
    dc_diff: jnp.ndarray | None = None,
    seg_len: int = 0,
    capacity_words: int | None = None,
    pad_ones: bool = True,
    packer: str = "tree",
    stuff: bool = True,
    deposit_threshold: int = 256,
    luts=None,
):
    """Full on-device entropy encode of one scan segment.

    [nb, 64] zigzag levels -> (stuffed bytes u8 [cap], nbytes i32). The
    caller slices to nbytes on host and splices between SOS and EOI.
    seg_len only affects the DC predictor (callers produce one byte-aligned
    output per restart segment with encode_segments_device).

    Returns (bytes, nbytes, overflowed). capacity_words defaults to the
    absolute worst case; callers may pass a tight heuristic capacity (the
    stuffing pass cost scales with it) and must retry with the full bound
    when `overflowed` comes back true — out-of-capacity words are dropped,
    never written out of bounds.
    """
    nb = zz.shape[0]
    if capacity_words is None:
        capacity_words = nb * MAX_WORDS_PER_BLOCK
    if packer == "tree":
        from . import treepack

        cap_per_block = max(1, capacity_words // nb)
        values, lengths = symbolize_elements64(zz, table_sel, dc_diff,
                                               seg_len, luts)
        words, total_bits, overflow = treepack.pack_slots_tree(
            values, lengths, cap_per_block, pad_ones, c0=3,
            deposit_threshold=deposit_threshold,
        )
        if not stuff:
            # Caller finishes on host (native.words_to_stuffed) — saves the
            # byte-level scatter pass on device.
            return words, total_bits, overflow
        out, nbytes = stuff_bytes_device(words, total_bits)
        return out, nbytes, overflow
    values, lengths = symbolize_slots(zz, table_sel, dc_diff, seg_len, luts)
    words, total_bits = pack_bits_device(values, lengths, capacity_words, pad_ones)
    if not stuff:
        return words, total_bits, total_bits > capacity_words * 32
    out, nbytes = stuff_bytes_device(words, total_bits)
    return out, nbytes, total_bits > capacity_words * 32


def symbol_histograms(zz, table_sel=None, dc_diff=None, seg_len: int = 0,
                      valid=None):
    """Pass 1 of 2-pass optimal Huffman coding, ON DEVICE: [nb, 64]
    zigzag levels -> per-class symbol count tensors; only ~2 KB crosses
    the host boundary (vs ~4 B/pixel of coefficients for a host-side
    first pass). Returns a dict of device arrays:
      dc12 [2, 12] i32   — DC size-category counts per table class,
      ac   [2, 16, 11] i32 — AC (run, size) counts (size >= 1),
      zrl  [2] i32, eob [2] i32.
    Assemble into 256-bin histograms with assemble_histograms (host).
    All accumulation is integer-exact: the one-hot contractions run in
    f32 only WITHIN a 2048-block chunk (sums <= 2^17, exact) and the
    cross-chunk carry is i32 — exact to 2^31 symbols, beyond the 2^27
    blocks of a maximal 65535x65535 scan.

    valid: optional [nb] bool — blocks with False contribute nothing
    (batch bucket-padding images; shard_map-safe, unlike slicing).
    """
    zz = zz.astype(jnp.int32)
    nb = zz.shape[0]
    if dc_diff is None:
        dc_diff = dc_differences(zz[:, 0], seg_len)
    sel = (
        jnp.zeros(nb, jnp.int32)
        if table_sel is None
        else jnp.asarray(table_sel).astype(jnp.int32)
    )
    v = jnp.ones(nb, bool) if valid is None else valid

    dsize = 32 - jax.lax.clz(jnp.abs(dc_diff))  # clz(0)=32 -> size 0
    d_oh = dsize[:, None] == jnp.arange(12)[None, :]
    dc12 = jnp.stack(
        [
            jnp.sum((d_oh & ((sel == t) & v)[:, None]).astype(jnp.int32), axis=0)
            for t in (0, 1)
        ]
    )

    ac = zz[:, 1:]
    nz = ac != 0
    lanes = jnp.arange(1, 64)
    last_nz = jnp.max(jnp.where(nz, lanes[None, :], 0), axis=1)
    pos = jnp.where(nz, lanes[None, :], 0)
    prev = jax.lax.cummax(
        jnp.concatenate([jnp.zeros((nb, 1), jnp.int32), pos], axis=1),
        axis=1,
    )[:, :-1]
    run = lanes[None, :] - prev - 1
    emit = nz & (lanes[None, :] <= last_nz[:, None])
    zrl_cnt = jnp.where(emit, run >> 4, 0)
    rem = run & 15
    asize = 32 - jax.lax.clz(jnp.abs(ac))
    eob = last_nz < 63

    zrl = jnp.stack(
        [jnp.sum(jnp.where(((sel == t) & v)[:, None], zrl_cnt, 0))
         for t in (0, 1)]
    ).astype(jnp.int32)
    eobc = jnp.stack(
        [jnp.sum((eob & (sel == t) & v).astype(jnp.int32)) for t in (0, 1)]
    )

    # AC (run, size) counts via chunked one-hot contractions: the
    # [C*63, 16] x [C*63, 11] einsum materializes ~20 MB per chunk
    # instead of an [n, 256] one-hot.
    c = 2048
    npad = -(-nb // c) * c
    rem_p = jnp.pad(rem, ((0, npad - nb), (0, 0)))
    size_p = jnp.pad(asize, ((0, npad - nb), (0, 0)))
    e0 = jnp.pad(emit & ((sel == 0) & v)[:, None], ((0, npad - nb), (0, 0)))
    e1 = jnp.pad(emit & ((sel == 1) & v)[:, None], ((0, npad - nb), (0, 0)))
    steps = npad // c
    r16 = jnp.arange(16)
    s11 = jnp.arange(11)

    def step(carry, xs):
        # f32 contraction within the chunk (sums <= c*63 < 2^24, exact),
        # i32 carry across chunks (exact to 2^31 — f32 would silently
        # lose counts past 2^24 on giant scans).
        h0, h1 = carry
        remc, sizec, m0, m1 = xs
        n = c * 63
        r_oh = (remc.reshape(n, 1) == r16[None, :]).astype(jnp.float32)
        s_oh = (sizec.reshape(n, 1) == s11[None, :]).astype(jnp.float32)
        h0 = h0 + jnp.einsum(
            "nr,ns->rs", r_oh * m0.reshape(n, 1).astype(jnp.float32), s_oh
        ).astype(jnp.int32)
        h1 = h1 + jnp.einsum(
            "nr,ns->rs", r_oh * m1.reshape(n, 1).astype(jnp.float32), s_oh
        ).astype(jnp.int32)
        return (h0, h1), None

    xs = (
        rem_p.reshape(steps, c, 63),
        size_p.reshape(steps, c, 63),
        e0.reshape(steps, c, 63),
        e1.reshape(steps, c, 63),
    )
    (h0, h1), _ = jax.lax.scan(
        step, (jnp.zeros((16, 11), jnp.int32),) * 2, xs
    )
    return {
        "dc12": dc12,
        "ac": jnp.stack([h0, h1]),
        "zrl": zrl,
        "eob": eobc,
    }


def assemble_histograms(stats: dict) -> dict:
    """Host finish for symbol_histograms: device count tensors ->
    {'dc_lum': [256] i64, 'ac_lum': ..., 'dc_chrom': ..., 'ac_chrom': ...}
    in the layout tables.optimal_specs_from_frequencies consumes."""
    import numpy as np

    dc12 = np.asarray(stats["dc12"]).astype(np.int64)
    ac = np.asarray(stats["ac"]).astype(np.int64)
    zrl = np.asarray(stats["zrl"]).astype(np.int64)
    eob = np.asarray(stats["eob"]).astype(np.int64)
    out = {}
    for t, kind in ((0, "lum"), (1, "chrom")):
        d = np.zeros(256, np.int64)
        d[:12] = dc12[t]
        a = np.zeros(256, np.int64)
        for r in range(16):
            for s in range(1, 11):
                a[(r << 4) | s] = ac[t, r, s]
        a[0xF0] = zrl[t]
        a[0x00] = eob[t]
        out[f"dc_{kind}"] = d
        out[f"ac_{kind}"] = a
    return out
