"""Hierarchical bitstream packing: dense shift-or merge tree, no scatter.

The scatter-add packer (entropy.device.pack_bits_device) is semantically
clean, but it issues one scatter element per slot contribution. This
module reformulates packing as a reduction:

    bitstream concatenation is associative, so packing N variable-length
    codes is a balanced binary REDUCTION over MSB-aligned word arrays —
    every level is dense vector work (pad, OR, per-element barrel
    shifts). No gathers, no scatters.

The tree runs TRANSPOSED ([C, N]: capacity major, elements minor) while
the per-element capacity C is small, then flips to row-major [N, C] for
the top levels where C is large and N small; the last few large
elements are deposited sequentially (_deposit_concat).

This is the parallel answer to the reference's serial 64-bit
accumulator BitWriter (dsp huffman.c:113-156): same output bits,
log-depth parallel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_FLIP_C = 128  # switch from [C, N] to [N, C] once capacity reaches this


def _shift_right_bits_t(words: jnp.ndarray, nbits: jnp.ndarray) -> jnp.ndarray:
    """Transposed layout [C, N]: shift each COLUMN right by its bit count
    (toward higher word index), zero-filling. nbits: [N]."""
    c, n = words.shape
    wa = (nbits >> 5).astype(jnp.int32)
    ra = (nbits & 31).astype(jnp.uint32)
    # barrel word shift along axis 0
    t = 0
    while (1 << t) < c:
        s = 1 << t
        shifted = jnp.pad(words[: c - s], ((s, 0), (0, 0)))
        words = jnp.where(((wa >> t) & 1)[None, :] == 1, shifted, words)
        t += 1
    hi = words >> ra[None, :]
    prev = jnp.pad(words[:-1], ((1, 0), (0, 0)))
    lo = prev << jnp.clip(32 - ra, 0, 31)[None, :]
    return jnp.where((ra == 0)[None, :], words, hi | lo)


def _shift_right_bits_r(words: jnp.ndarray, nbits: jnp.ndarray) -> jnp.ndarray:
    """Row-major layout [N, C]: shift each ROW right by its bit count."""
    n, c = words.shape
    wa = (nbits >> 5).astype(jnp.int32)
    ra = (nbits & 31).astype(jnp.uint32)
    t = 0
    while (1 << t) < c:
        s = 1 << t
        shifted = jnp.pad(words[:, : c - s], ((0, 0), (s, 0)))
        words = jnp.where(((wa >> t) & 1)[:, None] == 1, shifted, words)
        t += 1
    hi = words >> ra[:, None]
    prev = jnp.pad(words[:, :-1], ((0, 0), (1, 0)))
    lo = prev << jnp.clip(32 - ra, 0, 31)[:, None]
    return jnp.where((ra == 0)[:, None], words, hi | lo)


def _place(v: jnp.ndarray, ln: jnp.ndarray, off: jnp.ndarray):
    """Deposit a right-aligned value of `ln` bits at MSB-relative bit
    offset `off` into a 2-word (MSB-aligned) frame. off + ln <= 64.
    Returns (w0, w1) contributions (zero where ln == 0)."""
    end = off + ln
    sh_lo = jnp.clip(32 - end, 0, 31).astype(jnp.uint32)
    sh_rt = jnp.clip(end - 32, 0, 31).astype(jnp.uint32)
    w0 = jnp.where(end <= 32, v << sh_lo, v >> sh_rt)
    sh_hi = jnp.clip(64 - end, 0, 31).astype(jnp.uint32)
    w1 = jnp.where(end > 32, v << sh_hi, 0)
    valid = ln > 0
    return jnp.where(valid, w0, 0), jnp.where(valid, w1, 0)


def _place_word(v: jnp.ndarray, ln: jnp.ndarray, end: jnp.ndarray, j: int):
    """Contribution of a right-aligned `ln`-bit value ending at bit `end`
    (MSB-relative) to word j of its element frame."""
    sh = 32 * (j + 1) - end
    left = v << jnp.clip(sh, 0, 31).astype(jnp.uint32)
    right = v >> jnp.clip(-sh, 0, 31).astype(jnp.uint32)
    out = jnp.where(sh >= 0, left, right)
    live = (ln > 0) & (sh < 32) & (sh > -ln)
    return jnp.where(live, out, 0)


def _fuse_subslots(values: jnp.ndarray, lengths: jnp.ndarray, c_out: int = 2):
    """Arithmetically merge the K per-lane sub-slots into one c_out-word
    element per lane — replaces the widest levels of the binary reduction
    with pure elementwise work. Total sub-slot bits must fit c_out words.

    values/lengths: [nb, E, K]. Returns (words_t [c_out, E, nb],
    bits [E, nb]).
    """
    lengths = lengths.astype(jnp.int32)
    k = values.shape[-1]
    off = jnp.zeros_like(lengths[..., 0])
    words = [jnp.zeros(values.shape[:-1], jnp.uint32) for _ in range(c_out)]
    for i in range(k):
        v, ln = values[..., i], lengths[..., i]
        end = off + ln
        for j in range(c_out):
            words[j] = words[j] | _place_word(v, ln, end, j)
        off = end
    words_t = jnp.stack([w.T for w in words])  # [c_out, E, nb]
    return words_t, off.T


def pack_slots_tree(values3: jnp.ndarray, lengths3: jnp.ndarray,
                    cap_words_per_block: int, pad_ones: bool = True,
                    c0: int | None = None, deposit_threshold: int = 256):
    """Pack [nb, E, K] sub-slot codes (emission order element-major then
    sub-slot) into one stream. The K sub-slots fuse elementwise, each
    block's elements reduce in a binary shift-or tree, and the block
    streams concatenate (concat_blocks_tree). c0 = starting element
    capacity in words (default: enough for 32*K bits worst case; the
    5-sub-slot 83-bit layout passes 3)."""
    nb, e, k = values3.shape
    if c0 is None:
        c0 = 2 if k <= 3 else k
    c0 = min(c0, cap_words_per_block)
    words_t, bits_t = _fuse_subslots(values3, lengths3, c0)
    bw_t, bb, overflow = _block_reduce(
        words_t, bits_t, e, c0, cap_words_per_block, nb
    )
    stream, total = concat_blocks_tree(
        bw_t, bb, deposit_threshold=deposit_threshold
    )
    stream, total = _apply_tail_padding(stream, total, pad_ones)
    return stream, total, overflow


def _block_reduce(words, bits, e, c, cap_words_per_block, nb):
    while e > 1:
        c_next = min(2 * c, cap_words_per_block)
        half = e // 2
        a_w = words[:, 0 : 2 * half : 2]  # [c, half, nb]
        b_w = words[:, 1 : 2 * half : 2]
        a_l = bits[0 : 2 * half : 2]  # [half, nb]
        b_l = bits[1 : 2 * half : 2]
        a_w = jnp.pad(a_w, ((0, c_next - c), (0, 0), (0, 0)))
        b_w = jnp.pad(b_w, ((0, c_next - c), (0, 0), (0, 0)))
        b_sh = _shift_right_bits_t(
            b_w.reshape(c_next, half * nb), a_l.reshape(half * nb)
        ).reshape(c_next, half, nb)
        merged = a_w | b_sh
        mbits = a_l + b_l
        if e % 2:
            carry = jnp.pad(words[:, -1:], ((0, c_next - c), (0, 0), (0, 0)))
            merged = jnp.concatenate([merged, carry], axis=1)
            mbits = jnp.concatenate([mbits, bits[-1:]], axis=0)
            half += 1
        words, bits, e, c = merged, mbits, half, c_next

    words = words[:, 0]  # [c, nb]
    bits = bits[0]  # [nb]
    if c < cap_words_per_block:
        words = jnp.pad(words, ((0, cap_words_per_block - c), (0, 0)))
    overflow = jnp.any(bits > cap_words_per_block * 32)
    return words, bits, overflow  # words TRANSPOSED [cap, nb]


def _deposit_concat(rows: jnp.ndarray, bits: jnp.ndarray, out_words: int):
    """Concatenate a FEW large elements by sequential deposit.

    rows [n, c] MSB-aligned, bits [n]. Computes each element's absolute
    bit offset by prefix sum, then a fori_loop ORs each element (shifted
    by its sub-word residue) into the output via dynamic_update_slice —
    XLA keeps the buffer in-place across iterations, so the cost is one
    (c+1)-word read-modify-write per element. This replaces the tree's
    top levels, whose barrel depth (log2 of a megaword capacity) makes
    them the most expensive — here every element is shifted ONCE by a
    scalar residue instead of log2(C) times by vector amounts.
    Returns (stream [out_words], total_bits)."""
    n, c = rows.shape
    bits = bits.astype(jnp.int32)
    ends = jnp.cumsum(bits)
    offs = ends - bits
    out0 = jnp.zeros(out_words + c + 1, jnp.uint32)

    def body(i, out):
        row = jax.lax.dynamic_slice(rows, (i, 0), (1, c))[0]
        off = offs[i]
        wo = off >> 5
        ra = (off & 31).astype(jnp.uint32)
        t = jnp.clip(32 - ra, 0, 31)
        hi = row >> ra
        prev = jnp.concatenate([jnp.zeros(1, jnp.uint32), row[:-1]])
        body_w = hi | jnp.where(ra == 0, 0, prev << t)
        tail_w = jnp.where(ra == 0, 0, row[-1:] << t)
        seg = jnp.concatenate([body_w, tail_w])
        cur = jax.lax.dynamic_slice(out, (wo,), (c + 1,))
        return jax.lax.dynamic_update_slice(out, cur | seg, (wo,))

    out = jax.lax.fori_loop(0, n, body, out0)
    return out[:out_words], ends[-1]


def concat_blocks_tree(words_t: jnp.ndarray, bits: jnp.ndarray,
                       radix: int = 4, deposit_threshold: int = 256):
    """Concatenate per-block packed streams (transposed [CB, nb]) into one
    stream. Returns (stream_words [nb * CB] u32, total_bits i32).

    Radix-4 merges: each level concatenates four neighbors with three
    cumulative shifts — same shift work as two binary levels but HALF the
    pad/slice relayout rounds. Element
    counts are padded up to radix multiples with zero-LENGTH elements;
    a zero-length tail contributes nothing wherever it lands, so no
    odd-carry branches exist."""
    cb, nb = words_t.shape
    bits = bits.astype(jnp.int32)
    words, n, c = words_t, nb, cb

    # Phase A: transposed merges while the per-element capacity is small.
    while n > deposit_threshold and radix * c < _FLIP_C:
        r = radix if n > 2 else 2
        c_next = r * c
        n_pad = -(-n // r) * r
        if n_pad != n:
            words = jnp.pad(words, ((0, 0), (0, n_pad - n)))
            bits = jnp.pad(bits, (0, n_pad - n))
        parts_w = [words[:, i::r] for i in range(r)]
        parts_l = [bits[i::r] for i in range(r)]
        merged = jnp.pad(parts_w[0], ((0, c_next - c), (0, 0)))
        off = parts_l[0]
        for i in range(1, r):
            merged = merged | _shift_right_bits_t(
                jnp.pad(parts_w[i], ((0, c_next - c), (0, 0))), off
            )
            off = off + parts_l[i]
        words, bits, n, c = merged, off, n_pad // r, c_next

    rows = words.T  # [n, c] row-major for the large-capacity top levels

    # Phase B: row-major merges until few enough elements remain for the
    # sequential deposit to win.
    while n > deposit_threshold:
        r = radix if n > 2 else 2
        c_next = r * c
        n_pad = -(-n // r) * r
        if n_pad != n:
            rows = jnp.pad(rows, ((0, n_pad - n), (0, 0)))
            bits = jnp.pad(bits, (0, n_pad - n))
        parts_w = [rows[i::r] for i in range(r)]
        parts_l = [bits[i::r] for i in range(r)]
        merged = jnp.pad(parts_w[0], ((0, 0), (0, c_next - c)))
        off = parts_l[0]
        for i in range(1, r):
            merged = merged | _shift_right_bits_r(
                jnp.pad(parts_w[i], ((0, 0), (0, c_next - c))), off
            )
            off = off + parts_l[i]
        rows, bits, n, c = merged, off, n_pad // r, c_next

    if n == 1:
        return rows.reshape(-1)[: nb * cb], bits[0]
    return _deposit_concat(rows, bits, nb * cb)


def merge_adjacent_t(words: jnp.ndarray, bits: jnp.ndarray):
    """One explicit tree level in the transposed layout: merge adjacent
    COLUMN pairs. words [C, N] (N even) -> ([2C, N/2], bits [N/2]).
    Column 2i || column 2i+1, MSB-aligned."""
    c, n = words.shape
    a_w, b_w = words[:, 0::2], words[:, 1::2]
    a_l, b_l = bits[0::2], bits[1::2]
    a_w = jnp.pad(a_w, ((0, c), (0, 0)))
    b_w = jnp.pad(b_w, ((0, c), (0, 0)))
    merged = a_w | _shift_right_bits_t(b_w, a_l)
    return merged, a_l + b_l


def merge_two_t(wa: jnp.ndarray, ba: jnp.ndarray,
                wb: jnp.ndarray, bb: jnp.ndarray):
    """Columnwise concat of two transposed word arrays: result column i =
    wa[:, i] || wb[:, i]. Capacities may differ; output capacity is the
    sum. Returns ([Ca+Cb, N], bits [N])."""
    ca, n = wa.shape
    cb = wb.shape[0]
    wa = jnp.pad(wa, ((0, cb), (0, 0)))
    wb = jnp.pad(wb, ((0, ca), (0, 0)))
    return wa | _shift_right_bits_t(wb, ba), ba + bb


def concat_segments_tree(words_t: jnp.ndarray, bits: jnp.ndarray,
                         out_words_per_seg: int, radix: int = 4,
                         deposit_threshold: int = 256):
    """Concatenate per-block streams into ONE stream PER SEGMENT, batched.

    words_t: [CB, S, N] per-block packed words (transposed), bits: [S, N].
    Every segment is an independent bitstream (restart segment, or one
    image of a batch); all S of them reduce together in the same dense
    tree — the batch axis rides along every level for free, which is how
    this stays vmap-free (a vmapped concat_blocks_tree would lower its
    deposit phase to scatters; see batch.py history).

    Returns (streams [S, out_words_per_seg] u32, total_bits [S] i32 — tail
    padding NOT applied; see apply_tail_padding_segments).
    """
    cb, s, nb = words_t.shape
    bits = bits.astype(jnp.int32)
    words, n, c = words_t, nb, cb

    # Phase A: transposed layout [C, S, N] — identical math to the
    # unbatched tree with the batch axis folded into the column axis.
    while n > deposit_threshold and n > 1 and radix * c < _FLIP_C:
        r = radix if n > 2 else 2
        c_next = r * c
        n_pad = -(-n // r) * r
        if n_pad != n:
            words = jnp.pad(words, ((0, 0), (0, 0), (0, n_pad - n)))
            bits = jnp.pad(bits, ((0, 0), (0, n_pad - n)))
        parts_w = [words[:, :, i::r] for i in range(r)]
        parts_l = [bits[:, i::r] for i in range(r)]
        m = n_pad // r
        merged = jnp.pad(parts_w[0], ((0, c_next - c), (0, 0), (0, 0)))
        off = parts_l[0]
        for i in range(1, r):
            shifted = _shift_right_bits_t(
                jnp.pad(parts_w[i], ((0, c_next - c), (0, 0), (0, 0)))
                .reshape(c_next, s * m),
                off.reshape(s * m),
            ).reshape(c_next, s, m)
            merged = merged | shifted
            off = off + parts_l[i]
        words, bits, n, c = merged, off, m, c_next

    rows = words.transpose(1, 2, 0)  # [S, n, c]

    # Phase B: row-major top levels, batch axis folded into the row axis.
    while n > deposit_threshold and n > 1:
        r = radix if n > 2 else 2
        c_next = r * c
        n_pad = -(-n // r) * r
        if n_pad != n:
            rows = jnp.pad(rows, ((0, 0), (0, n_pad - n), (0, 0)))
            bits = jnp.pad(bits, ((0, 0), (0, n_pad - n)))
        parts_w = [rows[:, i::r] for i in range(r)]
        parts_l = [bits[:, i::r] for i in range(r)]
        m = n_pad // r
        merged = jnp.pad(parts_w[0], ((0, 0), (0, 0), (0, c_next - c)))
        off = parts_l[0]
        for i in range(1, r):
            shifted = _shift_right_bits_r(
                jnp.pad(parts_w[i], ((0, 0), (0, 0), (0, c_next - c)))
                .reshape(s * m, c_next),
                off.reshape(s * m),
            ).reshape(s, m, c_next)
            merged = merged | shifted
            off = off + parts_l[i]
        rows, bits, n, c = merged, off, m, c_next

    if n == 1:
        streams = rows[:, 0]  # [S, c]
        if c < out_words_per_seg:
            streams = jnp.pad(streams, ((0, 0), (0, out_words_per_seg - c)))
        return streams[:, :out_words_per_seg], bits[:, 0]

    # Deposit top: one fori_loop over all S*n remaining elements; element
    # (seg, i) lands at absolute bit offset seg*W*32 + prefix(seg, i) —
    # per-segment regions are strided, so one flat output buffer serves
    # every segment and XLA keeps it in-place across iterations.
    ends = jnp.cumsum(bits, axis=1)  # [S, n]
    offs = ends - bits
    base = (jnp.arange(s, dtype=jnp.int32) * (out_words_per_seg * 32))[:, None]
    abs_offs = (offs + base).reshape(-1)
    flat_rows = rows.reshape(s * n, c)
    out0 = jnp.zeros(s * out_words_per_seg + c + 1, jnp.uint32)

    def body(i, out):
        row = jax.lax.dynamic_slice(flat_rows, (i, 0), (1, c))[0]
        off = abs_offs[i]
        wo = off >> 5
        ra = (off & 31).astype(jnp.uint32)
        t = jnp.clip(32 - ra, 0, 31)
        hi = row >> ra
        prev = jnp.concatenate([jnp.zeros(1, jnp.uint32), row[:-1]])
        body_w = hi | jnp.where(ra == 0, 0, prev << t)
        tail_w = jnp.where(ra == 0, 0, row[-1:] << t)
        seg = jnp.concatenate([body_w, tail_w])
        cur = jax.lax.dynamic_slice(out, (wo,), (c + 1,))
        return jax.lax.dynamic_update_slice(out, cur | seg, (wo,))

    out = jax.lax.fori_loop(0, s * n, body, out0)
    streams = out[: s * out_words_per_seg].reshape(s, out_words_per_seg)
    return streams, ends[:, -1]


def apply_tail_padding_segments(streams: jnp.ndarray, totals: jnp.ndarray,
                                pad_ones: bool):
    """Per-segment final-byte padding, dense over the batch: the pad mask
    is OR'd into each segment's word at index total>>5 via an arange
    compare (one pass over the output, no scatters)."""
    padlen = (-totals) % 8
    if pad_ones:
        s, w = streams.shape
        widx = totals >> 5
        off = (totals & 31).astype(jnp.uint32)
        mask = jnp.where(
            padlen > 0,
            ((jnp.uint32(1) << padlen.astype(jnp.uint32)) - 1)
            << jnp.clip(32 - off - padlen.astype(jnp.uint32), 0, 31),
            jnp.uint32(0),
        )
        hit = jnp.arange(w, dtype=jnp.int32)[None, :] == widx[:, None]
        streams = streams | jnp.where(hit, mask[:, None], 0)
    return streams, totals + padlen


def _apply_tail_padding(stream: jnp.ndarray, total: jnp.ndarray, pad_ones: bool):
    """Pad the final partial byte (1s per T.81 / dsp huffman.c:179-187, or
    0s = the natural zero fill). Returns (stream, padded total_bits)."""
    padlen = (-total) % 8
    if pad_ones:
        # The pad never crosses a word boundary (it only completes the
        # byte containing bit `total`): set those bits via a 1-word update.
        widx = total >> 5
        off = (total & 31).astype(jnp.uint32)
        mask_full = jnp.where(
            padlen > 0,
            (((jnp.uint32(1) << padlen.astype(jnp.uint32)) - 1)
             << jnp.clip(32 - off - padlen.astype(jnp.uint32), 0, 31)),
            jnp.uint32(0),
        )
        word = jax.lax.dynamic_index_in_dim(stream, widx, keepdims=False)
        stream = jax.lax.dynamic_update_index_in_dim(
            stream, word | mask_full, widx, axis=0
        )
    return stream, total + padlen
