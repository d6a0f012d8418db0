"""End-to-end encode orchestration.

Boundary layout mirrors the reference's host/device split (SURVEY.md §3.5):
host does container I/O and JFIF assembly (the A72's role in the DSP port,
dsp_port/jpeg_client/main.c); the accelerator does everything from color
conversion through zigzag and, via entropy.device, symbolization + bit
packing.

Every device encode is one jitted XLA program per (padded shape, config,
capacity rung), cached, and takes the Huffman tables as a runtime
argument (tables.stacked_luts) — the Annex-K tables and 2-pass optimal
tables share the compiled program.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import tables
from .config import EncodeConfig
from .io import bmp, jfif
from .entropy import device as entropy_device
from .entropy import host as entropy_host
from .ops import blocks, color

GRAY_CLASSES = ("dc_lum", "ac_lum")


def _gray_levels(img, cfg: EncodeConfig, is_rgb: bool):
    """Traceable core: padded image -> [nb, 64] zigzag levels.

    Uses the tiled block-diagonal transform (ops/fused_transform): one
    dense matmul pair per 128x128 tile instead of batched 8x8 products.
    The image (already 8-aligned) is edge-padded up to tile multiples
    in-graph and the extra blocks trimmed after."""
    from .ops import fused_transform

    y = color.rgb_to_y_reference(img) if is_rgb else img
    h, w = y.shape
    th, tw = fused_transform.padded_dims_tile(h, w)
    if (th, tw) != (h, w):
        y = jnp.pad(y, ((0, th - h), (0, tw - w)), mode="edge")
    qtable = jnp.asarray(cfg.luma_quant.astype(np.float32))
    if cfg.dct_dtype == "int32":
        from .ops import int_transform

        return int_transform.transform_tiled_int(
            y, qtable, bitexact=cfg.bitexact, out_blocks=(h // 8, w // 8)
        )
    return fused_transform.transform_tiled(
        y, qtable, bitexact=cfg.bitexact, out_blocks=(h // 8, w // 8)
    )


@functools.lru_cache(maxsize=64)
def _transform_gray(ph: int, pw: int, cfg: EncodeConfig, is_rgb: bool):
    """Jitted device transform: padded image -> [nb, 64] zigzag levels."""
    return jax.jit(lambda img: _gray_levels(img, cfg, is_rgb))


@functools.lru_cache(maxsize=64)
def _encode_gray_device(
    ph: int,
    pw: int,
    cfg: EncodeConfig,
    is_rgb: bool,
    cap_words_per_block: int,
    stuff: bool = True,
):
    """Jitted full device encode fn(img, luts). Transform and entropy
    coding compile into ONE XLA program so intermediates never leave the
    device.

    stuff=True: -> (stuffed entropy bytes, nbytes, overflow).
    stuff=False: -> (packed words, total_bits, overflow); the host finishes
    with the native stuffer (native.words_to_stuffed)."""

    @jax.jit
    def fn(img, luts):
        return gray_encode_body(img, cfg, is_rgb, cap_words_per_block, stuff,
                                luts=luts)

    return fn


def gray_encode_body(img, cfg: EncodeConfig, is_rgb: bool,
                     cap_words_per_block: int, stuff: bool, luts=None):
    """Traceable full grayscale encode body (compose under jit freely).
    luts: runtime Huffman tables (tables.stacked_luts), default Annex-K."""
    ph, pw = img.shape[:2]
    nb = (ph // 8) * (pw // 8)
    zz = _gray_levels(img, cfg, is_rgb)
    return entropy_device.encode_scan_device(
        zz,
        capacity_words=nb * cap_words_per_block,
        pad_ones=cfg.pad_ones,
        stuff=stuff,
        luts=luts,
    )


def _pad_to_blocks(image: np.ndarray) -> np.ndarray:
    """Edge-pad [H, W(, 3)] on the host to whole 8x8 blocks (cheap, and
    avoids a second jit cache axis on exact dims)."""
    h, w = image.shape[:2]
    ph, pw = blocks.padded_dims(h, w)
    if (ph, pw) != (h, w):
        pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (image.ndim - 2)
        image = np.pad(image, pad, mode="edge")
    return image


def grayscale_coefficients(
    image: np.ndarray, config: EncodeConfig
) -> np.ndarray:
    """Run the device transform for a grayscale encode.

    image: uint8 [H, W] luma or [H, W, 3] RGB.
    Returns zigzag levels [nb, 64] int32 (blocks in raster order).
    """
    image = _pad_to_blocks(image)
    ph, pw = image.shape[:2]
    fn = _transform_gray(ph, pw, config, image.ndim == 3)
    return np.asarray(fn(jnp.asarray(image)))


def optimal_tables(stats: dict, classes) -> tuple[dict, tuple]:
    """Pass-1 device histograms -> (per-class optimal specs for the DHT
    segments, the stacked runtime tables pass 2 encodes with).

    Frequencies are FLOORED (tables.floor_frequencies): pass 1 and pass 2
    are separately compiled programs, and a cross-program rounding tie
    must never select a code-less symbol. Every 2-pass path floors, so
    host and device 2-pass outputs stay byte-comparable."""
    freqs = tables.floor_frequencies(entropy_device.assemble_histograms(stats))
    specs = {k: tables.optimal_spec(freqs[k]) for k in classes}
    return specs, tables.stacked_luts(tables.huffman_luts_from_specs(specs))


@functools.lru_cache(maxsize=32)
def _gray_stats_fn(ph: int, pw: int, cfg: EncodeConfig, is_rgb: bool):
    """Jitted pass 1 of device 2-pass optimal coding: image -> symbol
    count tensors (entropy_device.symbol_histograms; ~2 KB download),
    with the DC predictor reset at every restart segment start."""

    @jax.jit
    def fn(img):
        zz = _gray_levels(img, cfg, is_rgb).astype(jnp.int32)
        return entropy_device.symbol_histograms(
            zz, seg_len=cfg.restart_interval
        )

    return fn


def encode_grayscale(image: np.ndarray, config: EncodeConfig | None = None) -> bytes:
    """Encode an image (uint8 [H, W] or [H, W, 3] RGB) as a baseline
    grayscale JFIF byte string — the reference's capability
    (natural_c saveJPEGGrayscale, jpeg_handler.c:119-282).

    The device path runs the entire pipeline — transform AND entropy
    coding — as one jitted XLA program; only the compressed bytes come
    back to the host. optimize_huffman adds a histogram pass (one more
    dispatch, ~2 KB download) and re-encodes with the optimal tables as
    runtime data. entropy="host" runs the numpy reference coder on the
    device coefficients."""
    config = config or EncodeConfig()
    h, w = image.shape[:2]
    if config.entropy == "host":
        return _encode_grayscale_host(image, config)
    is_rgb = image.ndim == 3
    image = _pad_to_blocks(image)
    ph, pw = image.shape[:2]
    img_dev = jnp.asarray(image)
    specs, luts = None, entropy_device.standard_luts()
    if config.optimize_huffman:
        stats = jax.device_get(_gray_stats_fn(ph, pw, config, is_rgb)(img_dev))
        specs, luts = optimal_tables(stats, GRAY_CLASSES)
    if config.restart_interval:
        segments = _encode_restart_segments_device(img_dev, config, is_rgb, luts)
    else:
        segments = [_encode_segment_device(img_dev, config, is_rgb, luts)]
    return jfif.assemble(w, h, config, segments, huffman_specs=specs)


def _encode_grayscale_host(image: np.ndarray, config: EncodeConfig) -> bytes:
    """entropy="host": device coefficients, numpy entropy coder (the
    reference coder the device paths are tested against)."""
    h, w = image.shape[:2]
    zz = grayscale_coefficients(image, config)
    seg_ids = (
        np.arange(zz.shape[0]) // config.restart_interval
        if config.restart_interval
        else None
    )
    specs = luts = None
    if config.optimize_huffman:
        freqs = tables.floor_frequencies(
            entropy_host.symbol_frequencies(zz, segment_ids=seg_ids)
        )
        specs = {k: tables.optimal_spec(freqs[k]) for k in GRAY_CLASSES}
        luts = tables.huffman_luts_from_specs(specs)
    segments = entropy_host.encode_scan(
        zz, segment_ids=seg_ids, pad_ones=config.pad_ones, luts=luts
    )
    return jfif.assemble(w, h, config, segments, huffman_specs=specs)


@functools.lru_cache(maxsize=64)
def _encode_gray_restart_device(
    ph: int, pw: int, cfg: EncodeConfig, is_rgb: bool,
    cap_words_per_block: int,
):
    """Jitted restart-interval grayscale encode fn(img, luts): N restart
    segments packed as N independent byte-aligned streams in ONE program
    (T.81 DRI; the same per-segment mechanics each mesh shard runs in
    parallel.sharding, here on the segment axis of a single device)."""
    nb = (ph // 8) * (pw // 8)
    seg_blocks = cfg.restart_interval  # grayscale: 1 MCU == 1 block
    n_seg = -(-nb // seg_blocks)
    n_total = n_seg * seg_blocks

    @jax.jit
    def fn(img, luts):
        zz = _gray_levels(img, cfg, is_rgb).astype(jnp.int32)
        if n_total != nb:
            zz = jnp.pad(zz, ((0, n_total - nb), (0, 0)))
        dcd = entropy_device.dc_differences(zz[:, 0], seg_blocks)
        return entropy_device.encode_segments_device(
            zz, seg_blocks, nb, 0, dcd, cap_words_per_block,
            pad_ones=cfg.pad_ones, luts=luts,
        )

    return fn


def segments_from_streams(streams: np.ndarray, totals: np.ndarray) -> list[bytes]:
    """Host finish for segment-parallel device output: slice each
    segment's valid words and byte-stuff (native when available)."""
    out = []
    stuffer = None
    from . import native

    if native.available():
        stuffer = native.words_to_stuffed
    for i in range(streams.shape[0]):
        total_bits = int(totals[i])
        words = streams[i, : (total_bits + 31) // 32]
        if stuffer is not None:
            out.append(stuffer(words, total_bits))
        else:
            raw = np.frombuffer(
                words.astype(">u4").tobytes(), np.uint8
            )[: (total_bits + 7) // 8]
            out.append(entropy_host.stuff_bytes(np.asarray(raw)))
    return out


def _encode_restart_segments_device(
    img_dev, config: EncodeConfig, is_rgb: bool, luts
) -> list[bytes]:
    """Device encode honoring restart_interval on one device: returns the
    per-segment entropy byte strings for jfif.assemble."""
    ph, pw = img_dev.shape[:2]
    key = (ph, pw, config, is_rgb, "restart")
    for cap in capacity_ladder(config, key):
        fn = _encode_gray_restart_device(ph, pw, config, is_rgb, cap)
        streams, totals, overflow = fn(img_dev, luts)
        if not bool(overflow):
            record_cap(key, cap)
            streams, totals = jax.device_get((streams, totals))
            return segments_from_streams(streams, totals)
    raise AssertionError("worst-case entropy capacity overflowed (bug)")


_CAP_HISTORY_MAX = 4096
_CAP_DECAY_PERIOD = 32  # encodes between one-rung-lower probes
_cap_history: dict = {}  # encode-site key -> [last rung that fit, uses]


def capacity_ladder(
    config: EncodeConfig, key=None
) -> tuple[int, ...]:
    """Overflow-retry capacity schedule (words per block): the configured
    heuristic, then a middle bucket, then the absolute worst case. The
    middle bucket (16 words = 8 bpp) caps the worst-case capacity jump
    for pathological content at ~2x instead of the 6.6x straight to
    MAX_WORDS_PER_BLOCK.

    key: optional encode-site key (shape + config). When content at this
    site previously overflowed the heuristic rung, the ladder starts at
    the rung that fit (`record_cap`) — recurring pathological content
    (a serving stream of Q=1 noise) pays the retry dispatch ONCE, not
    per image. Normal content never bumps, so the history is inert for
    it. The remembered rung DECAYS: every _CAP_DECAY_PERIOD encodes the
    ladder probes one rung lower, so a single pathological image cannot
    pin the site at a worst-case rung for the process lifetime."""
    start = config.capacity_words_per_block
    if key is not None:
        ent = _cap_history.get(key)
        if ent is not None:
            rung, uses = ent
            ent[1] = uses + 1
            if rung > start and uses % _CAP_DECAY_PERIOD == _CAP_DECAY_PERIOD - 1:
                rung = _rung_below(rung, start)
            start = max(start, rung)
    ladder = [start]
    if ladder[-1] < 16:
        ladder.append(16)
    if ladder[-1] < entropy_device.MAX_WORDS_PER_BLOCK:
        ladder.append(entropy_device.MAX_WORDS_PER_BLOCK)
    return tuple(ladder)


def _rung_below(rung: int, start: int) -> int:
    """The ladder rung one below `rung` for a config whose heuristic rung
    is `start` (the ladder is start < 16 < MAX_WORDS_PER_BLOCK)."""
    if rung > 16:
        return max(16, start)
    return start


def record_cap(key, cap: int) -> None:
    """Remember the capacity rung that fit at this encode site (LRU
    bounded; a serving process must not leak). A success at a LOWER rung
    than remembered (the periodic decay probe) overwrites it — the
    history tracks current content, not the worst image ever seen."""
    if key is None:
        return
    ent = _cap_history.pop(key, None)
    uses = ent[1] if ent is not None else 0
    _cap_history[key] = [cap, uses]
    while len(_cap_history) > _CAP_HISTORY_MAX:
        _cap_history.pop(next(iter(_cap_history)))


_SPEC_BYTES = 1 << 21  # default speculation when no history exists
_SPEC_HISTORY_MAX = 4096  # LRU bound: a serving process must not leak
_spec_history: dict = {}  # fetch-site key -> last stream words (adaptive)


def _spec_bucket(words: int) -> int:
    """Round a word count up to a ~1.5x-geometric bucket so only O(20)
    distinct slice executables ever compile."""
    b = 1 << 14  # 64 KB
    while b < words:
        b = b * 3 // 2
    return b


def fetch_stream_words(buf, total_bits_dev, overflow_dev, spec_key=None):
    """One-roundtrip fetch of (overflow, total_bits, stream words).

    Reading overflow + length first and the valid prefix second costs two
    host<->device round trips, while downloading the whole capacity
    buffer moves ~10x the stream. Fetch everything in ONE device_get
    with a speculative prefix sized from the previous stream at this
    fetch site (same image shape/config -> almost identical size); only
    streams larger than the speculation pay a second fetch.
    Returns (words or None-if-overflowed, total_bits)."""
    hist = _spec_history.get(spec_key) if spec_key is not None else None
    if hist is None:
        spec_words = _SPEC_BYTES // 4
    else:
        spec_words = _spec_bucket(hist + hist // 4)
    spec_words = min(spec_words, buf.shape[0])
    overflow, total_bits, head = jax.device_get(
        (overflow_dev, total_bits_dev, buf[:spec_words])
    )
    if bool(overflow):
        return None, 0
    total_bits = int(total_bits)
    nwords = (total_bits + 31) // 32
    if spec_key is not None:
        _spec_history.pop(spec_key, None)  # re-insert = move to MRU end
        _spec_history[spec_key] = nwords
        while len(_spec_history) > _SPEC_HISTORY_MAX:
            _spec_history.pop(next(iter(_spec_history)))
    if nwords <= spec_words:
        return head[:nwords], total_bits
    rest = fetch_prefix_words(buf[spec_words:], nwords - spec_words)
    return np.concatenate([head, rest]), total_bits


def fetch_prefix(buf, nbytes: int) -> np.ndarray:
    """Download only the valid prefix of a device byte buffer.

    Slices to a power-of-two bucket first so at most ~log2(cap) distinct
    slice executables ever compile, then trims on host. Downloading the
    full capacity buffer costs more than the encode itself for large
    images (the capacity is ~12x the typical stream size)."""
    k = int(nbytes)
    if k <= 0:
        return np.empty((0,), np.uint8)
    bucket = 1 << max(12, (k - 1).bit_length())
    if bucket >= buf.shape[0]:
        return np.asarray(buf)[:k]
    return np.asarray(buf[:bucket])[:k]


def _encode_segment_device(img_dev, config: EncodeConfig, is_rgb: bool,
                           luts) -> bytes:
    """Single-segment fully-on-device encode with capacity-overflow retry."""
    ph, pw = img_dev.shape[:2]
    host_stuff = config.stuff == "host" and _native_available()
    key = (ph, pw, config, is_rgb)
    for cap in capacity_ladder(config, key):
        fn = _encode_gray_device(
            ph, pw, config, is_rgb, cap, stuff=not host_stuff,
        )
        out, count, overflowed = fn(img_dev, luts)
        if host_stuff:
            from . import native

            words, total_bits = fetch_stream_words(
                out, count, overflowed, spec_key=key
            )
            if words is not None:
                record_cap(key, cap)
                return native.words_to_stuffed(words, total_bits)
        elif not bool(overflowed):
            record_cap(key, cap)
            return fetch_prefix(out, count).tobytes()
    raise AssertionError("worst-case entropy capacity overflowed (bug)")


def _native_available() -> bool:
    from . import native

    return native.available()


def fetch_prefix_words(buf, nwords: int) -> np.ndarray:
    """Prefix download for uint32 word buffers (pow-2 bucketed slices)."""
    k = int(nwords)
    if k <= 0:
        return np.empty((0,), np.uint32)
    bucket = 1 << max(10, (k - 1).bit_length())
    if bucket >= buf.shape[0]:
        return np.asarray(buf)[:k]
    return np.asarray(buf[:bucket])[:k]


def encode_file(input_path: str, output_path: str, config: EncodeConfig | None = None) -> int:
    """BMP in, JPEG out (the reference CLI's contract, natural_c main.c:4-35).
    Returns the number of bytes written."""
    rgb = bmp.read(input_path)
    config = config or EncodeConfig()
    if config.subsampling == "gray":
        data = encode_grayscale(rgb, config)
    else:
        from . import color_pipeline  # deferred: heavier path

        data = color_pipeline.encode_color(rgb, config)
    with open(output_path, "wb") as f:
        f.write(data)
    return len(data)
