"""Color (YCbCr) baseline encode: 4:2:0, 4:2:2 and 4:4:4 interleaved scans.

A capability the reference lacks entirely — it discards chroma at
conversion (natural_c converter.c:51 keeps only Y; SURVEY.md §2.1 "scope
boundaries"). Each component runs the tiled block-diagonal transform,
its blocks are packed per Huffman table class by the shared on-device
entropy coder, and the per-block streams merge into per-MCU streams in
the interleaved scan order (T.81 A.2.3) with per-component DC chains.

Layout (T.81 A.2.3): for 4:2:0 one MCU = 4 Y blocks (2x2) + Cb + Cr;
for 4:2:2 one MCU = 2 Y (horizontal pair) + Cb + Cr; for 4:4:4 one MCU =
Y + Cb + Cr. Components use luminance (id 0) / chrominance (id 1) quant +
Huffman tables.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import pipeline, tables
from .config import EncodeConfig
from .entropy import device as entropy_device
from .entropy import host as entropy_host
from .entropy import treepack
from .io import jfif
from .ops import color

COLOR_CLASSES = ("dc_lum", "ac_lum", "dc_chrom", "ac_chrom")


# per-mode geometry: MCU pixel size, Y blocks per MCU, slots per MCU
_MODES = {
    "444": {"mcu_h": 8, "mcu_w": 8, "ky": 1, "slots": 3},
    "422": {"mcu_h": 8, "mcu_w": 16, "ky": 2, "slots": 4},
    "420": {"mcu_h": 16, "mcu_w": 16, "ky": 4, "slots": 6},
}


def slots_per_mcu(subsampling: str) -> int:
    return _MODES[subsampling]["slots"]


def mcu_dims(subsampling: str) -> tuple[int, int]:
    m = _MODES[subsampling]
    return m["mcu_h"], m["mcu_w"]


def padded_dims_color(h: int, w: int, subsampling: str) -> tuple[int, int]:
    mh, mw = mcu_dims(subsampling)
    return (-(-h // mh) * mh, -(-w // mw) * mw)


@functools.lru_cache(maxsize=64)
def _scan_layout(ph: int, pw: int, subsampling: str):
    """Static interleave layout for a padded shape.

    Returns numpy arrays over the scan's block slots:
      gather_idx [nslots]: index into the concatenated per-component block
        array [Y blocks (raster) | Cb blocks | Cr blocks],
      table_sel [nslots]: 0 luma / 1 chroma,
      comp_id [nslots]: 0/1/2 (distinct DC chains, T.81 F.1.1.5.1).
    """
    nbw_y, nbh_y = pw // 8, ph // 8
    ny = nbh_y * nbw_y
    if subsampling == "444":
        nbh_c, nbw_c = nbh_y, nbw_y
        nc = nbh_c * nbw_c
        n_mcu = ny
        slots = []
        for m in range(n_mcu):
            slots.append((m, 0, 0))
            slots.append((ny + m, 1, 1))
            slots.append((ny + nc + m, 1, 2))
    elif subsampling == "422":
        nbh_c, nbw_c = nbh_y, nbw_y // 2
        nc = nbh_c * nbw_c
        slots = []
        for my in range(nbh_y):
            for mx in range(nbw_c):
                for dx in (0, 1):
                    slots.append((my * nbw_y + 2 * mx + dx, 0, 0))
                cidx = my * nbw_c + mx
                slots.append((ny + cidx, 1, 1))
                slots.append((ny + nc + cidx, 1, 2))
    elif subsampling == "420":
        nbh_c, nbw_c = nbh_y // 2, nbw_y // 2
        nc = nbh_c * nbw_c
        slots = []
        for my in range(nbh_c):
            for mx in range(nbw_c):
                for dy in (0, 1):
                    for dx in (0, 1):
                        slots.append(((2 * my + dy) * nbw_y + 2 * mx + dx, 0, 0))
                cidx = my * nbw_c + mx
                slots.append((ny + cidx, 1, 1))
                slots.append((ny + nc + cidx, 1, 2))
    else:
        raise ValueError(subsampling)
    arr = np.asarray(slots, dtype=np.int64)
    return arr[:, 0].copy(), arr[:, 1].astype(np.int32), arr[:, 2].copy()


@functools.lru_cache(maxsize=64)
def _prev_slot_map(comp_key, nslots: int, seg_slots: int):
    """Static predecessor map for per-component DC chains: prev_idx[s] =
    the previous scan slot of slot s's component (within s's restart
    segment), or -1 at a chain start. comp_key is the hashable form of
    the comp_id array (bytes)."""
    comp_id = np.frombuffer(comp_key, dtype=np.int64)
    prev_idx = np.full(nslots, -1, dtype=np.int64)
    last: dict[int, int] = {}
    for s in range(nslots):
        if seg_slots and s % seg_slots == 0:
            last = {}
        c = int(comp_id[s])
        prev_idx[s] = last.get(c, -1)
        last[c] = s
    has_prev = prev_idx >= 0
    return np.where(has_prev, prev_idx, 0), has_prev


def _per_component_dc_diff(
    dc: jnp.ndarray, comp_id: np.ndarray, seg_slots: int = 0
) -> jnp.ndarray:
    """DC differences where each component keeps its own predictor chain
    along scan order (T.81 F.1.1.5.1), resetting every seg_slots slots
    (restart segments; 0 = never). comp_id is STATIC, so the chains
    reduce to one static predecessor gather — dense, vmappable."""
    nslots = int(comp_id.shape[0])
    gather, has_prev = _prev_slot_map(
        comp_id.astype(np.int64).tobytes(), nslots, seg_slots
    )
    prev = jnp.where(jnp.asarray(has_prev), dc[jnp.asarray(gather)], 0)
    return dc - prev


def _component_levels(img, cfg: EncodeConfig):
    """Padded PLANAR RGB [3, PH, PW] -> per-component zigzag levels
    (zy [ny, 64], zcb [nc, 64], zcr [nc, 64]), each in raster block order.

    Planar input is the device-boundary contract: every channel is a
    contiguous plane, as the reference's DSP host stores them in shared
    DDR (dsp bmp_handler.c:78-80)."""
    from .ops import fused_transform

    y, cb, cr = color.rgb_planar_to_ycbcr(img)
    if cfg.subsampling == "420":
        cb = color.subsample_420(cb)
        cr = color.subsample_420(cr)
    elif cfg.subsampling == "422":
        cb = color.subsample_422(cb)
        cr = color.subsample_422(cr)
    qt_luma = jnp.asarray(cfg.luma_quant.astype(np.float32))
    qt_chroma = jnp.asarray(cfg.chroma_quant.astype(np.float32))

    def component_levels(chan, qt):
        # channels are 8-aligned already; pad to tile multiples in-graph
        ch, cw = chan.shape
        th, tw = fused_transform.padded_dims_tile(ch, cw)
        if (th, tw) != (ch, cw):
            chan = jnp.pad(chan, ((0, th - ch), (0, tw - cw)), mode="edge")
        if cfg.dct_dtype == "int32":
            from .ops import int_transform

            return int_transform.transform_tiled_int(
                chan, qt, bitexact=cfg.bitexact, out_blocks=(ch // 8, cw // 8)
            )
        return fused_transform.transform_tiled(
            chan, qt, bitexact=cfg.bitexact, out_blocks=(ch // 8, cw // 8)
        )

    return (component_levels(y, qt_luma), component_levels(cb, qt_chroma),
            component_levels(cr, qt_chroma))


def _color_levels(img, cfg: EncodeConfig):
    """Padded PLANAR RGB [3, PH, PW] -> interleaved zigzag levels
    [nslots, 64] (scan order; the host-coder / test-oracle layout)."""
    ph, pw = img.shape[1:]
    zy, zcb, zcr = _component_levels(img, cfg)
    allz = jnp.concatenate([zy, zcb, zcr], axis=0)
    gather_idx, _, _ = _scan_layout(ph, pw, cfg.subsampling)
    return allz[jnp.asarray(gather_idx)]


def _color_block_words(zy, zcb, zcr, nbh: int, nbw: int, subsampling: str,
                       cap: int, seg_mcus: int = 0, luts=None):
    """Per-MCU packed streams of the interleaved color scan:
    zy [b, ny, 64], zcb/zcr [b, nc, 64] -> (words_t [mcu_cap, b*nmcu],
    bits [b*nmcu], overflow) with mcu_cap = cap * slots_per_mcu — MCU
    streams in scan order, ready for concat_blocks_tree /
    concat_segments_tree. Every image of the batch restarts its DC
    predictors; seg_mcus > 0 (one image) also resets them every seg_mcus
    MCUs (restart segments). luts: runtime Huffman tables
    (tables.stacked_luts), default Annex-K.

    Each component class packs its blocks with the staged symbolize +
    block reduction; the MCU interleave is then explicit merge levels —
    bitstream concat is associative, so y0||y1, y2||y3, ||, ||chroma
    equals the slot-by-slot emission order."""
    b, ny = zy.shape[:2]
    nmcu = zcb.shape[1]
    zy = zy.astype(jnp.int32)
    zcb = zcb.astype(jnp.int32)
    zcr = zcr.astype(jnp.int32)
    ky = _MODES[subsampling]["ky"]
    if subsampling == "420":
        y_scan = (
            zy.reshape(b, nbh // 2, 2, nbw // 2, 2, 64)
            .transpose(0, 1, 3, 2, 4, 5)
            .reshape(b * ny, 64)
        )
    else:  # 422/444: Y scan order IS raster order
        y_scan = zy.reshape(b * ny, 64)
    c_scan = jnp.stack([zcb, zcr], axis=2).reshape(b * 2 * nmcu, 64)
    period = seg_mcus or nmcu
    dcd_y = entropy_device.dc_differences(y_scan[:, 0], ky * period)
    dcd_c = jnp.stack(
        [
            entropy_device.dc_differences(
                z[:, :, 0].reshape(-1), period
            ).reshape(b, nmcu)
            for z in (zcb, zcr)
        ],
        axis=2,
    ).reshape(-1)
    w_y, b_y, ov_y = entropy_device._per_block_words(y_scan, 0, dcd_y, cap,
                                                     luts=luts)
    w_c, b_c, ov_c = entropy_device._per_block_words(c_scan, 1, dcd_c, cap,
                                                     luts=luts)
    if ky == 4:  # 4:2:0 — fold the 2x2 Y blocks of each MCU
        w_y, b_y = treepack.merge_adjacent_t(w_y, b_y)  # y01, y23
        w_y, b_y = treepack.merge_adjacent_t(w_y, b_y)  # y0123 [4cap, nmcu]
    elif ky == 2:  # 4:2:2 — horizontal Y pair
        w_y, b_y = treepack.merge_adjacent_t(w_y, b_y)
    w_c, b_c = treepack.merge_adjacent_t(w_c, b_c)  # cb||cr [2cap, nmcu]
    w_all, b_all = treepack.merge_two_t(w_y, b_y, w_c, b_c)
    return w_all, b_all, ov_y | ov_c


def color_encode_body(img, cfg: EncodeConfig, cap_words_per_block: int,
                      stuff: bool, luts=None):
    """Traceable full color encode body (compose under jit freely).
    img: padded PLANAR RGB [3, PH, PW]. luts: runtime Huffman tables
    (tables.stacked_luts), default Annex-K."""
    ph, pw = img.shape[1:]
    zy, zcb, zcr = _component_levels(img, cfg)
    w_all, b_all, overflow = _color_block_words(
        zy[None], zcb[None], zcr[None], ph // 8, pw // 8, cfg.subsampling,
        cap_words_per_block, luts=luts,
    )
    words, total_bits = treepack.concat_blocks_tree(w_all, b_all)
    words, total_bits = treepack._apply_tail_padding(
        words, total_bits, cfg.pad_ones
    )
    if not stuff:
        return words, total_bits, overflow
    out, nbytes = entropy_device.stuff_bytes_device(words, total_bits)
    return out, nbytes, overflow


def color_segments_body(img, cfg: EncodeConfig, cap_words_per_block: int,
                        seg_mcus: int, luts=None):
    """Traceable segmented color encode: the scan's MCUs split into
    restart segments of seg_mcus MCUs (T.81 DRI), each an independent
    byte-aligned stream (the last one may be short). Returns (streams
    [n_seg, seg_mcus * mcu_cap] u32, total_bits [n_seg] i32, overflow)."""
    ph, pw = img.shape[1:]
    zy, zcb, zcr = _component_levels(img, cfg)
    w_all, b_all, overflow = _color_block_words(
        zy[None], zcb[None], zcr[None], ph // 8, pw // 8, cfg.subsampling,
        cap_words_per_block, seg_mcus=seg_mcus, luts=luts,
    )
    mcap, nmcu = w_all.shape
    n_total = -(-nmcu // seg_mcus) * seg_mcus
    if n_total != nmcu:  # ragged last segment: zero-bit pad MCUs
        w_all = jnp.pad(w_all, ((0, 0), (0, n_total - nmcu)))
        b_all = jnp.pad(b_all, (0, n_total - nmcu))
    return entropy_device.segment_streams(
        w_all, b_all, seg_mcus, seg_mcus * mcap, cfg.pad_ones, overflow
    )


@functools.lru_cache(maxsize=64)
def _encode_color_device(
    ph: int, pw: int, cfg: EncodeConfig, cap_words_per_block: int,
    stuff: bool = True,
):
    """Jitted full color encode fn(img, luts): padded planar RGB ->
    (bytes, nbytes, overflowed); stuff=False returns (words, total_bits,
    overflow) for the host-native stuffer instead. (ph, pw) key the jit
    cache."""

    @jax.jit
    def fn(img, luts):
        return color_encode_body(img, cfg, cap_words_per_block, stuff,
                                 luts=luts)

    return fn


@functools.lru_cache(maxsize=32)
def _encode_color_restart_device(
    ph: int, pw: int, cfg: EncodeConfig, cap_words_per_block: int,
):
    """Jitted restart-interval color encode fn(img, luts) ->
    (streams, total_bits, overflow), one stream per restart segment."""

    @jax.jit
    def fn(img, luts):
        return color_segments_body(img, cfg, cap_words_per_block,
                                   cfg.restart_interval, luts=luts)

    return fn


@functools.lru_cache(maxsize=64)
def _levels_fn(ph: int, pw: int, cfg: EncodeConfig):
    return jax.jit(lambda img: _color_levels(img, cfg))


def _planar(image: np.ndarray):
    return jnp.asarray(np.ascontiguousarray(np.moveaxis(image, -1, 0)))


def _pad_color(image: np.ndarray, subsampling: str) -> np.ndarray:
    """Gray -> 3 channels, then edge-pad on the host to whole MCUs."""
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    h, w = image.shape[:2]
    ph, pw = padded_dims_color(h, w, subsampling)
    if (ph, pw) != (h, w):
        image = np.pad(image, [(0, ph - h), (0, pw - w), (0, 0)], mode="edge")
    return image


def color_coefficients(image: np.ndarray, config: EncodeConfig):
    """Host-visible interleaved levels + layout (for tests / host coder).

    Returns (zz [nslots, 64] int32, table_sel, comp_id).
    """
    image = _pad_color(image, config.subsampling)
    ph, pw = image.shape[:2]
    zz = _levels_fn(ph, pw, config)(_planar(image))
    _, table_sel, comp_id = _scan_layout(ph, pw, config.subsampling)
    return np.asarray(zz), table_sel, comp_id


def _color_stats_local(img, cfg: EncodeConfig, seg_mcus: int):
    """Pass 1 of device 2-pass optimal color coding (traceable): planar
    RGB -> per-class symbol count tensors of the interleaved scan, with
    per-component DC chains reset every seg_mcus MCUs (0 = never)."""
    ph, pw = img.shape[1:]
    _gidx, table_sel, comp_id = _scan_layout(ph, pw, cfg.subsampling)
    zz = _color_levels(img, cfg).astype(jnp.int32)
    dcd = _per_component_dc_diff(
        zz[:, 0], comp_id, seg_mcus * slots_per_mcu(cfg.subsampling)
    )
    return entropy_device.symbol_histograms(
        zz, table_sel=jnp.asarray(table_sel), dc_diff=dcd
    )


@functools.lru_cache(maxsize=16)
def _color_stats_fn(ph: int, pw: int, cfg: EncodeConfig):
    """Jitted pass 1 of device 2-pass optimal color coding."""
    return jax.jit(
        lambda img: _color_stats_local(img, cfg, cfg.restart_interval)
    )


def encode_color(image: np.ndarray, config: EncodeConfig | None = None) -> bytes:
    """RGB uint8 [H, W, 3] -> baseline JFIF YCbCr stream (420/422/444).

    Same contract as pipeline.encode_grayscale: one device program per
    shape encodes transform + entropy; optimize_huffman adds a histogram
    pass; entropy="host" runs the numpy reference coder."""
    config = config or EncodeConfig(subsampling="420")
    h, w = image.shape[:2]
    image = _pad_color(image, config.subsampling)
    if config.entropy == "host":
        return _encode_color_host(image, config, w, h)
    ph, pw = image.shape[:2]
    img_dev = _planar(image)
    specs, luts = None, entropy_device.standard_luts()
    if config.optimize_huffman:
        stats = jax.device_get(_color_stats_fn(ph, pw, config)(img_dev))
        specs, luts = pipeline.optimal_tables(stats, COLOR_CLASSES)
    if config.restart_interval:
        segments = _encode_color_restart(img_dev, config, luts)
    else:
        segments = [_encode_color_segment(img_dev, config, luts)]
    return jfif.assemble(w, h, config, segments, huffman_specs=specs)


def _encode_color_segment(img_dev, config: EncodeConfig, luts) -> bytes:
    """Single-segment device color encode with capacity-overflow retry."""
    ph, pw = img_dev.shape[1:]
    host_stuff = config.stuff == "host" and pipeline._native_available()
    key = (ph, pw, config, "color")
    for cap in pipeline.capacity_ladder(config, key):
        fn = _encode_color_device(ph, pw, config, cap, stuff=not host_stuff)
        out, count, overflowed = fn(img_dev, luts)
        if host_stuff:
            from . import native

            words, total_bits = pipeline.fetch_stream_words(
                out, count, overflowed, spec_key=key
            )
            if words is not None:
                pipeline.record_cap(key, cap)
                return native.words_to_stuffed(words, total_bits)
        elif not bool(overflowed):
            pipeline.record_cap(key, cap)
            return pipeline.fetch_prefix(out, count).tobytes()
    raise AssertionError("worst-case entropy capacity overflowed (bug)")


def _encode_color_restart(img_dev, config: EncodeConfig, luts) -> list[bytes]:
    """Restart-interval device color encode: per-segment byte strings."""
    ph, pw = img_dev.shape[1:]
    key = (ph, pw, config, "color-restart")
    for cap in pipeline.capacity_ladder(config, key):
        fn = _encode_color_restart_device(ph, pw, config, cap)
        streams, totals, overflow = fn(img_dev, luts)
        if not bool(overflow):
            pipeline.record_cap(key, cap)
            streams, totals = jax.device_get((streams, totals))
            return pipeline.segments_from_streams(streams, totals)
    raise AssertionError("worst-case entropy capacity overflowed (bug)")


def _encode_color_host(image: np.ndarray, config: EncodeConfig,
                       w: int, h: int) -> bytes:
    """entropy="host": device coefficients, numpy entropy coder (the
    reference coder the device paths are tested against). image is
    already MCU-padded."""
    zz, table_sel, comp_id = color_coefficients(image, config)
    segment_ids = None
    if config.restart_interval:
        # restart interval counts MCUs; map each block slot to its MCU
        mcu_of_slot = np.arange(zz.shape[0]) // slots_per_mcu(config.subsampling)
        segment_ids = mcu_of_slot // config.restart_interval
    tsel = table_sel.astype(np.int64)
    specs = luts = None
    if config.optimize_huffman:
        freqs = tables.floor_frequencies(entropy_host.symbol_frequencies(
            zz, table_sel=tsel, comp_id=comp_id, segment_ids=segment_ids
        ))
        specs = tables.optimal_specs_from_frequencies(freqs)
        luts = tables.huffman_luts_from_specs(specs)
    segments = entropy_host.encode_scan(
        zz, table_sel=tsel, comp_id=comp_id, segment_ids=segment_ids,
        pad_ones=config.pad_ones, luts=luts,
    )
    return jfif.assemble(w, h, config, segments, huffman_specs=specs)


def encode_color_sharded(
    image: np.ndarray,
    config: EncodeConfig | None = None,
    mesh=None,
    orig_shape: tuple[int, int] | None = None,
) -> bytes:
    """Multi-device color encode: MCU-row shards, shard == restart segment.

    Same contract as parallel.sharding.encode_grayscale_sharded but for
    the interleaved YCbCr scan: each device transforms its horizontal
    band (16 pixel rows per MCU row for 4:2:0, 8 for 4:4:4), runs its own
    per-component DC chains (reset at the restart boundary), and packs an
    independent byte-aligned segment; the host stitches
    seg_0 || RST_0 || seg_1 || ... with DRI = MCUs per shard.

    orig_shape: the pre-padding (height, width) for the JFIF header when
    `image` was already padded by the caller (pre-placed device inputs);
    without it the header would carry the padded dims."""
    from jax.sharding import PartitionSpec as P

    from .parallel.sharding import (
        gather_segments_multihost,
        global_input,
        make_mesh,
        restart_subsegments,
    )

    config = config or EncodeConfig(subsampling="420")
    mesh = mesh or make_mesh()
    n = mesh.devices.size
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    h, w = orig_shape if orig_shape is not None else image.shape[:2]
    mcu_h, mcu_w = mcu_dims(config.subsampling)
    band = mcu_h * n
    ih, iw = image.shape[:2]
    ph = -(-h // band) * band
    pw = padded_dims_color(h, w, config.subsampling)[1]
    if (ph, pw) != (ih, iw):
        image = np.pad(
            image, [(0, ph - ih), (0, pw - iw), (0, 0)], mode="edge"
        )
    img_global = global_input(
        np.ascontiguousarray(np.moveaxis(image, -1, 0)),
        mesh,
        P(None, "shard", None),  # planar [3, H, W], bands along H
    )
    seg_mcus = restart_subsegments(ph // n // mcu_h, pw // mcu_w)

    specs, luts = None, entropy_device.standard_luts()
    if config.optimize_huffman:
        # Sharded color 2-pass: psum'd per-shard histograms -> every
        # host package-merges identical tables -> runtime-table pass 2.
        stats = jax.device_get(
            _sharded_color_stats_fn(mesh, ph, pw, config)(img_global)
        )
        specs, luts = pipeline.optimal_tables(stats, COLOR_CLASSES)

    restart_cfg = EncodeConfig(
        quality=config.quality,
        subsampling=config.subsampling,
        restart_interval=seg_mcus,
        pad_ones=config.pad_ones,
        bitexact=config.bitexact,
    )
    for cap in pipeline.capacity_ladder(config):
        fn = _sharded_color_fn(mesh, ph, pw, config, cap)
        streams, totals, overflow = fn(img_global, luts)
        if not bool(overflow):
            break
    else:
        raise AssertionError("worst-case entropy capacity overflowed (bug)")

    segments = gather_segments_multihost(streams, jax.device_get(totals))
    return jfif.assemble(w, h, restart_cfg, segments, huffman_specs=specs)


@functools.lru_cache(maxsize=16)
def _sharded_color_stats_fn(mesh, ph: int, pw: int, cfg: EncodeConfig):
    """Pass 1 of SHARDED color 2-pass optimal coding: per-shard symbol
    histograms of the interleaved scan (same levels + per-component
    segment-reset DC chains the sharded encode packs), psum'd so every
    host builds the same tables."""
    from jax.sharding import PartitionSpec as P

    from .parallel.sharding import restart_subsegments

    n = mesh.devices.size
    mh, mw = mcu_dims(cfg.subsampling)
    seg_mcus = restart_subsegments(ph // n // mh, pw // mw)

    def local_stats(img_local):
        st = _color_stats_local(img_local, cfg, seg_mcus)
        return jax.tree.map(lambda x: jax.lax.psum(x, "shard"), st)

    sharded = jax.shard_map(
        local_stats, mesh=mesh, in_specs=P(None, "shard", None),
        out_specs=P(), check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=32)
def _sharded_color_fn(mesh, ph: int, pw: int, cfg: EncodeConfig,
                      cap_words_per_block: int):
    """Sharded color encode step fn(img, luts): each shard packs k
    byte-aligned restart sub-segments (k > 1 only past DRI's 16-bit MCU
    limit); segment lengths are all_gathered so every host can assemble.
    Mirrors parallel.sharding._sharded_encode_fn for the interleaved
    scan."""
    from jax.sharding import PartitionSpec as P

    from .parallel.sharding import restart_subsegments

    n = mesh.devices.size
    mh, mw = mcu_dims(cfg.subsampling)
    seg_mcus = restart_subsegments(ph // n // mh, pw // mw)

    def local_encode(img_local, luts):
        streams, totals, overflow = color_segments_body(
            img_local, cfg, cap_words_per_block, seg_mcus, luts=luts
        )
        all_totals = jax.lax.all_gather(totals, "shard")  # [n, k]
        return streams[None], all_totals, overflow[None]

    sharded = jax.shard_map(
        local_encode,
        mesh=mesh,
        in_specs=(P(None, "shard", None), P()),  # planar [3, H, W]
        out_specs=(P("shard", None, None), P(None, None), P("shard")),
        check_vma=False,
    )

    def fn(img, luts):
        streams, all_totals, overflow = sharded(img, luts)
        return streams, all_totals, jnp.any(overflow)

    return jax.jit(fn)
