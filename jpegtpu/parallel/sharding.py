"""Multi-device sharded encode: MCU-row shards + restart-marker stitching.

The reference is a single-image, single-core-offload encoder; its only
"distributed" axis is the A72->C7x IPC boundary (SURVEY.md §2.4-2.5). The
scale-out here replaces that with a jax.sharding.Mesh:

  * The image is sharded by MCU rows (rows of 8x8 blocks) across the mesh
    axis — the "sequence parallel" analog for images (SURVEY.md §5.7).
  * The two serial dependencies of the JPEG scan are broken per shard:
    - the DC predictor resets at each restart marker (T.81 F.1.2.3), so a
      shard == a restart segment and each device runs an independent chain
      (vs the reference's global lastDC, natural_c rle.c:59-70);
    - the bitstream is byte-aligned per segment, so each device packs its
      own bytes and the host concatenates segment_0 || RST_0 || segment_1 …
  * The only cross-device communication is an all_gather of per-shard
    byte lengths (each device then knows every segment's offset) — a few
    bytes, replacing the reference's shared-DDR DTO handoff
    (dsp main.c:471-490).

Everything inside the shard_map is ordinary single-device pipeline code,
so the multi-device path reuses ops/ and entropy/ verbatim.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import EncodeConfig
from ..entropy import device as entropy_device
from ..io import jfif
from .. import pipeline


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the 'shard' axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("shard",))


def shard_padded_dims(h: int, w: int, n_shards: int) -> tuple[int, int]:
    """Pad dims so width is a block multiple and height splits into
    n_shards equal bands of whole MCU rows."""
    ph = (h + 8 * n_shards - 1) // (8 * n_shards) * (8 * n_shards)
    pw = (w + 7) // 8 * 8
    return ph, pw


def restart_subsegments(rows_per_shard: int, mcus_per_row: int) -> int:
    """Restart interval R for equal shards of rows_per_shard MCU rows:
    DRI's payload is a 16-bit field (T.81 B.2.4.4), so a shard whose MCU
    count exceeds 65535 must emit several restart segments, and R must
    divide the shard size so segment boundaries stay globally periodic
    (only the scan's LAST segment may be short, T.81 B.2.4.4).

    A whole-row interval R = mcus_per_row * (divisor of rows_per_shard)
    always exists with R >= mcus_per_row — no shard geometry can degrade
    to 1-MCU segments; a larger plain divisor of the total is preferred
    when a bounded trial finds one."""
    total = rows_per_shard * mcus_per_row
    if total <= 0xFFFF:
        return total
    best = 0
    kmax = min(0xFFFF // mcus_per_row, rows_per_shard)
    for k in range(kmax, 0, -1):
        if rows_per_shard % k == 0:
            best = mcus_per_row * k
            break
    k = -(-total // 0xFFFF)
    for _ in range(4096):  # bounded: give up rather than scan O(total)
        if total % k == 0:
            best = max(best, total // k)
            break
        k += 1
    assert best >= 1, (
        f"no legal restart interval for shard geometry "
        f"{rows_per_shard}x{mcus_per_row}"
    )
    return best


@functools.lru_cache(maxsize=32)
def _sharded_encode_fn(
    mesh: Mesh,
    ph: int,
    pw: int,
    cfg: EncodeConfig,
    is_rgb: bool,
    cap_words_per_block: int,
):
    """Build the jitted sharded encode step for a padded shape.

    Returns fn(img, luts) -> (streams [n, k, W] u32, total_bits [n, k]
    i32, overflow): each shard packs k byte-aligned restart segments
    (k > 1 only when the shard's MCU count exceeds DRI's 16-bit limit)
    with the runtime Huffman tables luts (tables.stacked_luts,
    replicated). total_bits is REPLICATED across the mesh via all_gather
    so every host of a multi-host mesh can read all lengths without
    touching non-addressable shards.
    """
    n = mesh.devices.size
    nb_local = (ph // n // 8) * (pw // 8)
    seg_blocks = restart_subsegments(ph // n // 8, pw // 8)

    def local_encode(img_local, luts):
        zz = pipeline._gray_levels(img_local, cfg, is_rgb).astype(jnp.int32)
        dcd = entropy_device.dc_differences(zz[:, 0], seg_blocks)
        streams, totals, overflow = entropy_device.encode_segments_device(
            zz, seg_blocks, nb_local, 0, dcd, cap_words_per_block,
            pad_ones=cfg.pad_ones, luts=luts,
        )
        # Cross-shard exchange: every device (hence every host) learns
        # all segment lengths — ~n*k*4 bytes, replacing the reference's
        # shared-DDR DTO handoff (dsp main.c:471-490).
        all_totals = jax.lax.all_gather(totals, "shard")  # [n, k]
        return streams[None], all_totals, overflow[None]

    spec = P("shard", None, None) if is_rgb else P("shard", None)
    sharded = jax.shard_map(
        local_encode,
        mesh=mesh,
        in_specs=(spec, P()),
        # all_totals is identical on every shard -> replicated out_spec.
        out_specs=(P("shard", None, None), P(None, None), P("shard")),
        check_vma=False,
    )

    def fn(img, luts):
        streams, all_totals, overflow = sharded(img, luts)
        return streams, all_totals, jnp.any(overflow)

    return jax.jit(fn)


@functools.lru_cache(maxsize=16)
def _sharded_stats_fn(mesh: Mesh, ph: int, pw: int, cfg: EncodeConfig,
                      is_rgb: bool):
    """Pass 1 of SHARDED 2-pass optimal coding: per-shard symbol
    histograms (same levels + per-segment DC chains the sharded encode
    packs), psum'd over the mesh — every device (and host) holds the
    global counts, so every host builds the SAME tables."""
    n = mesh.devices.size
    seg_blocks = restart_subsegments(ph // n // 8, pw // 8)

    def local_stats(img_local):
        zz = pipeline._gray_levels(img_local, cfg, is_rgb).astype(jnp.int32)
        st = entropy_device.symbol_histograms(zz, seg_len=seg_blocks)
        return jax.tree.map(lambda x: jax.lax.psum(x, "shard"), st)

    spec = P("shard", None, None) if is_rgb else P("shard", None)
    sharded = jax.shard_map(
        local_stats, mesh=mesh, in_specs=spec, out_specs=P(),
        check_vma=False,
    )
    return jax.jit(sharded)


def global_input(image_np: np.ndarray, mesh: Mesh, spec: P):
    """Device placement of a host image for a (possibly multi-host) mesh.

    Single-process: plain device_put. Multi-host: every host holds the
    full image (the reference's host also owns the whole input,
    dsp main.c:398-450) and contributes only its ADDRESSABLE shards via
    make_array_from_callback — no host ever touches remote device memory.
    """
    from jax.sharding import NamedSharding

    sharding_ = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(image_np), sharding_)
    return jax.make_array_from_callback(
        image_np.shape, sharding_, lambda idx: image_np[idx]
    )


def gather_segments_multihost(streams, totals_np: np.ndarray) -> list[bytes]:
    """Per-shard segment words -> ordered list of stuffed segment bytes.

    This is the multi-host replacement for the reference's host-side
    final assembly (dsp_port/jpeg_client/main.c:483-530: IPC return ->
    saveJPEG). Single-process: one device_get. Multi-host: each host
    fetches ONLY its addressable shards of the sharded `streams` array,
    stuffs its segments, and the hosts exchange the (bucketed-padded)
    segment bytes between hosts via process_allgather — every host ends up
    with the full ordered segment list; the coordinator writes the file.
    """
    n, k, _w = streams.shape
    if jax.process_count() == 1:
        arr = jax.device_get(streams)
        return pipeline.segments_from_streams(
            arr.reshape(n * k, _w), totals_np.reshape(-1)
        )

    from jax.experimental import multihost_utils

    seg_bytes: dict[int, bytes] = {}
    for shard in streams.addressable_shards:
        i = shard.index[0].start or 0
        words = np.asarray(shard.data).reshape(k, _w)
        segs = pipeline.segments_from_streams(words, totals_np[i])
        for j, s in enumerate(segs):
            seg_bytes[i * k + j] = s

    my_ids = sorted(seg_bytes)
    lens = np.asarray([len(seg_bytes[i]) for i in my_ids], np.int64)
    # Segments concatenate into ONE flat per-host buffer padded to the
    # max per-host TOTAL (gathered first, tiny), so skewed segment sizes
    # cost nothing extra: host-to-host traffic is n_hosts * max_host_total bytes,
    # not n_seg * max_segment (the r3 O(n_seg x max_len) exchange).
    flat = np.frombuffer(
        b"".join(seg_bytes[i] for i in my_ids), np.uint8
    )
    total_max = int(np.max(
        multihost_utils.process_allgather(np.asarray([flat.size]))
    ))
    payload = np.zeros(total_max, np.uint8)
    payload[: flat.size] = flat
    ids_all = multihost_utils.process_allgather(np.asarray(my_ids, np.int64))
    lens_all = multihost_utils.process_allgather(lens)
    bufs_all = multihost_utils.process_allgather(payload)
    segments: list[bytes | None] = [None] * (n * k)
    for p in range(ids_all.shape[0]):
        off = 0
        for r in range(ids_all.shape[1]):
            gid = int(ids_all[p, r])
            ln = int(lens_all[p, r])
            segments[gid] = bufs_all[p, off : off + ln].tobytes()
            off += ln
    assert all(s is not None for s in segments), "missing shard segment"
    return segments  # type: ignore[return-value]


def encode_grayscale_sharded(
    image: np.ndarray,
    config: EncodeConfig | None = None,
    mesh: Mesh | None = None,
    orig_shape: tuple[int, int] | None = None,
) -> bytes:
    """Multi-device grayscale encode: returns a standard JFIF stream whose
    scan is n_shards * k restart segments (k > 1 only when a shard holds
    more MCUs than DRI's 16-bit interval can express). Decodes identically
    to a single-device encode of the same pixels at the same restart
    interval (verified by tests/test_sharding.py). Works on multi-host
    meshes: every host calls this with the full image; every host returns
    the complete stream (coordinator writes the file).

    orig_shape: the pre-padding (height, width) to write into the JFIF
    header when `image` was already padded by the caller (e.g. a
    pre-placed device input) — without it the header would carry the
    padded dims and the stream would decode to the padded size."""
    config = config or EncodeConfig()
    mesh = mesh or make_mesh()
    n = mesh.devices.size
    h, w = orig_shape if orig_shape is not None else image.shape[:2]
    ih, iw = image.shape[:2]
    ph, pw = shard_padded_dims(h, w, n)
    if (ph, pw) != (ih, iw):
        pad = [(0, ph - ih), (0, pw - iw)] + [(0, 0)] * (image.ndim - 2)
        image = np.pad(image, pad, mode="edge")
    is_rgb = image.ndim == 3
    spec = P("shard", None, None) if is_rgb else P("shard", None)
    img_global = global_input(image, mesh, spec)

    specs, luts = None, entropy_device.standard_luts()
    if config.optimize_huffman:
        # Sharded 2-pass optimal coding: per-shard histograms psum to
        # global counts (pass 1), every host package-merges the SAME
        # tables, pass 2 re-encodes with the tables as runtime data.
        stats = jax.device_get(
            _sharded_stats_fn(mesh, ph, pw, config, is_rgb)(img_global)
        )
        specs, luts = pipeline.optimal_tables(stats, pipeline.GRAY_CLASSES)

    seg_blocks = restart_subsegments(ph // n // 8, pw // 8)
    restart_cfg = EncodeConfig(
        quality=config.quality,
        subsampling=config.subsampling,
        restart_interval=seg_blocks,
        pad_ones=config.pad_ones,
        bitexact=config.bitexact,
    )

    for cap in pipeline.capacity_ladder(config):
        fn = _sharded_encode_fn(mesh, ph, pw, config, is_rgb, cap)
        streams, totals, overflow = fn(img_global, luts)
        if not bool(overflow):
            break
    else:
        raise AssertionError("worst-case entropy capacity overflowed (bug)")

    totals_np = jax.device_get(totals)
    segments = gather_segments_multihost(streams, totals_np)
    return jfif.assemble(w, h, restart_cfg, segments, huffman_specs=specs)
