"""Batch encode: many images per dispatch.

The reference encodes one image per process run (natural_c main.c). For
serving, the win is batching: many independent images amortize dispatch
and fill the device. Strategy (SURVEY.md §7.1 step 6): bucket images by
padded shape, pad the batch axis to power-of-two sizes so at most
O(log B * shapes) programs ever compile, transform every image of the
bucket in one vmapped program, and fold the image axis into the block
axis of the entropy coder — each image is one segment of the batched
segment concat, so every image gets its own scan (per-image DC chain,
per-image byte stream).
"""
from __future__ import annotations

import functools
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np

from .config import EncodeConfig
from .entropy import device as entropy_device
from .io import jfif
from .ops import blocks
from . import pipeline


def _sharded(local_fn, mesh, n_in: int):
    """jit(local_fn) — or, with a 1-D mesh, local_fn under shard_map with
    the batch axis (first argument and every output) split across the
    mesh and the remaining n_in - 1 arguments (tables) replicated: pure
    data parallelism, no collectives. Returns fn -> (streams, totals,
    overflow)."""
    if mesh is None:
        return jax.jit(local_fn)

    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]

    def shard_fn(*args):
        streams, totals, overflow = local_fn(*args)
        return streams, totals, overflow[None]

    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis),) + (P(),) * (n_in - 1),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )

    def fn(*args):
        streams, totals, overflow = sharded(*args)
        return streams, totals, jnp.any(overflow)

    return jax.jit(fn)


def _sharded_stats(local_fn, mesh):
    """jit(local_fn(imgs, valid_img)) — or, with a mesh, its per-shard
    histograms psum'd over the batch axis."""
    if mesh is None:
        return jax.jit(local_fn)

    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]

    def shard_fn(imgs, valid_img):
        st = local_fn(imgs, valid_img)
        return jax.tree.map(lambda x: jax.lax.psum(x, axis), st)

    return jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P(),
        check_vma=False,
    ))


@functools.lru_cache(maxsize=128)
def _batch_encode_fn(
    bsz: int,
    ph: int,
    pw: int,
    cfg: EncodeConfig,
    is_rgb: bool,
    cap_words_per_block: int,
    mesh=None,
):
    """Batched encode fn(imgs, luts) over [bsz, ph, pw(, 3)]: the
    transform vmaps, then the image axis FOLDS INTO THE BLOCK AXIS — one
    symbolize + block pack over every block of every image, and the
    batched segment concat (treepack.concat_segments_tree) emits one
    stream per image. Returns (streams [bsz, nb*cap] u32, total_bits
    [bsz], overflow). mesh: optional 1-D mesh — the batch axis shards
    across it."""
    nb = (ph // 8) * (pw // 8)

    def encode_local(imgs, luts):
        b = imgs.shape[0]
        zz = jax.vmap(lambda im: pipeline._gray_levels(im, cfg, is_rgb))(imgs)
        flat = zz.reshape(b * nb, 64).astype(jnp.int32)
        dcd = entropy_device.dc_differences(flat[:, 0], nb)
        return entropy_device.encode_segments_device(
            flat, nb, b * nb, 0, dcd, cap_words_per_block,
            pad_ones=cfg.pad_ones, luts=luts,
        )

    return _sharded(encode_local, mesh, 2)


def _bucket_batch(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=32)
def _batch_gray_stats_fn(bsz: int, ph: int, pw: int, cfg: EncodeConfig,
                         is_rgb: bool, mesh=None):
    """Jitted pass 1 of BATCHED 2-pass optimal coding: [bsz, ph, pw(,3)]
    -> symbol count tensors summed over the whole batch (one ~2 KB
    download), per-image DC chains; bucket-padding images (valid_img
    False) are excluded."""
    nb = (ph // 8) * (pw // 8)

    def stats_local(imgs, valid_img):
        b = imgs.shape[0]
        zz = jax.vmap(lambda im: pipeline._gray_levels(im, cfg, is_rgb))(imgs)
        # bucket-padding images must not bias the shared tables
        return entropy_device.symbol_histograms(
            zz.reshape(b * nb, 64), seg_len=nb,
            valid=jnp.repeat(valid_img, nb),
        )

    return _sharded_stats(stats_local, mesh)


@functools.lru_cache(maxsize=32)
def _batch_color_stats_fn(bsz: int, ph: int, pw: int, cfg: EncodeConfig,
                          mesh=None):
    """Jitted pass 1 of BATCHED color 2-pass optimal coding:
    [bsz, 3, ph, pw] planar RGB -> per-class symbol count tensors summed
    over the batch, per-image per-component DC chains."""
    from . import color_pipeline as cp

    _, table_sel, comp_id = cp._scan_layout(ph, pw, cfg.subsampling)
    nslots = table_sel.shape[0]

    def stats_local(imgs, valid_img):
        b = imgs.shape[0]
        zz = jax.vmap(lambda im: cp._color_levels(im, cfg))(imgs)
        zz = zz.reshape(b * nslots, 64).astype(jnp.int32)
        dcd = cp._per_component_dc_diff(
            zz[:, 0], np.tile(comp_id, b), nslots
        )
        return entropy_device.symbol_histograms(
            zz, table_sel=jnp.asarray(np.tile(table_sel, b)), dc_diff=dcd,
            valid=jnp.repeat(valid_img, nslots),
        )

    return _sharded_stats(stats_local, mesh)


@functools.lru_cache(maxsize=64)
def _batch_color_fn(
    bsz: int, ph: int, pw: int, cfg: EncodeConfig, cap_words_per_block: int,
    mesh=None,
):
    """Batched color encode fn(imgs, luts) over planar [bsz, 3, ph, pw]:
    the per-component transforms vmap, the image axis folds into the
    per-class block packs and MCU merges (color_pipeline
    ._color_block_words with per-image DC chains), and the batched
    segment concat emits one stream per image. Returns (streams,
    total_bits, overflow)."""
    from . import color_pipeline as cp

    nslots = cp._scan_layout(ph, pw, cfg.subsampling)[0].shape[0]
    cap = cap_words_per_block

    def encode_local(imgs, luts):
        b = imgs.shape[0]
        zy, zcb, zcr = jax.vmap(lambda im: cp._component_levels(im, cfg))(imgs)
        nmcu = zcb.shape[1]
        w_all, b_all, overflow = cp._color_block_words(
            zy, zcb, zcr, ph // 8, pw // 8, cfg.subsampling, cap, luts=luts
        )
        return entropy_device.segment_streams(
            w_all, b_all, nmcu, nslots * cap, cfg.pad_ones, overflow
        )

    return _sharded(encode_local, mesh, 2)


def _encode_buckets(images, config: EncodeConfig, mesh, prepare, shape_of,
                    encode_fn, stats_fn, classes) -> list[bytes]:
    """Shared batch driver: bucket images by padded shape, pad each
    bucket's batch axis to a power of two (a multiple of the mesh size),
    optionally run the 2-pass histogram pass (tables SHARED by the
    bucket), then encode every bucket in one dispatch per capacity rung.
    Returns files in input order.

    prepare(img, key) -> the padded device-layout image; shape_of(img)
    -> bucket key; encode_fn(bsz, key, cap) / stats_fn(bsz, key) -> the
    jitted programs."""
    groups = defaultdict(list)
    for i, img in enumerate(images):
        groups[shape_of(img)].append(i)

    n_dev = mesh.devices.size if mesh is not None else 1
    out: list[bytes | None] = [None] * len(images)
    for key, idxs in groups.items():
        batch = [prepare(images[i], key) for i in idxs]
        bsz = -(-_bucket_batch(len(batch)) // n_dev) * n_dev
        while len(batch) < bsz:
            batch.append(np.zeros_like(batch[0]))
        arr = _device_batch(np.stack(batch), mesh)

        specs, luts = None, entropy_device.standard_luts()
        if config.optimize_huffman:
            # batched 2-pass: one histogram dispatch over the bucket,
            # one host package-merge, tables optimal for the BATCH
            # (every file is still a standalone baseline JPEG declaring
            # its tables in DHT)
            valid = _device_batch(np.arange(bsz) < len(idxs), mesh)
            stats = jax.device_get(stats_fn(bsz, key)(arr, valid))
            specs, luts = pipeline.optimal_tables(stats, classes)

        for cap in pipeline.capacity_ladder(config):
            streams, totals, overflow = encode_fn(bsz, key, cap)(arr, luts)
            if not bool(overflow):
                streams, totals = jax.device_get((streams, totals))
                break
        else:
            raise AssertionError("worst-case entropy capacity overflowed (bug)")

        segs = pipeline.segments_from_streams(streams, totals)
        for j, i in enumerate(idxs):
            h, w = images[i].shape[:2]
            out[i] = jfif.assemble(w, h, config, [segs[j]],
                                   huffman_specs=specs)
    return out  # type: ignore[return-value]


def _device_batch(arr: np.ndarray, mesh):
    """Place a host batch (optionally batch-sharded)."""
    arr = jnp.asarray(arr)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        arr = jax.device_put(
            arr, NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
        )
    return arr


def encode_color_batch(
    images: list[np.ndarray],
    config: EncodeConfig | None = None,
    mesh=None,
) -> list[bytes]:
    """Encode a list of RGB uint8 images to color JFIF streams in
    one-or-few device dispatches. Returns files in input order.

    mesh: optional 1-D jax.sharding.Mesh — the batch axis shards across
    its devices (data parallelism over images)."""
    from . import color_pipeline as cp

    config = config or EncodeConfig(subsampling="420")
    if config.restart_interval or config.entropy != "device":
        # The batched bodies emit single-segment streams with no RSTn
        # markers and always pack on-device; a restart-interval or
        # host-entropy config rides the per-image encoder.
        return [cp.encode_color(img, config) for img in images]

    def shape_of(img):
        return cp.padded_dims_color(*img.shape[:2], config.subsampling)

    def prepare(img, key):
        # planar [3, PH, PW] at the device boundary
        return np.moveaxis(cp._pad_color(img, config.subsampling), -1, 0)

    return _encode_buckets(
        images, config, mesh, prepare, shape_of,
        lambda bsz, key, cap: _batch_color_fn(bsz, *key, config, cap, mesh),
        lambda bsz, key: _batch_color_stats_fn(bsz, *key, config, mesh),
        cp.COLOR_CLASSES,
    )


def encode_grayscale_batch(
    images: list[np.ndarray],
    config: EncodeConfig | None = None,
    mesh=None,
) -> list[bytes]:
    """Encode a list of uint8 images ([H,W] or [H,W,3]) to grayscale JFIF
    streams in one-or-few device dispatches. Returns files in input order.

    mesh: optional 1-D jax.sharding.Mesh — the batch axis shards across
    its devices (data parallelism over images, SURVEY.md §2.4): each
    device encodes its images independently, no collectives at all."""
    config = config or EncodeConfig()
    if config.restart_interval or config.entropy != "device":
        # see encode_color_batch
        return [pipeline.encode_grayscale(img, config) for img in images]

    def shape_of(img):
        return (*blocks.padded_dims(*img.shape[:2]), img.ndim == 3)

    def prepare(img, key):
        return pipeline._pad_to_blocks(img)

    return _encode_buckets(
        images, config, mesh, prepare, shape_of,
        lambda bsz, key, cap: _batch_encode_fn(
            bsz, key[0], key[1], config, key[2], cap, mesh),
        lambda bsz, key: _batch_gray_stats_fn(
            bsz, key[0], key[1], config, key[2], mesh),
        pipeline.GRAY_CLASSES,
    )
