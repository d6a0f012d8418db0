"""Smoke run of jpegtpu on an NVIDIA GPU: the quickest proof that every
encode path still starts, compiles and gives the right bytes on the card.

    python chip_smoke.py          # one card: all default phases
    python chip_smoke.py --four   # four cards: the sharded paths only

Phases (one card; any failure exits non-zero):
  1. device check — JAX's default device must be a GPU; prints the card's
     kind, the device count, nvidia-smi's name and power limit, and
     whether the native stuffer loaded.
  2. golden parity — for the four golden luma planes (tests/golden): the
     device entropy coder on the reference's zigzag levels reproduces the
     natural_c stream byte for byte; encode_grayscale's float32 levels
     equal the reference's up to rounding-boundary flips (counted and
     located); its stream equals natural_c's when nothing flipped and the
     numpy host coder on the device levels always; int32 levels equal
     the integer numpy oracle exactly.
  3. main path at full width — the 12.19 MPix reference frame (3024x4032)
     in gray, 4:2:0, 4:2:2, 4:4:4, a restart interval, 2-pass optimal
     tables, int32, the sharded entry point on one card, a 64x512^2
     batch, an 8-image stream, an 8K 4:2:0 frame, a Q95 high-texture
     frame that forces the worst-case capacity retry, and the CLI (the
     gpu tests cover the same options for color); every output
     byte-equal to entropy="host" under the same config (the numpy coder
     on the device's coefficients).
  4. card-only tests — the `gpu`-marked tests, in this process.
  5. times — end-to-end MPix/s of each path after warm-up, compile time
     apart as set-up. Informational, not a benchmark.

--four runs only encode_grayscale_sharded / encode_color_sharded of a
7680x4320 frame on a 4-card mesh against the single-card encode at the
restart interval the shard layout implies, and encode_grayscale_batch
over the mesh against the single-card batch.

Inputs are made from a fixed seed or read from tests/golden; nothing
needs PIL or the network. The last line of standard output is one JSON
object naming the device; it is printed only when every phase passed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = ("lena", "blackbuck", "greenland", "offset_sample")
FRAME = (3024, 4032)  # the reference's grad.bmp geometry, 12.19 MPix
FRAME_8K = (4320, 7680)


def device_check() -> dict:
    """JAX's default device (platform, kind, count); raises unless it is a
    GPU (a measurement path never falls back to the CPU)."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {d.platform} ({d.device_kind})"
        )
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def card_line() -> str:
    """nvidia-smi's name and power limit of each card, verbatim."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"


def photo(h: int, w: int, seed: int, color: bool = False) -> np.ndarray:
    """Photographic-complexity synthetic frame: gradient + structured
    texture + sensor noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    grad = (xx + yy) * (255.0 / (h + w))
    tex = 20.0 * np.sin(xx / 3.1) * np.cos(yy / 2.7)

    def plane(scale, sign):
        noise = rng.normal(0, 6.0, (h, w)).astype(np.float32)
        return np.clip(grad * scale + sign * tex + noise, 0, 255).astype(np.uint8)

    if not color:
        return plane(1.0, 1.0)
    return np.stack([plane(0.9, 1.0), plane(1.0, 1.0), plane(1.1, -1.0)], -1)


def texture(h: int, w: int, seed: int, color: bool = False) -> np.ndarray:
    """High-texture content (uniform noise): at Q95 its blocks overflow
    the 8- and 16-word capacity rungs."""
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if color else (h, w)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def entropy_segment(jfif_bytes: bytes) -> bytes:
    """The entropy-coded data of a one-scan JFIF: after the SOS header,
    before EOI (restart markers included)."""
    sos = jfif_bytes.index(b"\xff\xda")
    n = int.from_bytes(jfif_bytes[sos + 2 : sos + 4], "big")
    assert jfif_bytes[-2:] == b"\xff\xd9"
    return jfif_bytes[sos + 2 + n : -2]


def _int_oracle_levels(y: np.ndarray, cfg) -> np.ndarray:
    """dct_dtype="int32" levels recomputed in numpy int64 (the integer
    transform's definition, ops/int_transform)."""
    from jpegtpu import tables

    t8 = np.round(tables.dct_basis_reference(np.float64) * 2048).astype(np.int64)
    x = y.astype(np.int64) - 128
    nbh, nbw = y.shape[0] // 8, y.shape[1] // 8
    blk = x.reshape(nbh, 8, nbw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    y1 = (np.einsum("ux,nxy->nuy", t8, blk) + 1024) >> 11
    f = (np.einsum("nuy,vy->nuv", y1, t8) + 1024) >> 11
    q = cfg.luma_quant.astype(np.int64).reshape(8, 8)
    mag = (2 * np.abs(f) + q) // (2 * q)
    return np.where(f < 0, -mag, mag).reshape(-1, 64)[:, tables.ZIGZAG_ORDER]


def golden_parity(name: str, data: dict) -> dict:
    """Phase 2 for one golden plane. Raises AssertionError on a failure;
    returns what it found (flip count and positions)."""
    import jax
    import jax.numpy as jnp

    from jpegtpu import EncodeConfig, pipeline, tables
    from jpegtpu.entropy import device as entropy_device
    from jpegtpu.entropy import host as entropy_host

    y = data["y"]
    ref_zz = data["zigzag"].astype(np.int32)
    ref_stream = data["stream"].tobytes()

    # the device entropy coder on natural_c's own levels: exact bytes
    buf, n, ovf = jax.jit(
        lambda z: entropy_device.encode_scan_device(z, pad_ones=False)
    )(jnp.asarray(ref_zz))
    assert not bool(ovf), name
    got = bytes(np.asarray(buf)[: int(n)])
    assert got == ref_stream, f"{name}: device coder != natural_c stream"

    out = {"name": name}
    for dt in ("float32", "int32"):
        cfg = EncodeConfig(pad_ones=False, dct_dtype=dt)
        zz = pipeline.grayscale_coefficients(y, cfg)
        seg = entropy_segment(pipeline.encode_grayscale(y, cfg))
        host_seg = entropy_host.encode_scan(zz, pad_ones=False)[0]
        assert seg == host_seg, f"{name} {dt}: device stream != host coder"
        if dt == "int32":
            want = _int_oracle_levels(y, cfg)
            assert np.array_equal(zz, want), f"{name}: int32 != numpy oracle"
            out["int32_vs_natural_c"] = int((zz != ref_zz).sum())
            continue
        flips = np.argwhere(zz != ref_zz)
        out["float32_flips"] = int(len(flips))
        out["flip_at"] = [
            (int(b), int(k), int(zz[b, k]), int(ref_zz[b, k]))
            for b, k in flips[:8]
        ]
        if len(flips) == 0:
            assert seg == ref_stream, f"{name}: stream != natural_c"
            continue
        # every flip must be a +-1 level at an exact 0.5 boundary of the
        # reference's own arithmetic
        assert np.abs(zz - ref_zz).max() == 1, name
        c = y.astype(np.float64) - 128.0
        ph, pw = c.shape
        t = tables.dct_basis_reference(np.float64)
        b = c.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        f = np.einsum("ux,...xy,vy->...uv", t, b, t).reshape(-1, 64)
        q = cfg.luma_quant.reshape(64).astype(np.float64)
        scaled = (f / q)[:, tables.ZIGZAG_ORDER][zz != ref_zz]
        dist = np.abs(np.abs(scaled - np.trunc(scaled)) - 0.5)
        assert dist.max() < 1e-4, f"{name}: non-boundary flip {dist.max()}"
    return out


@dataclasses.dataclass
class Case:
    """One main-path encode: run() -> bytes (or a list of files), and
    ref() -> the same from the numpy host coder."""

    name: str
    mpix: float
    run: object
    ref: object
    post: object = None  # optional extra check after the encode


def timed(fn, reps: int = 3):
    """(first call seconds incl. compile, median steady seconds, out)."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return first, statistics.median(ts), out


def main_path_cases(frame=FRAME, frame_8k=FRAME_8K, batch_n=64,
                    batch_hw=512, tex_hw=2048):
    from jpegtpu import EncodeConfig, batch, color_pipeline, pipeline, serving
    from jpegtpu.parallel import sharding

    gray = photo(*frame, seed=1)
    rgb = photo(*frame, seed=2, color=True)
    mp = frame[0] * frame[1] / 1e6
    host = dict(entropy="host")

    def g(cfg, img=gray):
        return Case("", img.shape[0] * img.shape[1] / 1e6,
                    lambda: pipeline.encode_grayscale(img, cfg),
                    lambda: pipeline.encode_grayscale(
                        img, dataclasses.replace(cfg, **host)))

    def c(cfg, img=rgb):
        return Case("", img.shape[0] * img.shape[1] / 1e6,
                    lambda: color_pipeline.encode_color(img, cfg),
                    lambda: color_pipeline.encode_color(
                        img, dataclasses.replace(cfg, **host)))

    cases = {
        "gray": g(EncodeConfig()),
        "420": c(EncodeConfig(subsampling="420")),
        "422": c(EncodeConfig(subsampling="422")),
        "444": c(EncodeConfig(subsampling="444")),
        # one MCU row per restart segment
        "gray_restart": g(EncodeConfig(restart_interval=frame[1] // 8)),
        "gray_optimize": g(EncodeConfig(optimize_huffman=True)),
        "gray_int32": g(EncodeConfig(dct_dtype="int32")),
    }
    # Q95 noise: overflows rungs 8 and 16, retried at the worst case
    tg = texture(tex_hw, tex_hw, seed=3)
    cases["gray_q95_texture"] = g(EncodeConfig(quality=95), tg)

    def took_worst_case():
        key = (tex_hw, tex_hw, EncodeConfig(quality=95), False)
        rung = pipeline._cap_history.get(key, [0])[0]
        assert rung == 53, f"Q95 texture fit rung {rung}, not the retry"

    cases["gray_q95_texture"].post = took_worst_case

    img8k = photo(*frame_8k, seed=5, color=True)
    cases["8k_420"] = c(EncodeConfig(subsampling="420"), img8k)

    # the sharded entry point on a one-device mesh: shard == restart segment
    seg = sharding.restart_subsegments(frame[0] // 8, frame[1] // 8)
    cases["gray_sharded_1card"] = Case(
        "", mp,
        lambda: sharding.encode_grayscale_sharded(gray, EncodeConfig()),
        lambda: pipeline.encode_grayscale(
            gray, EncodeConfig(restart_interval=seg, **host)),
    )

    imgs = [photo(batch_hw, batch_hw, seed=100 + i) for i in range(batch_n)]
    cases["gray_batch"] = Case(
        "", batch_n * batch_hw * batch_hw / 1e6,
        lambda: batch.encode_grayscale_batch(imgs, EncodeConfig()),
        lambda: [pipeline.encode_grayscale(im, EncodeConfig(**host))
                 for im in imgs],
    )
    simgs = [photo(768, 1024, seed=200 + i) for i in range(8)]
    cases["gray_stream"] = Case(
        "", 8 * 768 * 1024 / 1e6,
        lambda: list(serving.encode_stream(simgs, EncodeConfig())),
        lambda: [pipeline.encode_grayscale(im, EncodeConfig(**host))
                 for im in simgs],
    )
    for k, v in cases.items():
        v.name = k
    return cases


def check_case(case: Case, reps: int) -> dict:
    first, steady, out = timed(case.run, reps)
    want = case.ref()
    assert out == want, f"{case.name}: device bytes != host coder"
    if case.post is not None:
        case.post()
    return {"name": case.name, "mpix": case.mpix, "first_s": first,
            "steady_s": steady}


def check_cli(workdir: str) -> None:
    """The CLI's encode command on a BMP, against the host coder."""
    from jpegtpu import EncodeConfig, cli, pipeline
    from jpegtpu.io import bmp

    rgb = photo(480, 640, seed=7, color=True)
    src = os.path.join(workdir, "in.bmp")
    dst = os.path.join(workdir, "out.jpg")
    bmp.write(src, rgb)
    assert cli.main(["encode", src, dst]) == 0
    with open(dst, "rb") as f:
        got = f.read()
    want = pipeline.encode_grayscale(bmp.read(src), EncodeConfig(entropy="host"))
    assert got == want, "cli: device bytes != host coder"


def memory_report() -> None:
    """compiled.memory_analysis() of the 8K color and the batch programs."""
    import jax.numpy as jnp

    from jpegtpu import EncodeConfig, batch, color_pipeline
    from jpegtpu.entropy import device as entropy_device

    luts = entropy_device.standard_luts()
    cfg = EncodeConfig(subsampling="420")
    ph, pw = FRAME_8K
    fn = color_pipeline._encode_color_device(ph, pw, cfg, 8, stuff=False)
    img = jnp.zeros((3, ph, pw), jnp.uint8)
    print("memory_analysis 8k_420:",
          fn.lower(img, luts).compile().memory_analysis())
    fn = batch._batch_encode_fn(64, 512, 512, EncodeConfig(), False, 8)
    imgs = jnp.zeros((64, 512, 512), jnp.uint8)
    print("memory_analysis gray_batch_64x512:",
          fn.lower(imgs, luts).compile().memory_analysis())


def run_gpu_tests() -> tuple[int, int]:
    """The `gpu`-marked tests, in this process (no xdist). Returns
    (passed, failed)."""
    import pytest

    class Count:
        passed = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1
            elif report.failed:
                Count.failed += 1

    rc = pytest.main(
        ["-o", "addopts=", "-q", "-p", "no:cacheprovider", "-m", "gpu",
         os.path.join(REPO, "tests", "test_gpu_parity.py")],
        plugins=[Count()],
    )
    if rc not in (0, 5) and Count.failed == 0:
        Count.failed = 1  # collection or usage error
    return Count.passed, Count.failed


def run_four() -> None:
    """--four: the 4-card sharded paths and what they are compared with."""
    from jpegtpu import EncodeConfig, batch, color_pipeline, pipeline
    from jpegtpu.parallel import sharding

    mesh = sharding.make_mesh(4)
    h, w = FRAME_8K
    mp = h * w / 1e6
    gray = photo(h, w, seed=11)
    rgb = photo(h, w, seed=12, color=True)

    ph, pw = sharding.shard_padded_dims(h, w, 4)
    seg = sharding.restart_subsegments(ph // 4 // 8, pw // 8)
    f4, s4, got = timed(lambda: sharding.encode_grayscale_sharded(
        gray, EncodeConfig(), mesh=mesh))
    f1, s1, want = timed(lambda: pipeline.encode_grayscale(
        gray, EncodeConfig(restart_interval=seg)))
    assert got == want, "gray sharded != single-card restart encode"
    print(f"four gray_8k_sharded: {mp / s4:.1f} MPix/s on 4 cards vs "
          f"{mp / s1:.1f} single-card (restart {seg}); compile "
          f"{f4 - s4:.1f}s / {f1 - s1:.1f}s; byte-equal")

    cfg = EncodeConfig(subsampling="420")
    band = color_pipeline.mcu_dims("420")[0] * 4
    ph = -(-h // band) * band
    seg = sharding.restart_subsegments(ph // 4 // 16, w // 16)
    # the sharded scan covers the frame edge-padded to whole bands; the
    # single-card encode of that padded frame must give the same scan
    padded = np.pad(rgb, [(0, ph - h), (0, 0), (0, 0)], mode="edge")
    f4, s4, got = timed(lambda: color_pipeline.encode_color_sharded(
        rgb, cfg, mesh=mesh))
    f1, s1, want = timed(lambda: color_pipeline.encode_color(
        padded, dataclasses.replace(cfg, restart_interval=seg)))
    assert entropy_segment(got) == entropy_segment(want), \
        "color sharded scan != single-card restart encode"
    print(f"four 420_8k_sharded: {mp / s4:.1f} MPix/s on 4 cards vs "
          f"{mp / s1:.1f} single-card (restart {seg}); compile "
          f"{f4 - s4:.1f}s / {f1 - s1:.1f}s; scans byte-equal")

    imgs = [photo(512, 512, seed=300 + i) for i in range(64)]
    bmp_ = 64 * 512 * 512 / 1e6
    f4, s4, got = timed(lambda: batch.encode_grayscale_batch(
        imgs, EncodeConfig(), mesh=mesh))
    f1, s1, want = timed(lambda: batch.encode_grayscale_batch(
        imgs, EncodeConfig()))
    assert got == want, "batch over 4 cards != single-card batch"
    print(f"four gray_batch_64x512: {bmp_ / s4:.1f} MPix/s on 4 cards vs "
          f"{bmp_ / s1:.1f} single-card; byte-equal")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-card sharded paths")
    args = p.parse_args(argv)
    # keep the GPU when pytest's conftest loads in this process
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    sys.path.insert(0, REPO)
    from jpegtpu import compile_cache, native

    compile_cache.enable()
    dev = device_check()
    card = card_line()
    print(f"device: {dev['kind']} x{dev['count']}")
    print(f"native stuffer loaded: {native.available()}")
    if args.four:
        if dev["count"] < 4:
            raise RuntimeError(f"--four needs 4 GPUs, found {dev['count']}")
        run_four()
    else:
        for name in GOLDEN:
            data = dict(np.load(os.path.join(REPO, "tests", "golden",
                                             f"{name}.npz")))
            print("golden", json.dumps(golden_parity(name, data)))
        rows = []
        for case in main_path_cases().values():
            rows.append(check_case(case, reps=3))
            r = rows[-1]
            print(f"main {r['name']}: byte-equal to host coder; first call "
                  f"{r['first_s']:.2f}s, steady {r['steady_s'] * 1e3:.1f} ms")
        with tempfile.TemporaryDirectory(dir=REPO) as td:
            check_cli(td)
        print("main cli: byte-equal to host coder")
        memory_report()
        passed, failed = run_gpu_tests()
        print(f"gpu tests: {passed} passed, {failed} failed")
        assert failed == 0 and passed > 0, "gpu-marked tests failed"
        print(f"times on {card} (end to end, host pixels in -> JFIF out; "
              "compile = first call - steady, set-up):")
        for r in rows:
            print(f"  {r['name']:<20} {r['mpix'] / r['steady_s']:10.1f} MPix/s"
                  f"  steady {r['steady_s'] * 1e3:9.1f} ms"
                  f"  compile {max(r['first_s'] - r['steady_s'], 0):6.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
