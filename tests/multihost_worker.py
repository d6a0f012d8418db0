"""Worker for the 2-process multi-host test (tests/test_multihost_2proc.py).

Each process owns 4 virtual CPU devices; the 8-device global mesh spans
both. Run: python multihost_worker.py <port> <process_id> <out_prefix>.
"""
import os
import sys

port, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from jpegtpu import compile_cache  # noqa: E402

compile_cache.enable()

from jpegtpu.config import EncodeConfig  # noqa: E402
from jpegtpu.parallel import multihost, sharding  # noqa: E402

# The handshake MUST precede any backend use (ADVICE round-1 fix).
multihost.initialize(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.local_devices()) == 4
# initialize() is idempotent after the handshake
multihost.initialize(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)

mesh = multihost.global_mesh()
assert mesh.devices.size == 8

img = (np.arange(128 * 64, dtype=np.int64).reshape(128, 64) * 7 % 256).astype(
    np.uint8
)
gray = sharding.encode_grayscale_sharded(img, EncodeConfig(), mesh=mesh)

# 2-pass optimal sharded encode across BOTH processes: psum'd global
# histograms over the mesh -> every host derives identical tables, so
# the assembled streams must match host-for-host like the standard ones
gray_opt = sharding.encode_grayscale_sharded(
    img, EncodeConfig(optimize_huffman=True), mesh=mesh
)

from jpegtpu import color_pipeline  # noqa: E402

cimg = np.stack([img, img[::-1], img[:, ::-1]], axis=-1)
color = color_pipeline.encode_color_sharded(
    cimg, EncodeConfig(subsampling="420"), mesh=mesh
)

# EVERY host holds the complete assembled stream; the coordinator is the
# one that persists it (both write here so the test can diff them).
with open(f"{out}.gray.p{pid}", "wb") as f:
    f.write(gray)
with open(f"{out}.grayopt.p{pid}", "wb") as f:
    f.write(gray_opt)
with open(f"{out}.color.p{pid}", "wb") as f:
    f.write(color)
print("WORKER_OK", pid)
