"""Multi-host orchestration over jax.distributed.

The single-controller mesh mechanics of `parallel.sharding` extend to
multiple hosts unchanged: initialize the distributed runtime, build a
global mesh over every device of every host, and run the same
shard_map'd encode — XLA routes the per-shard all_gather between the
devices of a host and across hosts (SURVEY.md §5.8).

The tests exercise these helpers with two processes of virtual CPU
devices (tests/test_multihost_2proc.py); on a multi-host cluster they
are the entry point.

Usage (same program on every host):

    from jpegtpu.parallel import multihost
    multihost.initialize()                      # jax.distributed handshake
    mesh = multihost.global_mesh()              # all chips, 1-D 'shard' axis
    data = encode_grayscale_sharded(img, cfg, mesh=mesh)  # identical API
    if multihost.is_coordinator():
        open(out, 'wb').write(data)
"""
from __future__ import annotations

import jax


def initialize(**kwargs) -> None:
    """jax.distributed.initialize with env-driven defaults. Must run
    before any JAX backend initializes (calling jax.process_count() here
    would itself initialize the local backend and defeat the handshake),
    so idempotence is gated on the distributed client state, not on
    process_count. No-op on a single host with no coordinator configured.
    """
    import os

    try:  # the state object moved between jax versions
        from jax._src.distributed import global_state as _gs
    except ImportError:  # pragma: no cover
        _gs = getattr(jax.distributed, "global_state", None)
    if _gs is not None and _gs.client is not None:
        return  # already initialized
    if (
        kwargs
        or "JAX_COORDINATOR_ADDRESS" in os.environ
        or os.environ.get("COORDINATOR_ADDRESS")
    ):
        try:
            jax.distributed.initialize(**kwargs)
        except RuntimeError:
            # Last-resort idempotence: if BOTH state imports above failed
            # on a future jax version, a second call lands here instead
            # of crashing the caller ("already initialized" raises
            # RuntimeError from jax.distributed.initialize).
            if _gs is not None:
                raise


def global_mesh(axis: str = "shard"):
    """1-D mesh over every device in the job (all hosts)."""
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def is_coordinator() -> bool:
    return jax.process_index() == 0


def local_shard_indices(mesh) -> list[int]:
    """Mesh positions owned by this host — the shards whose bytes this
    host will contribute when assembling the final stream."""
    local = set(jax.local_devices())
    return [i for i, d in enumerate(mesh.devices.flat) if d in local]
