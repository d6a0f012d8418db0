"""Test configuration: a virtual 8-device CPU mesh unless told otherwise.

The suite runs on the CPU with eight virtual devices, so the sharded and
batch-over-mesh paths see a real multi-device mesh. When JAX_PLATFORMS
is already set (chip_smoke.py keeps the GPU that way when it runs the
`gpu`-marked tests in its own process), the platform is left as given.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

from jpegtpu import compile_cache

compile_cache.enable()

import pathlib

import numpy as np
import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
CORPUS = ["lena", "blackbuck", "greenland", "offset_sample"]
REF_INPUT = pathlib.Path("/root/reference/assets/input")


@pytest.fixture(scope="session", params=CORPUS)
def golden(request):
    """Per-image golden fixture dict (see tools/golden_gen)."""
    name = request.param
    path = GOLDEN_DIR / f"{name}.npz"
    if not path.exists():
        pytest.skip(f"golden fixture {path} missing")
    data = dict(np.load(path))
    data["name"] = name
    bmp_path = REF_INPUT / f"{name}.bmp"
    data["bmp_path"] = str(bmp_path) if bmp_path.exists() else None
    return data


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided here, at run
    time, never while a module is imported: xdist workers must all
    collect the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")
