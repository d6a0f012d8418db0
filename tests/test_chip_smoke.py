"""chip_smoke.py's device-independent parts, on the CPU: the device
check refuses a CPU-only process, and the golden phase's checks hold on
XLA:CPU (the card must then reproduce them). Also the compile-cache
directory rule every entry point shares."""
import os
import sys

import pytest

from jpegtpu import compile_cache

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def test_device_check_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.device_check()


def test_golden_phase_holds_on_cpu(golden):
    found = chip_smoke.golden_parity(golden["name"], golden)
    assert found["float32_flips"] < 1e-4 * golden["zigzag"].size


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    import jax

    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable() == str(tmp_path)
        # the variable is JAX's own: nothing else is set in code
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.enable()
        assert path == compile_cache.CHECKOUT_DIR
        assert os.path.basename(path) == ".jax_cache"
        assert os.path.dirname(path) == os.path.dirname(
            os.path.dirname(os.path.abspath(compile_cache.__file__)))
        assert jax.config.jax_compilation_cache_dir == path
