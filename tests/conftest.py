"""Test configuration: force an 8-device virtual CPU mesh before JAX use.

Mirrors SURVEY.md §4's "multi-node without a real cluster" strategy — sharding
logic is exercised on host-platform virtual devices so the suite runs anywhere.

GPU profile: ``CLONEALIGN_GPU_TESTS=1 pytest -m gpu`` skips the CPU forcing
(and x64: the device path is float32) so the ``gpu``-marked tests in
tests/test_gpu_hardware.py run against the card. Everything else should be
deselected in that mode (the CPU suite's float64 oracles assume x64). Each
``gpu`` test decides inside a fixture whether a card is present, so the CPU
suite collects the same tests in every worker and skips them there.
"""

import os

_GPU_MODE = os.environ.get("CLONEALIGN_GPU_TESTS") == "1"

if not _GPU_MODE:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    # Enable x64 so float64 oracle comparisons are exact; the production
    # device path remains float32.
    os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

if not _GPU_MODE:
    jax.config.update("jax_enable_x64", True)


if not _GPU_MODE:
    import gc

    import pytest

    @pytest.fixture(autouse=True, scope="module")
    def _clear_jax_caches_between_modules():
        """Release compiled executables after each test module.

        The suite jits ~270 distinct programs; accumulated XLA:CPU compile
        state reproducibly segfaulted a single-process `pytest tests/` run
        inside `backend_compile_and_load` after ~254 tests (every module
        green in isolation, one-process run dead). Dropping the jit/pjit
        caches at module boundaries frees the loaded executables and their
        JIT code pages; cross-module program reuse is rare (different
        shapes), so the recompile cost is small next to the crash it
        prevents.
        """
        yield
        jax.clear_caches()
        gc.collect()
else:
    from clonealign_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
