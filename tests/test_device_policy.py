"""Choices the code makes from the device it runs on: the compilation-cache
location, how chunked Y is assembled, and the restart vmap/map budget.

A device is faked where the choice differs off the CPU, so every branch runs
in the CPU suite."""

import os

import jax
import pytest

from clonealign_tpu.models.multinomial import _assembly_strategy
from clonealign_tpu.restarts import (
    _CPU_LANE_ELEMENTS,
    _LANE_ELEMENTS_PER_BYTE,
    _auto_restart_batching,
    _lane_element_budget,
)
from clonealign_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeDevice:
    def __init__(self, platform, stats=None, kind="fake"):
        self.platform = platform
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.fixture
def on_gpu(monkeypatch):
    """Make the cache gate see a GPU backend and restore the global cache
    directory afterwards."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_honours_jax_variable(on_gpu, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_persistent_cache() == str(tmp_path)
    # left to JAX: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_uses_fixed_checkout_path(on_gpu, monkeypatch, tmp_path):
    assert cache.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    fixed = str(tmp_path / "fixed")
    monkeypatch.setattr(cache, "DEFAULT_CACHE_DIR", fixed)
    assert cache.enable_persistent_cache() == fixed
    assert cache.enable_persistent_cache() == fixed  # same path every call
    assert jax.config.jax_compilation_cache_dir == fixed
    assert os.path.isdir(fixed)


def test_cache_skipped_on_cpu(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_persistent_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_assembly_fills_on_cpu_and_donates_on_gpu():
    assert _assembly_strategy() == "fill"
    assert _assembly_strategy(FakeDevice("cpu")) == "fill"
    assert _assembly_strategy(FakeDevice("gpu")) == "donate"


def test_restart_budget_scales_with_bytes_limit():
    small = FakeDevice("gpu", {"bytes_limit": 16 * 2**30})
    large = FakeDevice("gpu", {"bytes_limit": 64 * 2**30})
    assert _lane_element_budget(small) == pytest.approx(6e9)
    assert _lane_element_budget(large) == pytest.approx(
        64 * 2**30 * _LANE_ELEMENTS_PER_BYTE
    )
    # 9 lanes at 1M x 2k: map on the small device, vmap on the large one
    n_elems, lanes = 1_000_000 * 2_000, 9
    assert _auto_restart_batching(n_elems, lanes, 1, 4, device=small) == "map"
    assert _auto_restart_batching(n_elems, lanes, 1, 4, device=large) == "vmap"
    # float64 compute halves the budget
    assert _auto_restart_batching(n_elems, lanes, 1, 8, device=large) == "map"


def test_restart_budget_cpu_constant():
    assert _lane_element_budget(FakeDevice("cpu")) == _CPU_LANE_ELEMENTS


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 0}])
def test_restart_budget_gpu_without_limit_raises(stats):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        _auto_restart_batching(10, 1, 1, 4, device=FakeDevice("gpu", stats))
