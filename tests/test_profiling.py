"""Profiling helpers (utils/profiling.py) and the persistent-cache gate."""

import os

import jax
import jax.numpy as jnp

from clonealign_tpu.utils.cache import enable_persistent_cache
from clonealign_tpu.utils.profiling import timed, trace

import pytest

pytestmark = pytest.mark.slow


def test_timed_reports(capsys):
    with timed("probe"):
        (jnp.ones((64, 64)) @ jnp.ones((64, 64))).block_until_ready()
    out = capsys.readouterr().out
    assert out.startswith("probe: ") and out.strip().endswith("s")


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        (jnp.ones((32, 32)) + 1).block_until_ready()
    # a plugins/profile/<run> directory with at least one artifact appears
    found = []
    for root, _dirs, files in os.walk(d):
        found.extend(files)
    assert found, "no trace artifacts written"


def test_persistent_cache_skips_cpu(monkeypatch):
    # suite runs on CPU (conftest) -> gate must skip and set nothing, even
    # with the JAX variable present
    assert jax.default_backend() == "cpu"
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_persistent_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
