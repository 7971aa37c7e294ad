"""Profiling hooks (SURVEY.md §5: the reference has none; the ELBO trace in
``convergence_info`` plus these helpers are the observability surface)."""

from __future__ import annotations

import contextlib
import subprocess
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a JAX/XLA device trace viewable in TensorBoard/Perfetto.

    >>> with trace("/tmp/clonealign-trace"):
    ...     fit = clonealign(Y, L)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str = "", sink=print):
    """Wall-clock a block, blocking on async dispatch at exit."""
    import jax

    t0 = time.perf_counter()
    try:
        yield
    finally:
        # flush any in-flight device work before reading the clock
        (jax.effects_barrier if hasattr(jax, "effects_barrier") else lambda: None)()
        sink(f"{label or 'block'}: {time.perf_counter() - t0:.3f}s")


def device_label() -> str:
    """What a measurement ran on: JAX's platform, device kind and count,
    e.g. ``"gpu NVIDIA H100 80GB HBM3 x1"``."""
    import jax

    devs = jax.devices()
    return f"{devs[0].platform} {devs[0].device_kind} x{len(devs)}"


def gpu_name_and_power_limit() -> list[str]:
    """Each card's name and power limit as ``nvidia-smi`` reports them, from
    a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]
