"""Persistent XLA compilation cache.

Compiled programs are cached on disk, so repeat runs of the same fit shapes
skip compilation, including across processes. The in-process jit cache
already handles repeat calls within one process (api._fit_program is
module-level for this).
"""

from __future__ import annotations

import os

# The fixed cache location when JAX_COMPILATION_CACHE_DIR is not set: inside
# the checkout (listed in .gitignore), never under a temporary, per-process
# or per-run name, so a later process finds what an earlier one compiled.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str | None:
    """Turn on JAX's on-disk compilation cache on an accelerator backend.
    Returns the cache directory in use, or None where it is skipped.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting: JAX
    reads it and nothing is set here. Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`.

    Skipped on CPU: XLA:CPU executables encode host machine features, and
    reloading an entry compiled on or for a different CPU can SIGILL.
    """
    import jax

    if jax.default_backend() == "cpu":
        return None
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
