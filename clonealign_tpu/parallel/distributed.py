"""Multi-host (multi-process) execution helpers.

A clonealign fit across several hosts follows the standard JAX multi-controller
recipe: every host runs the same program, holds a shard of the cells, and
the GSPMD-sharded fit (sharding.py) executes collectively. These helpers
wrap the three steps; on a single host they degenerate gracefully, so the
same script runs anywhere.

Typical multi-host driver::

    from clonealign_tpu.parallel import distributed as dist
    dist.initialize()                      # no-op on single host
    mesh = make_mesh()                     # global mesh over all hosts' devices
    Y_global = dist.host_local_to_global(Y_local_shard, mesh, axis="cells")
    ...
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .sharding import CELL_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize JAX distributed (multi-controller) mode.

    Returns True if a multi-process runtime was initialized, False when
    running single-process (the helpers then degenerate to local behavior).
    Arguments default to the JAX_* environment variables / cluster
    auto-detection, like ``jax.distributed.initialize`` itself.
    """
    if jax.process_count() > 1:
        return True  # already initialized
    if coordinator_address is None and num_processes is None:
        # single-host usage: nothing to do
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def host_local_to_global(local_array, mesh, spec: Optional[P] = None):
    """Assemble a globally-sharded array from per-host local shards.

    Each host passes its own rows (cells) of the count matrix; the result is
    one global jax.Array sharded over the mesh — exactly what
    :func:`~clonealign_tpu.parallel.sharding.shard_data` style fits consume.
    On a single host this is just a device_put with the mesh sharding.
    """
    local_array = np.asarray(local_array)
    if spec is None:
        spec = P(CELL_AXIS, *([None] * (local_array.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(local_array, sharding)
    return jax.make_array_from_process_local_data(sharding, local_array)


def process_cell_slice(n_cells_global: int) -> slice:
    """The half-open row range of the global cell axis owned by this process
    (equal contiguous blocks; the last process takes the remainder)."""
    p = jax.process_index()
    n = jax.process_count()
    per = n_cells_global // n
    start = p * per
    stop = n_cells_global if p == n - 1 else start + per
    return slice(start, stop)


def distributed_fit(
    Y_local,
    L,
    mesh=None,
    *,
    x_local=None,
    **fit_kwargs,
):
    """Complete multi-restart clonealign fit from per-process cell shards.

    The multi-host driver in one call: every process passes only ITS rows of
    the count matrix (``process_cell_slice`` of the global cell axis, in
    process order), the global sharded array is assembled with
    :func:`host_local_to_global`, and the standard GSPMD sweep
    (:func:`~clonealign_tpu.parallel.sharding.sharded_fit`) executes
    collectively — identical program, identical numerics to the
    single-controller fit on the same global data and keys (the per-process
    split only changes which host feeds which shard). On a single process it
    degenerates to ``sharded_fit`` on the full matrix.

    ``mesh`` defaults to all global devices on the cells axis (the natural
    multi-host layout: the process boundary is a cells-axis boundary). A
    2-D (cells, genes) mesh also works when each process's device block
    spans whole cell rows — i.e. the genes axis is intra-process — which is
    how :func:`~clonealign_tpu.parallel.sharding.make_mesh` lays out
    process-contiguous device lists.

    Accepts the same keyword surface as ``sharded_fit`` (``n_restarts``,
    ``config``, ``dtype``, ``y_storage``, ``max_iter`` ...). Returns the
    stacked :class:`~clonealign_tpu.infer.InferenceResult`; per-cell outputs
    (``gamma_logits``, ``psi``) come back sharded over cells — each process
    addresses its own rows, or replicate explicitly for a global view.
    """
    from .sharding import GENE_AXIS, make_mesh, sharded_fit

    if mesh is None:
        mesh = make_mesh()
    Y_local = np.asarray(Y_local)
    Y_global = host_local_to_global(Y_local, mesh, P(CELL_AXIS, GENE_AXIS))
    x = None
    if x_local is not None:
        x = host_local_to_global(np.asarray(x_local), mesh)
    return sharded_fit(Y_global, np.asarray(L), mesh, x=x, **fit_kwargs)
