"""Device-mesh parallelism for clonealign fits.

The reference is a single R process driving one TF session (SURVEY.md §2.2,
"Parallelism strategies: none"). The distributed surface maps the
model's structure onto a 2-D mesh:

* ``cells`` axis (data parallel): every per-cell tensor — Y rows, size
  factors, responsibilities gamma, latent factors psi — shards over it. The
  ELBO and gradients are sums over cells, so XLA inserts all-reduces over
  the device interconnect (NVLink between the GPUs of one host).
* ``genes`` axis (model/tensor parallel): per-gene tensors — Y columns, L,
  qmu loc/scale, W, beta — shard over it. The likelihood contractions
  (Y @ W, Y @ log mu, the Z normalizer) contract over genes, so XLA inserts
  the cross-shard reductions before the per-(clone, cell) normalization, as
  required (SURVEY.md §7, "the normalizer coupling").

Restarts stay vmapped (leading axis, unsharded): each device computes all
restart lanes on its (cells, genes) tile, which keeps the collectives
identical to the single-fit case.

Everything uses GSPMD via NamedSharding annotations; no hand-written
collectives. Scale-out is annotate-and-jit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import multinomial as mm

CELL_AXIS = "cells"
GENE_AXIS = "genes"


def make_mesh(
    devices: Optional[Sequence] = None,
    cell_parallelism: Optional[int] = None,
    gene_parallelism: int = 1,
) -> Mesh:
    """Build a (cells, genes) mesh. Defaults to all devices on the cell axis —
    cells are the unbounded dimension in practice (100k+) while genes are
    bounded (~5k), so data parallelism is the default scale-out direction."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if cell_parallelism is None:
        cell_parallelism = n // gene_parallelism
    if cell_parallelism * gene_parallelism != n:
        raise ValueError(
            f"mesh {cell_parallelism}x{gene_parallelism} != {n} devices"
        )
    dev_array = np.asarray(devices).reshape(cell_parallelism, gene_parallelism)
    return Mesh(dev_array, (CELL_AXIS, GENE_AXIS))


def data_shardings(
    mesh: Mesh, has_x: bool, has_colsum: bool = True
) -> mm.ModelData:
    """PartitionSpecs for the ModelData pytree (see module docstring).

    ``None`` fields in ModelData are empty pytree subtrees, so the sharding
    pytree must mirror their absence (``has_x`` / ``has_colsum``) or
    ``jax.tree.map`` over (data, shardings) raises a structure mismatch.
    """
    return mm.ModelData(
        Y=NamedSharding(mesh, P(CELL_AXIS, GENE_AXIS)),
        L=NamedSharding(mesh, P(GENE_AXIS, None)),
        X=NamedSharding(mesh, P(CELL_AXIS, None)) if has_x else None,
        s=NamedSharding(mesh, P(CELL_AXIS)),
        log_binom=NamedSharding(mesh, P(CELL_AXIS)),
        YlogL=NamedSharding(mesh, P(CELL_AXIS, None)),
        colsum_Y=NamedSharding(mesh, P(GENE_AXIS)) if has_colsum else None,
    )


def param_specs(batched: bool = False) -> mm.CloneAlignParams:
    """PartitionSpecs for params; ``batched`` adds a leading (replicated)
    restart axis."""
    lead = (None,) if batched else ()

    def spec(*axes):
        return P(*(lead + axes))

    return mm.CloneAlignParams(
        W=spec(GENE_AXIS, None),
        chi_unconstr=spec(None),
        psi=spec(CELL_AXIS, None),
        beta=spec(GENE_AXIS, None),
        alpha_unconstr=spec(None),
        qmu_loc=spec(GENE_AXIS),
        qmu_log_scale=spec(GENE_AXIS),
        gamma_logits=spec(CELL_AXIS, None),
    )


def param_shardings(mesh: Mesh, batched: bool = False) -> mm.CloneAlignParams:
    """NamedShardings for the parameter pytree (``batched`` adds a leading
    replicated restart axis); see :func:`param_specs`."""
    return jax.tree.map(
        lambda s: NamedSharding(mesh, s),
        param_specs(batched),
        is_leaf=lambda x: isinstance(x, P),
    )


def shard_data(data: mm.ModelData, mesh: Mesh) -> mm.ModelData:
    """Place a ModelData pytree onto the mesh with the canonical shardings."""
    shardings = data_shardings(
        mesh, has_x=data.X is not None, has_colsum=data.colsum_Y is not None
    )
    return jax.tree.map(jax.device_put, data, shardings)


def shard_extra_log_lik(extra_log_lik, mesh: Mesh):
    """Place the (N, C) allele-specific log-likelihood term
    (models/allele.py, reference R/inference-tflow.R:302-304) on the cells
    axis. It is per-cell data like Y's rows — left unannotated GSPMD would
    replicate it on every device, which wastes memory and interconnect
    bandwidth at scale."""
    if extra_log_lik is None:
        return None
    return jax.device_put(extra_log_lik, NamedSharding(mesh, P(CELL_AXIS, None)))


def constrain_params(params: mm.CloneAlignParams, mesh: Mesh, batched: bool = False):
    shardings = param_shardings(mesh, batched)
    return jax.tree.map(jax.lax.with_sharding_constraint, params, shardings)


def negbin_data_shardings(mesh: Mesh):
    """PartitionSpecs for the legacy v1 family's NegbinData pytree
    (models/negbin.py). Same layout logic as the v2 model: Y tiles over
    (cells, genes); per-gene vectors (Lp rows, l_hat) over genes; per-cell
    size factors over cells. The EM's accumulators contract Y over genes
    (gamma/A) and over cells (r/B), so GSPMD inserts psums on both axes."""
    from ..models import negbin as nb

    return nb.NegbinData(
        Y=NamedSharding(mesh, P(CELL_AXIS, GENE_AXIS)),
        Lp=NamedSharding(mesh, P(GENE_AXIS, None)),
        s=NamedSharding(mesh, P(CELL_AXIS)),
        l_hat=NamedSharding(mesh, P(GENE_AXIS)),
    )


def sharded_negbin_fit(
    Y,
    L,
    mesh: Mesh,
    rho_init=None,
    s=None,
    dtype=jnp.float32,
    **em_kwargs,
):
    """Legacy v1 negative-binomial VEM fit on a device mesh: the count
    matrix tiles over (cells, genes) and the whole EM
    (:func:`~clonealign_tpu.models.negbin.run_negbin_em`) runs as one
    jitted GSPMD program — gamma shards over cells, r over genes, rates
    replicated. Returns the same :class:`NegbinResult` as the
    single-device fit (numerically equivalent; tests/test_sharding.py)."""
    from ..models import negbin as nb

    data = nb.prepare_negbin_data(Y, L, s=s, dtype=dtype)
    data = jax.tree.map(jax.device_put, data, negbin_data_shardings(mesh))
    return nb.run_negbin_em(data, rho_init, **em_kwargs)


def sharded_fit(
    Y,
    L,
    mesh: Mesh,
    n_restarts: int = 1,
    initial_shrinks=None,
    x=None,
    key=None,
    dtype=jnp.float32,
    config: Optional[mm.ModelConfig] = None,
    data_init_mu=True,
    extra_log_lik=None,
    y_storage=None,
    **infer_kwargs,
):
    """Multi-restart fit on a device mesh: data sharded (cells x genes),
    restarts vmapped, one jitted program. Returns the stacked
    :class:`~clonealign_tpu.infer.InferenceResult` over restarts.

    ``y_storage`` matches :func:`~clonealign_tpu.api.clonealign`'s option
    (a jnp dtype here, e.g. ``jnp.int8`` — exact for integer counts).
    """
    from ..restarts import _sweep_program

    if key is None:
        key = jax.random.PRNGKey(0)
    config = config or mm.ModelConfig(K=1, P=0 if x is None else x.shape[1])

    from ..utils.sparsity import is_scipy_sparse

    # jax.Arrays pass through untouched: a multi-process (multi-controller)
    # caller hands in a GLOBAL array assembled by
    # distributed.host_local_to_global, which is not host-materializable
    # (np.asarray on a non-fully-addressable array raises).
    Y_in = Y if (is_scipy_sparse(Y) or isinstance(Y, jax.Array)) else np.asarray(Y)
    data = mm.prepare_data(Y_in, np.asarray(L), x=x, dtype=dtype, y_storage=y_storage)
    data = shard_data(data, mesh)
    extra_log_lik = shard_extra_log_lik(extra_log_lik, mesh)

    if initial_shrinks is None:
        shrinks = jnp.full((n_restarts,), 5.0, dtype)
    else:
        shrinks = jnp.asarray(initial_shrinks, dtype)
        n_restarts = shrinks.shape[0]
    keys = jax.random.split(key, n_restarts)

    # delegate to the shared module-level sweep program (compiled once per
    # shape; shardings propagate from the mesh-placed data arguments)
    mu_init = None
    if not isinstance(data_init_mu, bool):
        mu_init = jnp.asarray(data_init_mu, dtype)
    return _sweep_program(
        keys,
        shrinks,
        data,
        extra_log_lik,
        mu_init,
        config=config,
        data_init_mu=data_init_mu if isinstance(data_init_mu, bool) else "array",
        jdtype_name=str(jnp.dtype(dtype)),
        max_iter=int(infer_kwargs.pop("max_iter", 200)),
        rel_tol=float(infer_kwargs.pop("rel_tol", 1e-6)),
        learning_rate=float(infer_kwargs.pop("learning_rate", 0.1)),
        elbo_eval=infer_kwargs.pop("elbo_eval", "fresh"),
        restart_batching="vmap",
        **infer_kwargs,
    )
