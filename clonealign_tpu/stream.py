"""Out-of-HBM streaming fit: full-batch clonealign where only Y streams.

The reference holds the whole N x G count matrix in one TF session
(reference R/inference-tflow.R:190,401 feeds it per step); the in-core path
here keeps it device-resident (api.py). Both cap N x G at device memory.
This driver removes that cap for the one tensor that is actually large:

* **Y streams** through the device one cell-chunk per step, straight from
  the host array (dense ndarray, ``np.memmap``, or scipy sparse — chunks are
  materialized lazily, so a memmap input is genuinely out-of-core).
* **Everything else stays device-resident**: the per-cell variational state
  (psi, gamma_logits) and its Adam moments are O(N x (K + C)) — ~26 bytes
  per cell at C=10, K=1 — plus the per-cell statistics (s, log_binom,
  Y log L). A 10M-cell fit needs ~1.3 GB of resident state while its 20 GB
  count matrix never exists on the device.

The math is EXACTLY the in-core full-batch algorithm, not an approximation:

* the ELBO separates into per-cell terms and global terms
  (:func:`~clonealign_tpu.models.multinomial.elbo_cell_terms` /
  :func:`~clonealign_tpu.models.multinomial.elbo_global_terms`); each step
  evaluates the per-cell part chunk by chunk with the SAME (S, G)
  reparametrization draw and sums,
* Adam is elementwise, so applying the per-cell update chunk-locally with
  the global step count is identical to the monolithic update, and
* the PRNG key discipline mirrors ``api._fit_program`` /
  ``infer.run_inference`` split for split, so a streaming fit with the same
  ``key`` matches the in-core fit up to floating-point reduction order
  across chunk boundaries (asserted to ~1e-9 in float64 by
  tests/test_stream.py, with identical clone assignments).

Differences from the in-core path, by design:

* ``elbo_eval`` defaults to ``"reuse"`` (one pass over Y per step);
  ``"fresh"`` — the reference's exact monitoring stream — costs a second
  full pass per step.
* ``likelihood_impl="z_cheb"`` fits its Chebyshev range per chunk rather
  than globally (stop-gradiented either way; the per-chunk range is a
  subset, so the approximation is at least as tight).
* The convergence window is accumulated in host float64 rather than the
  compute dtype; a float32 fit sitting exactly at the rel_tol boundary can
  stop one iteration earlier/later than in-core.

Throughput model: each step moves Y once over the host-device link, so the
streaming fit runs at ``link_bandwidth / bytes(Y)`` steps/s when the chunk
compute is overlapped — PCIe-bound, not HBM-bound. It is the right tool
only when Y does not fit in HBM (use the in-core path, narrow ``y_storage``,
or a multi-device mesh first). No streaming throughput has been measured
yet; correctness is CPU-verified and the design is transfer-bound by
construction.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from . import assign as _assign
from .api import (
    _auto_y_storage,
    _colsum_f64,
    _parse_copy_number,
    _parse_expression,
    _resolve_auto_impl,
    _setup_allele,
    _validate_counts,
)
from .utils.sparsity import is_scipy_sparse as _is_scipy_sparse
from .fit import ClonealignFit, ConvergenceInfo
from .infer import tf1_adam
from .models import multinomial as mm


class _Shared(NamedTuple):
    """The cell-count-independent free variables (one copy per fit)."""

    W: jax.Array
    chi_unconstr: jax.Array
    beta: jax.Array
    alpha_unconstr: jax.Array
    qmu_loc: jax.Array
    qmu_log_scale: jax.Array


class _Cell(NamedTuple):
    """Per-cell free variables for one chunk of cells."""

    psi: jax.Array           # (B, K)
    gamma_logits: jax.Array  # (B, C)


class _CellState(NamedTuple):
    cell: _Cell
    opt: optax.ScaleByAdamState


class _ChunkStatic(NamedTuple):
    """Per-chunk constants, device-resident across the whole fit."""

    X: Optional[jax.Array]        # (B, P) or None
    s: jax.Array                  # (B,)
    log_binom: jax.Array          # (B,)
    YlogL: jax.Array              # (B, C)
    extra: Optional[jax.Array]    # (B, C) allele log-lik or None


def _combine(shared: _Shared, cell: _Cell) -> mm.CloneAlignParams:
    return mm.CloneAlignParams(
        W=shared.W,
        chi_unconstr=shared.chi_unconstr,
        psi=cell.psi,
        beta=shared.beta,
        alpha_unconstr=shared.alpha_unconstr,
        qmu_loc=shared.qmu_loc,
        qmu_log_scale=shared.qmu_log_scale,
        gamma_logits=cell.gamma_logits,
    )


def _empty_cell(shared: _Shared) -> _Cell:
    dt = shared.qmu_loc.dtype
    K = shared.W.shape[1]
    C = shared.alpha_unconstr.shape[0]
    return _Cell(jnp.zeros((0, K), dt), jnp.zeros((0, C), dt))


def _chunk_data(y, L, st: _ChunkStatic) -> mm.ModelData:
    return mm.ModelData(
        Y=y, L=L, X=st.X, s=st.s, log_binom=st.log_binom,
        YlogL=st.YlogL, colsum_Y=None,
    )


# --------------------------------------------------------------------------
# Jitted kernels (module-level: repeat fits on same-shaped chunks reuse the
# compiled programs; data always passed as arguments, never closed over)
# --------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("config", "lr"), donate_argnums=(1,)
)
def _chunk_train(shared, state: _CellState, y, L, st, k_train, *, config, lr):
    """One Adam step for one chunk's per-cell params: returns this chunk's
    pre-update ELBO contribution, the shared-param gradient contribution
    (of -elbo), and the updated cell state. The per-cell update with the
    global step count equals the monolithic update (Adam is elementwise)."""

    def loss(sh, ce):
        params = _combine(sh, ce)
        mu_base = mm.sample_mu_base(params, k_train, config.mc_samples)
        return -mm.elbo_cell_terms(
            params, _chunk_data(y, L, st), mu_base, config, st.extra
        )

    (neg, (g_sh, g_ce)) = jax.value_and_grad(loss, argnums=(0, 1))(
        shared, state.cell
    )
    updates, opt_state = tf1_adam(lr).update(g_ce, state.opt)
    cell = optax.apply_updates(state.cell, updates)
    return -neg, g_sh, _CellState(cell, opt_state)


@functools.partial(jax.jit, static_argnames=("config",))
def _chunk_eval(shared, cell: _Cell, y, L, st, keys, *, config):
    """This chunk's ELBO contribution for each key in ``keys`` (m,)."""
    params = _combine(shared, cell)
    data = _chunk_data(y, L, st)

    def one(k):
        mu_base = mm.sample_mu_base(params, k, config.mc_samples)
        return mm.elbo_cell_terms(params, data, mu_base, config, st.extra)

    return jax.vmap(one)(keys)


@functools.partial(jax.jit, static_argnames=("config", "shrink"))
def _chunk_warm(shared, cell: _Cell, y, L, st, k_warm, *, config, shrink):
    """Likelihood-based gamma warm start for one chunk (per-cell op; the
    (S, G) mu draw depends only on ``k_warm``, so chunks agree with the
    monolithic warm start row for row)."""
    params = _combine(shared, cell)
    return mm.gamma_warm_start_logits(
        params, _chunk_data(y, L, st), k_warm, config, shrink, st.extra
    )


@functools.partial(jax.jit, static_argnames=("config",))
def _global_value_grad(shared, k, colsum, *, config):
    def loss(sh):
        params = _combine(sh, _empty_cell(sh))
        mu_base = mm.sample_mu_base(params, k, config.mc_samples)
        return -mm.elbo_global_terms(params, mu_base, config, colsum)

    neg, g = jax.value_and_grad(loss)(shared)
    return -neg, g


@functools.partial(jax.jit, static_argnames=("config",))
def _global_eval(shared, keys, colsum, *, config):
    params = _combine(shared, _empty_cell(shared))

    def one(k):
        mu_base = mm.sample_mu_base(params, k, config.mc_samples)
        return mm.elbo_global_terms(params, mu_base, config, colsum)

    return jax.vmap(one)(keys)


@functools.partial(jax.jit, static_argnames=("lr",), donate_argnums=(0, 1))
def _shared_update(shared, opt_state, g_total, *, lr):
    updates, opt_state = tf1_adam(lr).update(g_total, opt_state)
    return optax.apply_updates(shared, updates), opt_state


@jax.jit
def _tree_add(a, b):
    return jax.tree.map(jnp.add, a, b)


# --------------------------------------------------------------------------
# Host-side row source (lazy column filter; memmap/sparse friendly)
# --------------------------------------------------------------------------

class _RowSource:
    """Row-sliceable view of the gene-filtered count matrix.

    Materializes ``Y[i:j][:, keep]`` on demand so a memmap or scipy-sparse
    input is never copied whole; duck-types the (shape, dtype, ``[i:j]``)
    protocol that the blocked PCA / mu-guess / validation passes use."""

    def __init__(self, Y, keep_cols):
        self._Y = Y
        self._sparse = _is_scipy_sparse(Y)
        if self._sparse:
            Y = Y.tocsr()
            self._Y = Y
        self._keep = None if keep_cols is None or keep_cols.all() else keep_cols
        G = Y.shape[1] if self._keep is None else int(self._keep.sum())
        self.shape = (Y.shape[0], G)
        self.dtype = Y.dtype

    def __getitem__(self, sl) -> np.ndarray:
        blk = self._Y[sl]
        if self._sparse:
            blk = blk.toarray()
        else:
            blk = np.asarray(blk)
        if self._keep is not None:
            blk = blk[:, self._keep]
        return blk


def _chunk_bounds(N: int, chunk: int):
    return [(i, min(i + chunk, N)) for i in range(0, N, chunk)]


def _resolve_chunk_cells(chunk_cells, N: int, G: int) -> int:
    if chunk_cells is None or chunk_cells == "auto":
        # ~256 MB of compute-dtype chunk working set
        chunk = max(1024, (1 << 26) // max(G, 1))
    else:
        chunk = int(chunk_cells)
    if chunk <= 0:
        raise ValueError(f"chunk_cells must be positive, got {chunk_cells!r}")
    return min(chunk, N)


# --------------------------------------------------------------------------
# The driver
# --------------------------------------------------------------------------

def fit_streaming(
    gene_expression_data,
    copy_number_data,
    chunk_cells=None,
    max_iter: int = 200,
    rel_tol: float = 1e-6,
    gene_filter_threshold: float = 0,
    learning_rate: float = 0.1,
    x=None,
    clone_allele=None,
    cov=None,
    ref=None,
    fix_alpha: bool = False,
    dtype: str = "float32",
    saturate: bool = True,
    saturation_threshold: float = 6,
    K: Optional[int] = None,
    mc_samples: int = 1,
    verbose: bool = True,
    initial_shrink: float = 5,
    clone_call_probability: float = 0.95,
    data_init_mu=True,
    seed: Optional[int] = None,
    key=None,
    elbo_eval: str = "reuse",
    y_storage: Optional[str] = "auto",
    likelihood_impl: str = "auto",
    window_size: int = 10,
    n_final_elbo_samples: int = 20,
    mesh=None,
    allow_fractional: bool = False,
) -> ClonealignFit:
    """:func:`~clonealign_tpu.clonealign` for count matrices larger than
    device memory — same model, same optimizer, same parameter surface
    (reference R/clonealign.R:184-203), with Y streamed through the device
    one ``chunk_cells``-row chunk per step (module docstring).

    ``gene_expression_data`` may be a dense ndarray, an ``np.memmap`` (for
    counts larger than host RAM), or a scipy sparse matrix. ``y_storage``
    defaults to ``"auto"`` (narrowest exact integer dtype) because the
    streamed bytes are the bottleneck here, not a cache.

    ``mesh`` (a ``jax.sharding.Mesh`` from
    :func:`~clonealign_tpu.parallel.sharding.make_mesh`) composes streaming
    with device parallelism: each streamed chunk tiles over
    (cells x genes), the resident per-cell state shards over cells, and the
    per-gene parameters shard over genes — so the out-of-HBM path scales
    past ONE device's memory to the mesh's aggregate. Decision rule
    (docs/scaling.md): mesh first (Y ≤ aggregate HBM: in-core ``sharded_fit``
    is HBM-bound, streaming is link-bound), stream only past aggregate HBM,
    and then still shard the stream if several devices are available —
    chunk compute parallelizes even though the link is the bottleneck.
    """
    if elbo_eval not in ("fresh", "reuse"):
        raise ValueError(f"elbo_eval must be 'fresh' or 'reuse', got {elbo_eval!r}")
    if likelihood_impl not in ("auto", "xla", "z_cheb"):
        raise ValueError(
            "likelihood_impl must be one of 'auto', 'xla', 'z_cheb'; "
            f"got {likelihood_impl!r}"
        )

    if verbose:
        print("Constructing model")  # reference R/inference-tflow.R:102-104
    Y, gene_names, _cell_names = _parse_expression(gene_expression_data)
    N, G_raw = Y.shape
    if K is None:
        K = 1  # reference R/clonealign.R:226-232 (both branches are 1)
    K = int(K)

    L, clone_names = _parse_copy_number(copy_number_data, G_raw)
    C = L.shape[1]
    jdtype = {"float32": jnp.float32, "float64": jnp.float64}[dtype]

    sparse_input = _is_scipy_sparse(Y)

    # --- gene filtering (reference R/inference-tflow.R:117-131) — dense
    # inputs are filtered lazily per chunk so a memmap is never copied
    # whole; sparse inputs are column-sliced once (a data-sized copy) ---
    low = _colsum_f64(Y, sparse_input) <= gene_filter_threshold
    if verbose and low.any():
        print(f"Removing {int(low.sum())} genes with low counts")
    keep_cols = ~low
    L = L[keep_cols]
    if gene_names is not None:
        retained_genes = [g for g, k in zip(gene_names, keep_cols) if k]
    else:
        retained_genes = list(np.flatnonzero(keep_cols))
    if sparse_input and low.any():
        Y = Y.tocsr()[:, keep_cols]
        keep_cols = np.ones(Y.shape[1], bool)
    src = _RowSource(Y, keep_cols)
    G = src.shape[1]

    _validate_counts(
        Y if sparse_input else src, sparse_input,
        allow_fractional=allow_fractional,
    )
    if K > 0 and N < 2:
        raise ValueError(
            "At least 2 cells are required when K > 0 (the PCA initialization "
            "of the latent space needs multiple cells); pass K=0 for a "
            "single-cell fit"
        )

    if saturate:
        L = np.minimum(L, float(saturation_threshold))
    L_dev = jnp.asarray(L, jdtype)

    P = 0
    if x is not None:
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[0] != N:
            raise ValueError(f"x must have {N} rows (cells)")
        P = x.shape[1]

    extra_log_lik, clone_probs_from_snv = _setup_allele(
        clone_allele, cov, ref, N, C, jdtype, verbose
    )

    if likelihood_impl == "auto":
        # same gate as the in-core driver (api._resolve_auto_impl), applied
        # to the TOTAL N x G — streamed problems are by definition large, so
        # the default-corner stream trains through z_cheb like an in-core
        # fit would, instead of silently keeping the exact path. z_cheb fits
        # its Chebyshev range per chunk here (see module docstring).
        likelihood_impl = _resolve_auto_impl(K, P, mc_samples, jdtype, N * G)
    config = mm.ModelConfig(
        K=K, P=P, mc_samples=int(mc_samples), fix_alpha=fix_alpha,
        likelihood_impl=likelihood_impl,
    )
    if likelihood_impl == "z_cheb":
        mm._use_z_cheb(config)  # validate K/P eagerly

    # --- optional device-mesh composition: chunks tile over (cells, genes),
    # resident per-cell state over cells, per-gene params over genes — the
    # same layout as parallel/sharding.py, applied per streamed chunk ---
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _PS

        def _shard(arr, *axes):
            # Per-axis graceful degradation: ``device_put`` requires each
            # sharded dimension to divide evenly across its mesh axis, and
            # streamed chunks are ragged at the tail (and N, G need not be
            # multiples of the mesh). An axis that doesn't divide stays
            # replicated — a pure layout choice, numerically exact; only that
            # chunk's compute loses the parallelism on that one axis.
            if arr is None:
                return None
            # device_put takes host numpy directly and performs per-shard
            # host->device copies; a jnp.asarray here would first commit the
            # whole chunk to the default device and then reshard it — an
            # extra full-chunk allocation on one device plus a transfer, on
            # the per-chunk hot path.
            spec = tuple(
                ax if (ax is not None and arr.shape[d] % mesh.shape[ax] == 0)
                else None
                for d, ax in enumerate(axes)
            )
            return jax.device_put(arr, NamedSharding(mesh, _PS(*spec)))
    else:
        def _shard(arr, *axes):
            return arr if arr is None else jnp.asarray(arr)

    chunk = _resolve_chunk_cells(chunk_cells, N, G)
    bounds = _chunk_bounds(N, chunk)
    n_chunks = len(bounds)

    # --- storage dtype for the streamed chunks ---
    storage_map = {
        None: None, "auto": "auto", "float32": None,
        "bfloat16": jnp.bfloat16, "int16": jnp.int16, "int8": jnp.int8,
    }
    if y_storage not in storage_map:
        raise ValueError(
            f"y_storage must be one of {sorted(k for k in storage_map if k)}, "
            f"got {y_storage!r}"
        )
    storage = storage_map[y_storage]
    if storage == "auto":
        storage = _auto_y_storage(Y.data if sparse_input else Y)
    # host chunks travel in the narrowest numpy-representable dtype; a
    # bfloat16 storage casts on-device after a float32 transfer (numpy has
    # no native bfloat16)
    if storage is not None and jnp.issubdtype(jnp.dtype(storage), jnp.integer):
        host_np, dev_cast = np.dtype(jnp.dtype(storage).name), None
    elif storage is not None:  # bfloat16
        host_np, dev_cast = np.dtype(np.float32), storage
    else:
        host_np, dev_cast = np.dtype(jnp.dtype(jdtype).name), None

    def get_chunk(i, j) -> np.ndarray:
        return np.ascontiguousarray(src[i:j], dtype=host_np)

    def put_chunk(i, j) -> jax.Array:
        # host numpy straight into _shard: under a mesh, device_put splits
        # the chunk per shard without first committing it whole to device 0
        y = _shard(get_chunk(i, j), "cells", "genes")
        return y if dev_cast is None else y.astype(dev_cast)

    # --- per-chunk statistics pass (one-time, full precision; same kernel
    # as the in-core chunked prepare, models/multinomial.py) ---
    if verbose:
        print(
            f"Streaming {N} cells x {G} genes in {n_chunks} chunks of "
            f"{chunk} ({host_np.name} transfer)"
        )
    log_L_safe = jnp.where(L_dev > 0, jnp.log(jnp.where(L_dev > 0, L_dev, 1.0)), 0.0)
    zero_cols = (L_dev <= 0).astype(jdtype)
    statics = []
    s64_parts = []  # float64-exact size factors for the fit object
    colsum = jnp.zeros((G,), jdtype)
    ymax, max_nonint = -np.inf, 0.0
    # table-gather stats iff the RAW source dtype is a <=16-bit integer —
    # keyed on src.dtype, never the storage dtype, so the post-loop
    # overflow/integrality validation still sees pre-downcast values
    # (bit-identical to the lgamma formulation;
    # models/multinomial._log_factorial_table)
    src_table = mm._stats_table_for(src.dtype, jdtype)
    for i, j in bounds:
        blk = src[i:j]
        s64_parts.append(blk.sum(axis=1, dtype=np.float64))
        if src_table is not None:
            yc = jnp.asarray(blk)
            s_c, lb_c, B_c, cs, mx, ni, mn = mm._chunk_stats_table(
                yc, src_table, log_L_safe, zero_cols
            )
            if float(mn) < 0:
                # the table gather clips negative indices — raise instead of
                # silently treating a negative count as log(0!)
                raise ValueError(
                    "gene_expression_data must be non-negative raw counts"
                )
        else:
            yc = jnp.asarray(blk).astype(jdtype)
            s_c, lb_c, B_c, cs, mx, ni = mm._chunk_stats(yc, log_L_safe, zero_cols)
        colsum = colsum + cs
        ymax = max(ymax, float(mx))
        max_nonint = max(max_nonint, float(ni))
        statics.append(_ChunkStatic(
            X=None if x is None else _shard(jnp.asarray(x[i:j], jdtype), "cells", None),
            s=_shard(s_c, "cells"),
            log_binom=_shard(lb_c, "cells"),
            YlogL=_shard(B_c, "cells", None),
            extra=None if extra_log_lik is None
            else _shard(extra_log_lik[i:j], "cells", None),
        ))
        del blk, yc
    colsum = _shard(colsum, "genes")
    L_dev = _shard(L_dev, "genes", None)  # stats pass above ran unsharded
    if storage is not None and jnp.issubdtype(jnp.dtype(storage), jnp.integer):
        info = jnp.iinfo(jnp.dtype(storage))
        if ymax > info.max:
            raise ValueError(
                f"y_storage={jnp.dtype(storage).name} cannot hold the largest "
                f"count ({ymax:.0f} > {info.max}); use int16/bfloat16/float32"
            )
        if max_nonint != 0.0:
            raise ValueError(
                "integer y_storage requires integer counts; found fractional values"
            )

    # --- init (mirrors api._fit_program -> mm.init_params key for key) ---
    if key is None:
        key = jax.random.PRNGKey(0 if seed is None else int(seed))
    k_init, k_fit = jax.random.split(key)
    k_pca, k_jitter = jax.random.split(k_init)

    big = N * G > mm._CHUNK_ELEMENTS
    if K > 0:
        if big:
            pcs = mm._standardize(
                mm._pca_scores_blocked(src, K, k_pca, jdtype), axis=0
            )
        else:
            pcs = mm.pca_init_scores(get_chunk(0, N), K, k_pca, jdtype)
        psi0 = pcs + 0.05 * jax.random.normal(k_jitter, pcs.shape, jdtype)
    else:
        psi0 = jnp.zeros((N, 0), jdtype)

    if isinstance(data_init_mu, (bool, np.bool_)):
        if not data_init_mu:
            mu_guess = jnp.ones((G,), jdtype)
        else:
            mu_guess = mm.data_mu_guess(src if big else get_chunk(0, N), jdtype)
    else:
        mu_guess = jnp.asarray(data_init_mu, jdtype)
        mu_guess = mu_guess / jnp.mean(mu_guess)

    shared = _Shared(
        W=_shard(jnp.zeros((G, max(K, 0)), jdtype), "genes", None),
        chi_unconstr=_shard(jnp.zeros((max(K, 0),), jdtype)),
        beta=_shard(jnp.zeros((G, P), jdtype), "genes", None),
        alpha_unconstr=_shard(jnp.zeros((C,), jdtype)),
        qmu_loc=_shard(mm.safe_inverse_softplus(mu_guess).astype(jdtype), "genes"),
        qmu_log_scale=_shard(jnp.zeros((G,), jdtype), "genes"),
    )
    cells = [
        _Cell(
            psi=_shard(psi0[i:j], "cells", None),
            gamma_logits=_shard(jnp.zeros((j - i, C), jdtype), "cells", None),
        )
        for i, j in bounds
    ]
    del psi0

    # --- warm start + initial ELBO (mirrors infer.run_inference) ---
    lr = float(learning_rate)
    shrink = float(initial_shrink)
    loop_key, k_warm, k_init_eval = jax.random.split(k_fit, 3)

    if verbose:
        print("Optimizing ELBO")  # reference R/inference-tflow.R:383
    for c, (i, j) in enumerate(bounds):
        warm = _chunk_warm(
            shared, cells[c], put_chunk(i, j), L_dev, statics[c], k_warm,
            config=config, shrink=shrink,
        )
        cells[c] = cells[c]._replace(gamma_logits=warm)

    def full_eval(sh, cell_list, keys, eval_config=None):
        """Sum of cell terms over all chunks + global terms, per key."""
        cfg = config if eval_config is None else eval_config
        tot = _global_eval(sh, keys, colsum, config=cfg)
        for c, (i, j) in enumerate(bounds):
            tot = tot + _chunk_eval(
                sh, cell_list[c], put_chunk(i, j), L_dev, statics[c], keys,
                config=cfg,
            )
        return tot

    elbo0 = float(full_eval(shared, cells, k_init_eval[None])[0])
    trace = [elbo0]
    if not np.isfinite(elbo0):
        raise ValueError("Initial elbo is NA")  # reference R/inference-tflow.R:374-376

    # --- Adam loop (host-driven chunk sweeps; semantics of run_inference) ---
    opt = tf1_adam(lr)
    cell_states = [_CellState(c, opt.init(c)) for c in cells]
    shared_opt = opt.init(shared)
    del cells

    window = [1e3] * int(window_size)
    elbo_val = elbo0
    it = 0
    while it < int(max_iter) and np.mean(np.abs(window)) >= float(rel_tol):
        loop_key, k_train, k_eval = jax.random.split(loop_key, 3)
        g_acc = None
        val_cells = None
        for c, (i, j) in enumerate(bounds):
            val, g_sh, cell_states[c] = _chunk_train(
                shared, cell_states[c], put_chunk(i, j), L_dev, statics[c],
                k_train, config=config, lr=lr,
            )
            g_acc = g_sh if g_acc is None else _tree_add(g_acc, g_sh)
            val_cells = val if val_cells is None else val_cells + val
        gval, g_glob = _global_value_grad(shared, k_train, colsum, config=config)
        shared, shared_opt = _shared_update(
            shared, shared_opt, _tree_add(g_acc, g_glob), lr=lr
        )
        if elbo_eval == "fresh":
            elbo_new = float(full_eval(
                shared, [cs.cell for cs in cell_states], k_eval[None]
            )[0])
        else:
            elbo_new = float(val_cells + gval)
        diff = (elbo_new - elbo_val) / abs(elbo_val)
        window = window[1:] + [diff]
        trace.append(elbo_new)
        elbo_val = elbo_new
        it += 1
        if verbose and (it % 50 == 0):
            print(f"  iter {it:4d}  elbo {elbo_new:.4f}  "
                  f"mean|d| {np.mean(np.abs(window)):.3e}")

    # --- final ELBO: mean/sd of fresh evaluations (reference
    # R/inference-tflow.R:447-454), one chunk sweep for all samples. Like
    # the in-core loop (infer.py): when training used the Chebyshev
    # normalizer, the REPORTED ELBO is re-evaluated through the exact one,
    # so z_cheb fits stay directly comparable to exact-path ELBOs ---
    final_config = (
        config._replace(likelihood_impl="xla")
        if mm._use_z_cheb(config)
        else config
    )
    eval_keys = jax.random.split(
        jax.random.fold_in(loop_key, 7), int(n_final_elbo_samples)
    )
    finals = np.asarray(full_eval(
        shared, [cs.cell for cs in cell_states], eval_keys,
        eval_config=final_config,
    ))
    final_elbo = float(np.mean(finals))
    sd_final = float(np.std(finals, ddof=1))
    if verbose:
        print("ELBO converged or reached max iterations")  # R/inference-tflow.R:420

    # --- package (reference R/inference-tflow.R:424-480, R/clonealign.R:283-303) ---
    psi = np.concatenate([np.asarray(cs.cell.psi) for cs in cell_states], axis=0)
    gamma_logits = np.concatenate(
        [np.asarray(cs.cell.gamma_logits) for cs in cell_states], axis=0
    )
    clone_probs = np.asarray(jax.nn.softmax(jnp.asarray(gamma_logits), axis=1))
    s_host = np.concatenate(s64_parts)

    ml_params = {
        "mu": np.asarray(jax.nn.softplus(shared.qmu_loc)),
        "clone_probs": clone_probs,
        "s": s_host,
        "alpha": np.asarray(jax.nn.softmax(shared.alpha_unconstr)),
    }
    if K > 0:
        ml_params["psi"] = psi
        ml_params["W"] = np.asarray(shared.W)
        ml_params["chi"] = np.asarray(jnp.exp(shared.chi_unconstr))
    if P > 0:
        ml_params["beta"] = np.asarray(shared.beta)

    conv = ConvergenceInfo(
        final_elbo=final_elbo,
        sd_final_elbo=sd_final,
        elbo=np.asarray(trace),
        n_iters=it,
    )
    clones = _assign.clone_assignment(
        clone_probs, clone_names, clone_call_probability
    )
    correlations = _assign.compute_correlations(src, L, clones, clone_names)
    finite = correlations[np.isfinite(correlations)]
    if finite.size and np.quantile(finite, 0.25) < 0:
        import warnings

        warnings.warn(
            "Less than 75% of genes positively correlated with expression - "
            "assignment may have failed"
        )  # reference R/clonealign.R:296-300

    return ClonealignFit(
        clone=clones,
        ml_params=ml_params,
        convergence_info=conv,
        retained_genes=retained_genes,
        correlations=correlations,
        clone_names=list(clone_names),
        clone_probs_from_snv=clone_probs_from_snv,
    )
