"""Multi-restart driver (reference R/clonealign.R:35-75).

The reference runs ``length(initial_shrinks) x n_repeats`` fits *sequentially*
in one R process and keeps the best-ELBO fit. Here the whole sweep is ONE
compiled program: restarts are either vmapped (small problems — batched Adam
loops, roughly one fit's wall-clock for the sweep; early-converged lanes
freeze while the rest continue, see infer.py) or run sequentially on-device
via lax.map (large problems — bounds memory to a single fit's working set).
"auto" picks by problem size.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import assign as _assign
from .api import _mu_init_array, _package_fit, setup_fit
from .infer import run_inference
from .models import multinomial as mm


@functools.partial(
    jax.jit,
    static_argnames=(
        "config",
        "data_init_mu",
        "jdtype_name",
        "max_iter",
        "rel_tol",
        "learning_rate",
        "elbo_eval",
        "restart_batching",
        "loop_impl",
        "unroll",
        "remat",
    ),
)
def _sweep_program(
    keys,
    shrinks,
    data,
    extra_log_lik,
    mu_init,
    *,
    config,
    data_init_mu,
    jdtype_name,
    max_iter,
    rel_tol,
    learning_rate,
    elbo_eval,
    restart_batching,
    loop_impl="while",
    unroll=1,
    remat="auto",
):
    """The whole restart sweep as ONE jitted program. Module-level with
    static config so repeat sweeps on same-shaped data reuse the compiled
    program; data is an argument so it is never baked in as a constant."""
    jdtype = jnp.dtype(jdtype_name)
    init_mu = data_init_mu if isinstance(data_init_mu, bool) else mu_init

    # Deterministic init passes hoisted out of the lanes and SHARED across
    # restarts — exactly the reference's semantics (prcomp and the mu guess
    # are deterministic per dataset; only the psi jitter and MC streams vary
    # per restart, reference R/inference-tflow.R:204-235). Per-lane
    # randomized PCA would repeat the tall-skinny QR factorizations in
    # every vmap lane, and under "map" batching every sequential lane would
    # repay the full init cost.
    shared_pca = None
    if config.K > 0:
        shared_pca = mm.pca_init_scores(
            data.Y, config.K, mm.lane0_pca_key(keys[0]), jdtype
        )
    shared_mu = None
    if isinstance(init_mu, bool) and init_mu:
        shared_mu = mm.data_mu_guess(data.Y, jdtype)

    def one_fit(k, shrink):
        k_init, k_fit = jax.random.split(k)
        params0 = mm.init_params(
            data.Y, data.L, k_init, K=config.K, P=config.P,
            data_init_mu=init_mu, dtype=jdtype,
            pca_scores=shared_pca, mu_guess=shared_mu,
        )
        return run_inference(
            params0, data, k_fit, config,
            max_iter=max_iter, rel_tol=rel_tol, learning_rate=learning_rate,
            initial_shrink=shrink, extra_log_lik=extra_log_lik,
            elbo_eval=elbo_eval, loop_impl=loop_impl, unroll=unroll,
            remat=remat,
        )

    if restart_batching == "vmap":
        return jax.vmap(one_fit)(keys, shrinks)
    return jax.lax.map(lambda ks: one_fit(ks[0], ks[1]), (keys, shrinks))


# Restart lanes x N x G elements that fit per byte of device memory at
# float32 compute: on a device with 16 GiB, 10 vmapped lanes at 100k x 5k
# (5e8 elements) fit for both int8 and f32 Y storage, while 10 lanes at
# 500k x 2k (1e9) did not, so the budget sits below that boundary.
_LANE_ELEMENTS_PER_BYTE = 6e9 / (16 * 2**30)
# The CPU backend reports no memory limit; this bounds the host working set.
_CPU_LANE_ELEMENTS = 6e9


def _lane_element_budget(device) -> float:
    """Lanes x elements one device holds at float32 compute."""
    if device.platform == "cpu":
        return _CPU_LANE_ELEMENTS
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"{device.platform} device {device.device_kind!r} reports no "
            "bytes_limit in memory_stats(); pass restart_batching='vmap' or "
            "'map' explicitly"
        )
    return float(limit) * _LANE_ELEMENTS_PER_BYTE


def _auto_restart_batching(n_elems, n_lanes, n_dev, itemsize, device=None) -> str:
    """Pick vmap vs sequential-map restart batching by per-device working set.

    vmap multiplies the per-restart working set by the number of lanes, so
    the cutover is on lanes x elements against the device's memory
    (:func:`_lane_element_budget`). Wider compute dtypes (dtype='float64')
    double every per-lane intermediate, so the element budget scales down
    with the compute itemsize. On a mesh the per-DEVICE share is what must
    fit.
    """
    device = jax.devices()[0] if device is None else device
    budget = _lane_element_budget(device) * n_dev * 4 / max(int(itemsize), 4)
    return "map" if n_elems * n_lanes > budget else "vmap"


def run_clonealign(
    gene_expression_data,
    copy_number_data,
    initial_shrinks: Sequence[float] = (0, 5, 10),
    n_repeats: int = 3,
    print_elbos: bool = True,
    max_iter: int = 200,
    rel_tol: float = 1e-6,
    learning_rate: float = 0.1,
    clone_call_probability: float = 0.95,
    seed: Optional[int] = None,
    key=None,
    elbo_eval: str = "fresh",
    mesh=None,
    restart_batching: str = "auto",
    loop_impl: str = "while",
    unroll: int = 1,
    remat="auto",
    multirun_correlations: Optional[bool] = None,
    **kwargs,
):
    """Sweep restarts, return the max-ELBO fit with ``multirun_info`` attached
    (reference R/clonealign.R:35-75). Extra kwargs go to the model setup
    (same names as :func:`clonealign`).

    ``mesh`` (a ``jax.sharding.Mesh`` from
    :func:`clonealign_tpu.parallel.sharding.make_mesh`) shards the data over
    devices — cells data-parallel, genes tensor-parallel — so the sweep scales
    across devices. ``restart_batching``: "vmap" batches every restart
    into one program (fastest, memory ~ R x one fit); "map" runs restarts
    sequentially on-device (memory ~ one fit; best at very large N x G);
    "auto" (default) picks by problem size against the device's memory.
    ``remat``: "auto" (default) rematerializes the backward only for the
    exact likelihood, which stores N x G intermediates; z_cheb has none, so
    it skips the recompute. Pass True/False to force.
    """
    verbose = kwargs.get("verbose", True)
    ctx = setup_fit(gene_expression_data, copy_number_data, **kwargs)
    if restart_batching == "auto":
        restart_batching = _auto_restart_batching(
            n_elems=ctx.data.Y.shape[0] * ctx.data.Y.shape[1],
            n_lanes=len(initial_shrinks) * n_repeats,
            n_dev=mesh.devices.size if mesh is not None else 1,
            itemsize=jnp.dtype(ctx.jdtype).itemsize,
            device=mesh.devices.flat[0] if mesh is not None else None,
        )
    if restart_batching not in ("vmap", "map"):
        raise ValueError(f"restart_batching must be 'vmap' or 'map', got {restart_batching!r}")
    if mesh is not None:
        from .parallel.sharding import shard_data, shard_extra_log_lik

        ctx.data = shard_data(ctx.data, mesh)
        ctx.extra_log_lik = shard_extra_log_lik(ctx.extra_log_lik, mesh)

    shrinks = np.asarray(
        [s for s in initial_shrinks for _ in range(n_repeats)], np.float64
    )
    R = len(shrinks)
    if key is None:
        key = jax.random.PRNGKey(0 if seed is None else int(seed))
    keys = jax.random.split(key, R)

    results = _sweep_program(
        keys,
        jnp.asarray(shrinks, ctx.jdtype),
        ctx.data,
        ctx.extra_log_lik,
        _mu_init_array(ctx.data_init_mu, ctx.jdtype),
        config=ctx.config,
        data_init_mu=ctx.data_init_mu if isinstance(ctx.data_init_mu, bool) else "array",
        jdtype_name=str(jnp.dtype(ctx.jdtype)),
        max_iter=int(max_iter),
        rel_tol=float(rel_tol),
        learning_rate=float(learning_rate),
        elbo_eval=elbo_eval,
        restart_batching=restart_batching,
        loop_impl=loop_impl,
        unroll=unroll,
        remat=remat,
    )

    final_elbos = np.asarray(results.final_elbo)
    if print_elbos and verbose:
        print("ELBOs: ", " ".join(str(e) for e in final_elbos))

    # NaN-safe best: np.argmax would select a diverged (NaN) lane over all
    # finite ones. All-NaN mirrors the reference's NA-initial-ELBO hard error
    # (reference R/inference-tflow.R:372-376).
    if np.isnan(final_elbos).all():
        raise ValueError(
            "All restarts produced NaN ELBOs — inference diverged; try a "
            "lower learning_rate"
        )
    best = int(np.nanargmax(final_elbos))
    best_result = jax.tree.map(lambda a: a[best], results)

    fit = _package_fit(
        best_result,
        ctx.Y,
        ctx.L,
        ctx.clone_names,
        ctx.retained_genes,
        ctx.config,
        clone_call_probability,
        ctx.clone_probs_from_snv,
        device_Y=ctx.data.Y,
        device_s=ctx.data.s,
    )

    # multirun_info (reference R/clonealign.R:67-73). Per-run median
    # correlations used to be an O(R * N * G) host-side pass, skipped for
    # very large problems; the device-side sufficient statistics
    # (assign._clone_sums_device — one matmul per run) make them cheap
    # at any scale, so they now default ON, like the reference.
    if multirun_correlations is None:
        multirun_correlations = True
    prevalences = []
    median_correlations = []
    # Clone calls for all R lanes in ONE device program (softmax -> threshold
    # -> argmax -> per-label counts): the fetch is an (R, N) int32 + the
    # (R, C+1) counts instead of the full (R, N, C) softmax, and no host
    # argmax/unique pass runs.
    called, counts = _assign.multirun_calls_device(
        results.params.gamma_logits, clone_call_probability
    )
    labels_all = [str(c) for c in ctx.clone_names] + [_assign.UNASSIGNED]
    for r in range(R):
        prevalences.append(
            {labels_all[i]: int(n) for i, n in enumerate(counts[r]) if n}
        )
        if multirun_correlations:
            corr_r = _assign.compute_correlations(
                ctx.Y, ctx.L, None, ctx.clone_names,
                device_Y=ctx.data.Y, clones_idx=called[r],
            )
            finite = corr_r[np.isfinite(corr_r)]
            median_correlations.append(float(np.median(finite)) if finite.size else np.nan)
        else:
            median_correlations.append(np.nan)

    fit.multirun_info = {
        "elbos": final_elbos,
        "clone_prevalences_at_different_shrinks": prevalences,
        "median_correlations": np.asarray(median_correlations),
        "initial_shrinks": shrinks,
        "best_run": best,
    }
    return fit
