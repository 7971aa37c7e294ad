"""Public fit API: ``clonealign(...)`` (reference R/clonealign.R:184-305).

Parameter names, defaults, and behavior match the reference's exported
surface (SURVEY.md §2.3). Documented divergences from reference quirks
(SURVEY.md §2.4):

* allele mode uses the *intended* ``alt = cov - ref`` (the reference's public
  API accidentally passes ``ref = cov``, zeroing alt counts —
  reference R/clonealign.R:271);
* ``fix_alpha`` actually fixes the clone priors at uniform (accepted but dead
  in the reference);
* ``initial_shrink`` implements the documented 0..10 warm-start temperature
  (plumbed but unused in the reference); 5 reproduces reference behavior.
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import assign as _assign
from .fit import ClonealignFit, ConvergenceInfo
from .infer import run_inference
from .models import multinomial as mm
from .utils.sparsity import is_scipy_sparse as _is_scipy_sparse
from .models.allele import construct_ai_likelihood, sanitize_allele_info, snv_clone_probs


def saturate(x, threshold=4):
    """Clip copy numbers above threshold (reference R/clonealign.R:394-397)."""
    return np.minimum(np.asarray(x, np.float64), float(threshold))


def _parse_expression(gene_expression_data):
    """Accept a cell-by-gene array, an ExampleSCE-style object with
    ``.counts``/names, or an AnnData-style object with ``.X``
    (reference R/clonealign.R:212-224 accepts SCE or matrix).

    scipy sparse matrices (direct or as AnnData ``.X``) are kept sparse —
    statistics and the device upload are computed from the sparse structure
    without a host-side N x G float64 densification."""
    gene_names = cell_names = None
    obj = gene_expression_data
    if hasattr(obj, "counts"):
        Y = np.asarray(obj.counts)
        gene_names = list(getattr(obj, "gene_names", None) or [])
        cell_names = list(getattr(obj, "cell_names", None) or [])
    elif hasattr(obj, "X"):  # AnnData duck-type
        X = obj.X
        Y = X.tocsr() if _is_scipy_sparse(X) else np.asarray(X)
        if hasattr(obj, "var_names"):
            gene_names = [str(g) for g in obj.var_names]
        if hasattr(obj, "obs_names"):
            cell_names = [str(c) for c in obj.obs_names]
    elif _is_scipy_sparse(obj):
        Y = obj.tocsr()
    elif hasattr(obj, "todense"):  # other COOMatrix-style duck-types
        Y = np.asarray(obj.todense())
    else:
        Y = np.asarray(obj)
    if Y.ndim != 2:
        raise ValueError("gene_expression_data must be a 2-D cell-by-gene matrix")
    # Keep the INPUT dtype: a float64 N x G copy here would peak 16 GB of
    # host RAM for a 1M x 2k int16 matrix (VERDICT r2 weak item 4). All
    # validation and statistics downstream run chunk-wise at input dtype;
    # only non-numeric (object/bool/...) arrays are converted.
    if not _is_scipy_sparse(Y) and not (
        np.issubdtype(Y.dtype, np.integer) or np.issubdtype(Y.dtype, np.floating)
    ):
        Y = Y.astype(np.float64)
    return Y, gene_names or None, cell_names or None


from .utils.chunking import host_row_chunk as _host_row_chunk  # noqa: E402


def _colsum_f64(Y, sparse: bool) -> np.ndarray:
    """Per-gene count totals, accumulated in float64 without a full-matrix
    temporary (dense inputs stream row chunks at their own dtype)."""
    if sparse:
        return np.asarray(Y.sum(axis=0)).ravel().astype(np.float64)
    N, G = Y.shape
    acc = np.zeros(G, np.float64)
    for i in range(0, N, _host_row_chunk(G)):
        acc += Y[i : i + _host_row_chunk(G)].sum(axis=0, dtype=np.float64)
    return acc


_FRACTIONAL_MSG = (
    "gene_expression_data must contain raw integer counts — clonealign's "
    "model is a count likelihood, and the reference API takes the counts "
    "assay specifically (reference R/clonealign.R:212-224). Found fractional "
    "values, which usually means normalized/log-transformed data (e.g. "
    "scanpy's adata.X after normalization). Pass the raw counts instead "
    "(AnnData users: adata.layers['counts'] or adata.raw.X), or set "
    "allow_fractional=True to fit the fractional values anyway."
)


def _validate_counts(Y, sparse: bool, allow_fractional: bool = False) -> None:
    """NaN/inf, negativity, integrality, and zero-count-cell checks
    (reference R/inference-tflow.R:212-214; the integrality check enforces
    the reference's counts-assay contract, R/clonealign.R:212-224) —
    chunk-wise for dense inputs so no full-size boolean/temporary is ever
    allocated."""
    if sparse:
        v = Y.data
        if np.issubdtype(v.dtype, np.floating) and not np.isfinite(v).all():
            raise ValueError("gene_expression_data contains NaN/inf values")
        if v.size and (v < 0).any():
            raise ValueError("gene_expression_data must be non-negative raw counts")
        if (
            not allow_fractional
            and np.issubdtype(v.dtype, np.floating)
            and v.size
            and np.any(v != np.trunc(v))
        ):
            raise ValueError(_FRACTIONAL_MSG)
        if (np.asarray(Y.sum(axis=1)).ravel() == 0).any():
            raise ValueError("Some cells have no counts mapping")
        return
    N, G = Y.shape
    check_finite = np.issubdtype(Y.dtype, np.floating)
    zero_cell = False
    for i in range(0, N, _host_row_chunk(G)):
        c = Y[i : i + _host_row_chunk(G)]
        if check_finite and not np.isfinite(c).all():
            raise ValueError("gene_expression_data contains NaN/inf values")
        if (c < 0).any():
            raise ValueError("gene_expression_data must be non-negative raw counts")
        if check_finite and not allow_fractional and np.any(c != np.trunc(c)):
            raise ValueError(_FRACTIONAL_MSG)
        if (c.sum(axis=1, dtype=np.float64) == 0).any():
            zero_cell = True
    if zero_cell:
        raise ValueError("Some cells have no counts mapping")  # R/inference-tflow.R:212-214


def _parse_copy_number(copy_number_data, G):
    """Accept (G, C) array or pandas-like with named clone columns
    (reference R/clonealign.R:237-254)."""
    clone_names = None
    obj = copy_number_data
    if hasattr(obj, "columns") and hasattr(obj, "values"):  # pandas-like
        clone_names = [str(c) for c in obj.columns]
        L = np.asarray(obj.values, np.float64)
    elif isinstance(obj, dict):
        clone_names = [str(c) for c in obj.keys()]
        L = np.stack([np.asarray(v, np.float64) for v in obj.values()], axis=1)
    else:
        L = np.asarray(obj, np.float64)
    if L.ndim == 1:
        L = L[:, None]
    if L.shape[0] != G:
        raise ValueError(
            "copy_number_data must have same number of genes (rows) as "
            f"gene_expression_data: got {L.shape[0]} vs {G}"
        )
    if clone_names is None:
        clone_names = _default_clone_names(L.shape[1])
    return L, clone_names


def _default_clone_names(C: int):
    """Reference default: clone_a, clone_b, ... (R/clonealign.R:252-254)."""
    import string

    letters = string.ascii_lowercase
    return ["clone_" + (letters[i] if i < 26 else str(i)) for i in range(C)]


class FitContext:
    """Parsed, filtered, device-ready inputs shared by single- and
    multi-restart fits."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _auto_y_storage(y_values):
    """Narrowest EXACT device storage for the count matrix: int8 when every
    count fits, int16 up to 32767, else the compute dtype. Only integer
    dtypes are auto-selected — they are lossless, so "auto" can never change
    results (verified bit-identical assignments at benchmark scale,
    docs/design.md section 2)."""
    if y_values.size == 0:
        return None
    if np.issubdtype(np.asarray(y_values).dtype, np.integer):
        ymax = float(y_values.max())
    else:
        # chunked integrality scan: no full-size round/abs temporaries (a
        # dense 100k x 5k f64 input would otherwise allocate ~8 GB extra)
        flat = np.asarray(y_values).reshape(-1)
        ymax = 0.0
        step = 16_777_216
        for i in range(0, flat.size, step):
            c = flat[i : i + step]
            if np.any(c != np.trunc(c)):
                return None  # fractional "counts": keep full precision
            ymax = max(ymax, float(c.max()))
    if ymax <= np.iinfo(np.int8).max:
        return jnp.int8
    if ymax <= np.iinfo(np.int16).max:
        return jnp.int16
    return None


def _resolve_auto_impl(K, P, mc_samples, jdtype, n_elements) -> str:
    """Resolve ``likelihood_impl="auto"`` to the configuration that was
    benchmarked and parity-proven (converged z_cheb fits meet the SAME
    f64-oracle bar as the exact path with identical assignments,
    tests/golden/parity_oracle.npz): the Chebyshev normalizer in the default
    K=1 / no-covariate / single-MC-sample / float32 corner, the exact
    XLA normalizer everywhere else (float64 fits stay exact-path —
    they are the oracle configuration, and z_cheb's degree was tuned
    for f32 noise floors). The *reported* ELBO stays exact either way:
    run_inference re-evaluates the final 20-sample ELBO through the
    exact normalizer whenever training used z_cheb.

    Size gate: z_cheb exists for throughput, and its per-step saving is
    negligible below ~1M retained N x G elements, where the exact
    normalizer costs next to nothing. With the bf16 matmuls of the
    accelerator the system was first built for, z_cheb trajectories of
    TINY marginal problems settled just past the 1e-4 oracle bar; on an
    H100 the 200x100 example meets it (PERF.md), and the gate stays until
    it is re-measured. ``fit_streaming`` applies the same rule over the
    total (pre-chunk) N x G."""
    if (K == 1 and P == 0 and int(mc_samples) == 1
            and jdtype == jnp.float32 and int(n_elements) >= 1_000_000):
        return "z_cheb"
    return "xla"


def setup_fit(
    gene_expression_data,
    copy_number_data,
    gene_filter_threshold: float = 0,
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
    data_init_mu=True,
    y_storage: Optional[str] = "auto",
    likelihood_impl: str = "auto",
    allow_fractional: bool = False,
) -> FitContext:
    """Input parsing + filtering + device data prep
    (reference R/clonealign.R:206-260 and R/inference-tflow.R:111-235).

    ``allow_fractional=False`` (default) rejects float inputs with
    fractional values — the model is a count likelihood and the reference's
    API shape (the counts assay, reference R/clonealign.R:212-224) makes
    feeding normalized data impossible there; here a scanpy-normalized
    ``adata.X`` would otherwise silently produce a wrong fit. Set True to
    opt into fitting fractional values (they flow through the float
    likelihood path unchanged)."""
    if verbose:
        print("Constructing model")  # reference R/inference-tflow.R:102-104
    Y, gene_names, _cell_names = _parse_expression(gene_expression_data)
    N, G = Y.shape
    if K is None:
        K = 1  # reference R/clonealign.R:226-232 (both branches are 1)
    K = int(K)

    L, clone_names = _parse_copy_number(copy_number_data, G)
    C = L.shape[1]

    jdtype = {"float32": jnp.float32, "float64": jnp.float64}[dtype]

    sparse_input = _is_scipy_sparse(Y)

    # For dense <=16-bit integer matrices the host validation pass is
    # redundant: integers cannot be NaN/inf, the table-stats programs in
    # prepare_data enforce non-negativity on device (min count), and the
    # zero-count-cell check runs below from the device row sums — skipping
    # an O(N x G) host scan.
    device_validated = (
        not sparse_input
        and isinstance(Y, np.ndarray)
        and np.issubdtype(Y.dtype, np.integer)
        and Y.dtype.itemsize <= 2
    )

    # --- gene filtering (reference R/inference-tflow.R:117-131) ---
    # On the device-validated path the filter statistic comes from the
    # device stats pass that prepare_data runs anyway (colsum_Y), so the
    # host colsum pass here is skipped too — see the deferred branch below.
    # (Device totals are exact for this decision: partial sums of
    # non-negative integers never exceed the total, f32 is exact below 2^24,
    # and a total large enough to round is far above any threshold the gate
    # admits.)
    defer_filter = device_validated and float(gene_filter_threshold) < 2.0**24
    if not defer_filter:
        low = _colsum_f64(Y, sparse_input) <= gene_filter_threshold
        if verbose and low.any():
            print(f"Removing {int(low.sum())} genes with low counts")
        if low.any():  # no-copy fast path when nothing is filtered
            Y = Y[:, ~low]
        L = L[~low]
        if gene_names is not None:
            retained_genes = [g for g, drop in zip(gene_names, low) if not drop]
        else:
            retained_genes = list(np.flatnonzero(~low))

    if not device_validated:
        _validate_counts(Y, sparse_input, allow_fractional=allow_fractional)
    if K > 0 and N < 2:
        raise ValueError(
            "At least 2 cells are required when K > 0 (the PCA initialization "
            "of the latent space needs multiple cells); pass K=0 for a "
            "single-cell fit"
        )

    # --- saturation (reference R/inference-tflow.R:142-144) ---
    if saturate:
        L = np.minimum(L, float(saturation_threshold))

    # --- covariates ---
    P = 0
    if x is not None:
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[0] != N:
            raise ValueError(f"x must have {N} rows (cells)")
        P = x.shape[1]

    # --- allele-specific setup (reference R/inference-tflow.R:166-187) ---
    extra_log_lik, clone_probs_from_snv = _setup_allele(
        clone_allele, cov, ref, N, C, jdtype, verbose
    )

    if likelihood_impl not in ("auto", "xla", "z_cheb"):
        raise ValueError(
            "likelihood_impl must be one of 'auto', 'xla', "
            f"'z_cheb'; got {likelihood_impl!r}"
        )
    if likelihood_impl == "z_cheb":
        # validate the K/P support eagerly — a pure configuration error must
        # surface BEFORE the host validation + device upload in
        # prepare_data below
        mm._use_z_cheb(mm.ModelConfig(
            K=K, P=P, mc_samples=int(mc_samples), fix_alpha=fix_alpha,
            likelihood_impl="z_cheb",
        ))
    # int16/int8 store counts EXACTLY (bf16 rounds above 256) and move the
    # fewest bytes per likelihood pass; prepare_data raises if any
    # count would overflow the range. "auto" picks the narrowest exact
    # integer dtype, falling back to full precision for fractional counts.
    storage_map = {
        None: None,
        "auto": "auto",
        "float32": None,
        "bfloat16": jnp.bfloat16,
        "int16": jnp.int16,
        "int8": jnp.int8,
    }
    if y_storage not in storage_map:
        raise ValueError(
            f"y_storage must be one of {sorted(k for k in storage_map if k)}, got {y_storage!r}"
        )
    storage = storage_map[y_storage]
    if storage == "auto":
        storage = _auto_y_storage(Y.data if sparse_input else Y)
    data = mm.prepare_data(Y, L, x=x, dtype=jdtype, y_storage=storage)

    if defer_filter:
        # The per-gene totals fell out of the device stats pass; apply the
        # filter decision now. Common case (nothing filtered): the prepared
        # data IS the final data and the host never ran a colsum pass. Rare
        # case: gather the kept columns ON DEVICE and rerun the (fast,
        # device-side) stats — the wire pass is never repeated.
        low = np.asarray(data.colsum_Y, np.float64) <= gene_filter_threshold
        if low.any():
            if verbose:
                print(f"Removing {int(low.sum())} genes with low counts")
            keep = np.flatnonzero(~low)
            Y = Y[:, ~low]  # host copy for the QC fallbacks (ctx.Y)
            L = L[~low]
            stored_Y = data.Y
            del data
            if storage == jnp.bfloat16:
                # bf16 storage is LOSSY above 256: re-preparing from the
                # stored device matrix would compute s/log_binom/colsum from
                # ROUNDED counts, violating prepare_data's stats-before-
                # downcast contract — rebuild from the exact host counts
                # (costs a second wire pass only on this rare
                # bf16-and-genes-filtered combination)
                del stored_Y
                data = mm.prepare_data(Y, L, x=x, dtype=jdtype,
                                       y_storage=storage)
            else:
                # exact storages: gather the kept columns on device — the
                # stored values ARE the counts, so the re-run stats are exact
                # and the wire pass is never repeated
                Yd = jnp.take(stored_Y, jnp.asarray(keep, jnp.int32), axis=1)
                del stored_Y  # release the unfiltered device buffer
                data = mm.prepare_data(Yd, L, x=x, dtype=jdtype,
                                       y_storage=storage)
        if gene_names is not None:
            retained_genes = [g for g, drop in zip(gene_names, low) if not drop]
        else:
            retained_genes = list(np.flatnonzero(~low))

    if likelihood_impl == "auto":
        likelihood_impl = _resolve_auto_impl(
            K, P, mc_samples, jdtype, int(Y.shape[0]) * int(Y.shape[1])
        )
    config = mm.ModelConfig(
        K=K, P=P, mc_samples=int(mc_samples), fix_alpha=fix_alpha,
        likelihood_impl=likelihood_impl,
    )
    if likelihood_impl == "z_cheb":
        mm._use_z_cheb(config)  # validate K/P eagerly with a clear error

    if device_validated and float(jnp.min(data.s)) == 0:
        raise ValueError(
            "Some cells have no counts mapping"
        )  # reference R/inference-tflow.R:212-214

    # normalize numpy booleans (np.True_, 0-d bool arrays — e.g. flags read
    # from pandas/numpy configs) to python bool: the fit drivers classify
    # data_init_mu with isinstance(..., bool), and a np.bool_ would fall
    # into the "array" branch, producing a shape-() mu init that crashes
    # inside the jitted program (round-5 review finding)
    if isinstance(data_init_mu, np.bool_) or (
        isinstance(data_init_mu, np.ndarray)
        and data_init_mu.ndim == 0
        and data_init_mu.dtype == np.bool_
    ):
        data_init_mu = bool(data_init_mu)
    return FitContext(
        Y=Y,
        L=L,
        x=x,
        clone_names=clone_names,
        retained_genes=retained_genes,
        config=config,
        data=data,
        jdtype=jdtype,
        data_init_mu=data_init_mu,
        extra_log_lik=extra_log_lik,
        clone_probs_from_snv=clone_probs_from_snv,
        verbose=verbose,
    )


def _setup_allele(clone_allele, cov, ref, N, C, jdtype, verbose):
    """Allele-specific likelihood setup (reference R/inference-tflow.R:166-187):
    returns ``(extra_log_lik, clone_probs_from_snv)`` or ``(None, None)``
    when any of the three inputs is missing. Shared by :func:`setup_fit` and
    the streaming driver (stream.py)."""
    if clone_allele is None or ref is None or cov is None:
        return None, None
    if verbose:
        print("Using allelic imbalance info")  # R/inference-tflow.R:169-171
    clone_allele = np.asarray(clone_allele, np.float64)
    cov = np.asarray(cov, np.float64)
    ref = np.asarray(ref, np.float64)
    sanitize_allele_info(clone_allele, cov, ref, N, C)
    cov_vn = cov.T
    alt_vn = cov_vn - ref.T  # intended semantics; see module docstring
    v_log_prob = construct_ai_likelihood(
        jnp.asarray(clone_allele, jdtype),
        jnp.asarray(alt_vn, jdtype),
        jnp.asarray(cov_vn, jdtype),
    )
    return v_log_prob, np.asarray(snv_clone_probs(v_log_prob))


def _mu_init_array(data_init_mu, jdtype):
    """User-supplied mu init as a traced array (None for the bool cases)."""
    if isinstance(data_init_mu, bool):
        return None
    return jnp.asarray(data_init_mu, jdtype)



@functools.partial(
    jax.jit,
    static_argnames=(
        "config",
        "data_init_mu",
        "jdtype_name",
        "max_iter",
        "rel_tol",
        "learning_rate",
        "initial_shrink",
        "elbo_eval",
        "progress",
        "loop_impl",
        "unroll",
        "remat",
    ),
)
def _fit_program(
    key,
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
    initial_shrink,
    elbo_eval,
    progress,
    loop_impl="while",
    unroll=1,
    remat="auto",
):
    """The fully-jitted fit: init (PCA included) + warm start + Adam loop +
    final ELBO estimate.

    Module-level with static config so repeat ``clonealign()`` calls on
    same-shaped data REUSE the compiled program (a per-call ``@jax.jit``
    closure would recompile every invocation). Data is an argument, never a
    closure: closed-over device arrays are baked into the serialized program
    as constants.
    """
    jdtype = jnp.dtype(jdtype_name)
    init_mu = data_init_mu if isinstance(data_init_mu, bool) else mu_init
    k_init, k_fit = jax.random.split(key)
    params0 = mm.init_params(
        data.Y,
        data.L,
        k_init,
        K=config.K,
        P=config.P,
        data_init_mu=init_mu,
        dtype=jdtype,
    )
    return run_inference(
        params0,
        data,
        k_fit,
        config,
        max_iter=max_iter,
        rel_tol=rel_tol,
        learning_rate=learning_rate,
        initial_shrink=initial_shrink,
        extra_log_lik=extra_log_lik,
        elbo_eval=elbo_eval,
        progress=progress,
        loop_impl=loop_impl,
        unroll=unroll,
        remat=remat,
    )


def clonealign(
    gene_expression_data,
    copy_number_data,
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
    elbo_eval: str = "fresh",
    progress: bool = False,
    y_storage: Optional[str] = "auto",
    likelihood_impl: str = "auto",
    allow_fractional: bool = False,
    loop_impl: str = "while",
    unroll: int = 1,
    remat="auto",
) -> ClonealignFit:
    """Assign scRNA-seq cells to clones of origin by variational inference.

    Mirrors the reference's ``clonealign()`` signature and defaults
    (reference R/clonealign.R:184-203) with one addition: reproducibility is
    controlled by ``seed``/``key`` (JAX PRNG) instead of R's global RNG
    (reference R/inference-tflow.R:49-51).
    """
    ctx = setup_fit(
        gene_expression_data,
        copy_number_data,
        gene_filter_threshold=gene_filter_threshold,
        x=x,
        clone_allele=clone_allele,
        cov=cov,
        ref=ref,
        fix_alpha=fix_alpha,
        dtype=dtype,
        saturate=saturate,
        saturation_threshold=saturation_threshold,
        K=K,
        mc_samples=mc_samples,
        verbose=verbose,
        data_init_mu=data_init_mu,
        y_storage=y_storage,
        likelihood_impl=likelihood_impl,
        allow_fractional=allow_fractional,
    )

    if key is None:
        key = jax.random.PRNGKey(0 if seed is None else int(seed))

    if verbose:
        print("Optimizing ELBO")  # reference R/inference-tflow.R:383
    result = _fit_program(
        key,
        ctx.data,
        ctx.extra_log_lik,
        _mu_init_array(ctx.data_init_mu, ctx.jdtype),
        config=ctx.config,
        data_init_mu=ctx.data_init_mu if isinstance(ctx.data_init_mu, bool) else "array",
        jdtype_name=str(jnp.dtype(ctx.jdtype)),
        max_iter=int(max_iter),
        rel_tol=float(rel_tol),
        learning_rate=float(learning_rate),
        initial_shrink=float(initial_shrink),
        elbo_eval=elbo_eval,
        progress=progress,
        loop_impl=loop_impl,
        unroll=unroll,
        remat=remat,
    )

    if verbose:
        print("ELBO converged or reached max iterations")  # R/inference-tflow.R:420
    return _package_fit(
        result,
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


def _package_fit(
    result,
    Y,
    L,
    clone_names,
    retained_genes,
    config,
    clone_call_probability,
    clone_probs_from_snv,
    device_Y=None,
    device_s=None,
) -> ClonealignFit:
    """Fetch ML params and build the fit object
    (reference R/inference-tflow.R:424-480, R/clonealign.R:283-303)."""
    p = result.params
    # Size factors must be float64-exact. When the device-resident counts
    # are integer-typed (validated non-negative integers) and every row
    # total stays below 2^24, the prepared float32 ``data.s`` is already
    # bit-exact (partial sums of non-negative integers never exceed the
    # total, so no rounding can occur in any reduction order) — fetch that
    # N-vector instead of re-summing the host N x G matrix. Otherwise,
    # accumulate IN float64 on the host (not just cast after) so float32
    # inputs keep the float64-exact size factors.
    s = None
    if (
        device_s is not None
        and device_Y is not None
        and jnp.issubdtype(device_Y.dtype, jnp.integer)
        and float(jnp.max(device_s)) < 2.0**24
    ):
        s = np.asarray(device_s, np.float64)
    if s is None:
        s = np.asarray(Y.sum(axis=1, dtype=np.float64)).ravel()
    ml_params = {
        "mu": np.asarray(jax.nn.softplus(p.qmu_loc)),
        "clone_probs": np.asarray(jax.nn.softmax(p.gamma_logits, axis=1)),
        "s": s,
        "alpha": np.asarray(jax.nn.softmax(p.alpha_unconstr)),
    }
    if config.K > 0:
        ml_params["psi"] = np.asarray(p.psi)
        ml_params["W"] = np.asarray(p.W)
        ml_params["chi"] = np.asarray(jnp.exp(p.chi_unconstr))
    if config.P > 0:
        ml_params["beta"] = np.asarray(p.beta)

    n_iters = int(result.n_iters)
    trace = np.asarray(result.elbo_trace)[: n_iters + 1]
    conv = ConvergenceInfo(
        final_elbo=float(result.final_elbo),
        sd_final_elbo=float(result.sd_final_elbo),
        elbo=trace,
        n_iters=n_iters,
    )
    if not np.isfinite(trace[0]):
        raise ValueError("Initial elbo is NA")  # reference R/inference-tflow.R:374-376

    clones = _assign.clone_assignment(
        ml_params["clone_probs"], clone_names, clone_call_probability
    )

    correlations = _assign.compute_correlations(
        Y, L, clones, clone_names, device_Y=device_Y
    )

    finite = correlations[np.isfinite(correlations)]
    if finite.size and np.quantile(finite, 0.25) < 0:
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
