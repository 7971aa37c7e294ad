"""Clone calling and post-hoc QC (reference R/inference-tflow.R:22-46,
R/clonealign.R:318-334)."""

from __future__ import annotations

import numpy as np

from .utils.chunking import host_row_chunk as _host_row_chunk
from .utils.sparsity import is_scipy_sparse as _is_scipy_sparse

UNASSIGNED = "unassigned"


def clone_assignment(clone_probs, clone_names, clone_assignment_probability: float = 0.95):
    """Threshold-argmax clone calls (reference R/inference-tflow.R:22-29):
    a cell gets its argmax clone if that probability reaches the threshold,
    otherwise ``"unassigned"``."""
    probs = np.asarray(clone_probs)
    names = np.asarray(list(clone_names) + [UNASSIGNED], dtype=object)
    best = probs.argmax(axis=1)
    maxp = probs.max(axis=1)
    # NaN rows (a diverged fit) must read as unassigned, not clone 0:
    # `nan < t` is False, so the plain threshold test would pass them through
    low = ~(maxp >= clone_assignment_probability)
    called = np.where(low, len(clone_names), best)
    return [str(x) for x in names[called]]


def recompute_clone_assignment(fit, clone_assignment_probability: float = 0.95):
    """Re-threshold an existing fit (reference R/inference-tflow.R:36-46)."""
    from dataclasses import replace

    clones = clone_assignment(
        fit.ml_params["clone_probs"], fit.clone_names, clone_assignment_probability
    )
    return replace(fit, clone=clones)


def compute_ca_fit_mse(fit, Y, L, model_mu: bool = False, random_clones: bool = False, rng=None):
    """Mean squared error of the fit's predicted expression
    (reference R/clonealign.R:415-434; unexported and uncalled there, kept
    for parity). ``random_clones`` replaces assignments with uniform draws
    from the distinct assigned clones as a baseline."""
    if _is_scipy_sparse(Y):
        Y = Y.toarray()
    Y = np.asarray(Y, np.float64)
    L = np.asarray(L, np.float64)
    clones = list(fit.clone)
    if random_clones:
        rng = np.random.default_rng() if rng is None else rng
        distinct = sorted(set(clones))
        clones = list(rng.choice(distinct, Y.shape[0], replace=True))

    col_idx = {str(c): i for i, c in enumerate(fit.clone_names)}
    # reference indexes L[, clones] directly; unassigned cells would error
    # there too — require callers to re-threshold first
    idx = np.asarray([col_idx[str(c)] for c in clones])
    predicted = L[:, idx]  # (G, N)
    if model_mu:
        predicted = np.asarray(fit.ml_params["mu"])[:, None] * predicted
    normalizer = Y.sum(axis=1) / predicted.sum(axis=0)
    predicted = predicted.T * normalizer[:, None]
    return float(np.mean((predicted - Y) ** 2))


def _clone_sums_program(Y, idx, C: int):
    # float64-resident data (CPU x64 oracle fits) keeps float64 sums —
    # bit-comparable to the host path; everything else accumulates f32
    import jax
    import jax.numpy as jnp

    acc = jnp.promote_types(Y.dtype, jnp.float32)
    keep = (idx >= 0).astype(acc)
    onehot = jax.nn.one_hot(idx, C, dtype=acc) * keep[:, None]
    Yf = Y.astype(acc)
    S = jax.lax.dot_general(
        onehot, Yf, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )  # (C, G)
    sum_y2 = jax.lax.dot_general(
        keep, Yf * Yf, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )  # (G,)
    return S, sum_y2


_clone_sums_jit = None


def _clone_sums_device(Y_dev, idx_full, C):
    """Sufficient statistics for :func:`compute_correlations` computed on the
    accelerator instead of a host pass over N x G: per-(clone, gene) sums S
    are ONE (C, N) x (N, G) matmul (HIGHEST precision), per-gene
    sum(y) falls out of S, and sum(y^2) is one masked column reduction.
    The host pass this replaces reads all of N x G; the device version
    fetches (C+2) x G. f32 accumulation bounds the relative error of each sum
    near ~n*2^-24 — far below what a sign/quartile QC diagnostic
    (reference R/clonealign.R:296-300) can sense (the one place it can't —
    a near-constant gene whose variance cancels in f32 — is recomputed on
    the host by compute_correlations); equivalence vs the f64 host path is
    asserted in tests/test_assign.py."""
    import jax
    import jax.numpy as jnp

    # module-level jit: jax caches by function identity, so a per-call
    # closure would retrace/recompile this program on EVERY invocation
    # (run_clonealign calls it once per restart for multirun correlations)
    global _clone_sums_jit
    if _clone_sums_jit is None:
        _clone_sums_jit = jax.jit(
            _clone_sums_program, static_argnames=("C",)
        )

    S, sum_y2 = _clone_sums_jit(Y_dev, jnp.asarray(idx_full, jnp.int32), C=C)
    # np.array (not asarray): float64-resident fetches can otherwise alias a
    # read-only buffer, and the caller patches suspect genes in place
    S = np.array(S, np.float64)
    return S, S.sum(axis=0), np.array(sum_y2, np.float64)


_calls_jit = None


def multirun_calls_device(gamma_logits, threshold):
    """Threshold-argmax clone calls for EVERY restart lane in one device
    program: softmax -> (argmax, max) -> threshold (NaN rows read
    unassigned, same guard as :func:`clone_assignment`), plus per-lane
    per-label counts. Used by ``run_clonealign``'s multirun_info loop
    (restarts.py); replaces a host pass that fetched the full
    (R, N, C) softmax (36 MB at 100k x 5k x 10) and ran a host
    argmax/unique with a (R, N) int32 fetch. Numerically identical to the host path: the same
    device-computed float32 softmax feeds an elementwise argmax/compare
    either way.

    Returns ``(called, counts)`` as numpy arrays: ``called[r, n]`` in
    ``0..C`` with ``C`` meaning unassigned; ``counts[r, label]`` over the
    ``C + 1`` labels.
    """
    import jax
    import jax.numpy as jnp

    global _calls_jit
    if _calls_jit is None:

        def prog(gl, t):
            probs = jax.nn.softmax(gl, axis=-1)
            best = jnp.argmax(probs, axis=-1)
            maxp = jnp.max(probs, axis=-1)
            n_clones = gl.shape[-1]
            # NaN rows (diverged lane): nan >= t is False -> unassigned
            called = jnp.where(maxp >= t, best, n_clones)
            counts = (called[..., None] == jnp.arange(n_clones + 1)).sum(
                axis=-2, dtype=jnp.int32
            )
            return called.astype(jnp.int32), counts

        _calls_jit = jax.jit(prog)

    # compare in the LOGITS dtype, exactly as the host path does (numpy 2
    # weak-scalar promotion casts the python-float threshold to probs.dtype
    # in clone_assignment); a hard-coded f32 cast would diverge from the
    # host compare on float64 fits at borderline probabilities
    gamma_logits = jnp.asarray(gamma_logits)
    called, counts = _calls_jit(
        gamma_logits, jnp.asarray(threshold, gamma_logits.dtype)
    )
    return np.asarray(called), np.asarray(counts)


def compute_correlations(Y, L, clones, clone_names, device_Y=None, clones_idx=None):
    """Per-gene Pearson correlation between expression and the copy number of
    each cell's assigned clone (reference R/clonealign.R:318-334 — which
    z-scores expression first; Pearson is affine-invariant, so correlating
    raw counts is identical, including the NaN for zero-variance genes,
    matching R's ``cor`` returning NA). Unassigned cells are dropped.

    Because each cell's CN series is just its clone's column of L, all sums
    aggregate by clone: the computation is O(C x G) plus one pass over Y —
    and Y may be a scipy sparse matrix (no densification). Pass the
    device-resident count matrix as ``device_Y`` (the fit drivers do) and
    that one pass runs on the accelerator (:func:`_clone_sums_device`)
    instead of the host.

    ``clones_idx`` is the integer form of ``clones`` (values in ``0..C-1``;
    anything else — ``-1`` or ``C`` — reads unassigned). When given,
    ``clones`` is ignored (pass None); the multi-restart driver feeds the
    device-computed calls from :func:`multirun_calls_device` here without
    ever materializing R x N label strings on the host."""
    L = np.asarray(L, np.float64)
    C = len(clone_names)
    if device_Y is not None and str(device_Y.dtype) == "bfloat16":
        # bfloat16 storage is opt-in and LOSSY above 256: the stored counts
        # are rounded, so QC sums from the device matrix could differ from
        # the exact host path. Fall back to the host pass (all integer /
        # f32 storages remain device-side and exact).
        device_Y = None
    if clones_idx is not None:
        idx_all = np.asarray(clones_idx)
        keep = (idx_all >= 0) & (idx_all < C)
        idx_full = np.where(keep, idx_all, -1)
    else:
        clones = np.asarray([str(c) for c in clones], dtype=object)
        keep = clones != UNASSIGNED
        col_idx = {str(c): i for i, c in enumerate(clone_names)}
        idx_full = np.asarray(
            [col_idx[c] if k else -1 for c, k in zip(clones, keep)]
        )
    sparse = _is_scipy_sparse(Y)
    # CSR up front: COO and friends do not support row masking. Dense inputs
    # are NOT masked/copied here — the chunked accumulation below applies the
    # mask per row block, so no N x G float64 temporary is ever allocated
    # (the ingestion path keeps Y at input dtype, e.g. int16).
    if sparse and device_Y is None:
        Y = Y.tocsr()[keep]
    M = int(keep.sum())
    G = Y.shape[1] if device_Y is None else device_Y.shape[1]
    if M < 2:
        return np.full(G, np.nan)

    # per-gene sums of y and y^2, and per-(clone, gene) sums of y
    if device_Y is not None:
        m = np.bincount(idx_full[keep], minlength=C).astype(np.float64)
        S, sum_y, sum_y2 = _clone_sums_device(device_Y, idx_full, C)
        # Cancellation guard: var_y = sum_y2 - sum_y^2/M subtracts two
        # near-equal numbers for a near-constant high-mean gene, amplifying
        # the f32 accumulation error of the device sums far past the ~2^-24
        # relative bound on the sums themselves (a truly constant gene must
        # read var 0 -> NaN, like R's cor). Genes whose variance is a tiny
        # fraction of sum_y2 are recomputed exactly on the host — a column
        # slice, so O(N x k) for the (rare) k suspects, not O(N x G).
        with np.errstate(invalid="ignore"):
            var_pre = sum_y2 - sum_y * sum_y / M
        suspect = np.flatnonzero(
            (sum_y2 > 0) & ~(var_pre > 1e-3 * sum_y2)
        )
        if suspect.size:
            cols = Y[:, suspect]
            cols = cols.toarray() if _is_scipy_sparse(cols) else np.asarray(cols)
            cols = cols.astype(np.float64)[keep]
            ib = idx_full[keep]
            sum_y[suspect] = cols.sum(axis=0)
            sum_y2[suspect] = (cols * cols).sum(axis=0)
            for c in range(C):
                sel = ib == c
                S[c, suspect] = cols[sel].sum(axis=0) if sel.any() else 0.0
    elif sparse:
        idx = idx_full[keep]
        m = np.bincount(idx, minlength=C).astype(np.float64)  # cells per clone
        Y = Y.astype(np.float64)
        sum_y = np.asarray(Y.sum(axis=0)).ravel()
        sum_y2 = np.asarray(Y.multiply(Y).sum(axis=0)).ravel()
        import scipy.sparse as sp

        ind = sp.csr_matrix(
            (np.ones(M), (idx, np.arange(M))), shape=(C, M)
        )
        SY = ind @ Y
        S = np.asarray(SY.todense() if sp.issparse(SY) else SY)
    else:
        m = np.bincount(idx_full[keep], minlength=C).astype(np.float64)
        sum_y = np.zeros(G)
        sum_y2 = np.zeros(G)
        S = np.zeros((C, G))
        rows = _host_row_chunk(G)
        N = Y.shape[0]
        for i in range(0, N, rows):
            blk = np.asarray(Y[i : i + rows], np.float64)
            kb = keep[i : i + rows]
            if not kb.all():
                blk = blk[kb]
            sum_y += blk.sum(axis=0)
            sum_y2 += (blk * blk).sum(axis=0)
            ib = idx_full[i : i + rows][kb]
            # per-clone row-sums; C is small, so a slice-and-sum per clone
            # beats np.add.at's unbuffered element-wise loop by ~10x
            for c in range(C):
                sel = ib == c
                if sel.any():
                    S[c] += blk[sel].sum(axis=0)

    # x_ng = L[g, clone(n)]: sums aggregate over clones
    sum_x = L @ m  # (G,)
    sum_x2 = (L * L) @ m
    cross = np.einsum("cg,gc->g", S, L)

    num = cross - sum_x * sum_y / M
    var_x = sum_x2 - sum_x * sum_x / M
    var_y = sum_y2 - sum_y * sum_y / M
    den = np.sqrt(np.maximum(var_x, 0) * np.maximum(var_y, 0))
    with np.errstate(divide="ignore", invalid="ignore"):
        out = num / den
    out[den == 0] = np.nan
    return out
