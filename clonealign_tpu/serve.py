"""Serving path: assign new cells against an already-fitted model.

The reference can only re-threshold existing assignments
(R/inference-tflow.R:36-46); assigning cells that arrive after the fit means
re-running the whole optimization. Here the fitted gene-level parameters
(mu, clone priors alpha) define a posterior over clones for ANY new cell in
closed form — no optimization:

    log p(z=c | y) ∝ log alpha_c + log Multinomial(y | t, p_c)
    p_c ∝ mu * L[:, c]                       (rfe = 1 for unseen cells)

which reuses the decomposed likelihood: Y_new @ log L − t · log Z(c) up to
per-cell constants. One matmul per batch of cells.

For models fitted with a latent factor (K > 0), rfe = 1 drops the per-cell
``exp(psi_n . W_g)`` modulation. ``latent="refine"`` restores it with a
per-(cell, clone) Laplace approximation: the clone log-likelihood is the
multinomial log-lik at the MAP psi (a damped-Newton solve — the objective is
strictly concave in psi: log Z is convex, the N(0,1) prior quadratic) plus
the Gaussian-curvature correction −½ log|−f''|. All cells, clones, and
Newton iterations batch into dense (N, C[, K]) array ops — no per-cell
Python. Cost: ~``newton_iters``·C (N, G)-sized passes — each Newton
iteration evaluates the softmax moments once per clone (plus 2·C final
curvature/value passes), so size serving batches for C× the plain path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import assign as _assign


@jax.jit
@jax.default_matmul_precision("highest")
def _posterior_log_probs(Y, L, mu, log_alpha):
    """(N_new, C) unnormalized clone log-posteriors for new cells.

    ``Y`` may arrive in a narrow integer dtype (see :func:`assign_cells`) —
    contractions promote to f32 on the fly. Full matmul precision: serving
    batches are transfer-bound over PCIe, so full-precision passes cost
    nothing, and reduced-precision inputs (TF32 on a GPU's tensor cores)
    could flip threshold-boundary calls vs CPU."""
    rates = mu[:, None] * L  # (G, C)
    log_rates = jnp.where(rates > 0, jnp.log(jnp.where(rates > 0, rates, 1.0)), -jnp.inf)
    ylogr = Y @ jnp.where(jnp.isfinite(log_rates), log_rates, 0.0)  # (N, C)
    hits_zero = (Y @ (rates <= 0).astype(jnp.float32)) > 0
    ylogr = jnp.where(hits_zero, -jnp.inf, ylogr)
    t = jnp.sum(Y.astype(jnp.float32), axis=1, keepdims=True)
    log_Z = jnp.log(jnp.sum(rates, axis=0))[None, :]  # (1, C)
    return log_alpha[None, :] + ylogr - t * log_Z


@functools.partial(jax.jit, static_argnames="newton_iters")
@jax.default_matmul_precision("highest")
def _posterior_log_probs_refined(Y, L, mu, log_alpha, W, newton_iters=8):
    """(N_new, C) clone log-posteriors with per-(cell, clone) MAP psi.

    K=1 path (clonealign's universal default, reference R/clonealign.R:226-232
    — both branches set K=1). Per clone c the concave objective is

        f(p) = yW * p − t·log Z_c(p) − p²/2,
        Z_c(p) = Σ_g mu_g L_gc exp(W_g p)

    maximized by damped Newton (f'' = −t·Var_w(W) − 1 ≤ −1, so steps are
    well-scaled); the returned log-lik is the Laplace approximation
    f(p*) − ½ log(−f''(p*)) (clone-independent constants dropped)."""
    Yf = Y.astype(jnp.float32)
    t = jnp.sum(Yf, axis=1)  # (N,)
    yW = Yf @ W[:, :1]  # (N, 1) — K=1
    w = W[:, 0]  # (G,)
    rates = mu[:, None] * L  # (G, C)
    C = rates.shape[1]
    N = Yf.shape[0]

    def clone_stats(c, psi_c):
        """Softmax moments of w under p_g ∝ rates_gc exp(w_g psi) plus the
        log-normalizer shift, for ONE clone: the (N, G) workspace exists for
        one clone at a time (lax.map below — a vmap here would batch all
        clones and materialize (C, N, G))."""
        lw = jnp.log(jnp.where(rates[:, c] > 0, rates[:, c], 1.0))
        safe = rates[:, c][None, :] > 0
        logits = jnp.where(safe, lw[None, :] + w[None, :] * psi_c[:, None], -jnp.inf)
        logsumZ = jax.scipy.special.logsumexp(logits, axis=1)  # (N,)
        p = jax.nn.softmax(logits, axis=1)
        Ew = p @ w
        var = jnp.maximum(p @ (w * w) - Ew * Ew, 0.0)
        return Ew, var, logsumZ

    def body(psi, _):
        Ew, var, _ = jax.lax.map(
            lambda c: clone_stats(c, psi[:, c]), jnp.arange(C)
        )  # each (C, N)
        grad = yW - t[:, None] * Ew.T - psi  # (N, C)
        hess = -t[:, None] * var.T - 1.0
        return psi - grad / hess, None

    psi0 = jnp.zeros((N, C), jnp.float32)
    psi, _ = jax.lax.scan(body, psi0, None, length=newton_iters)

    # one final per-clone pass at the converged psi yields BOTH the Laplace
    # curvature and the log-normalizer shift (no redundant recomputation)
    _, var_f, logsum1 = jax.lax.map(
        lambda c: clone_stats(c, psi[:, c]), jnp.arange(C)
    )
    _, _, logsum0 = jax.lax.map(
        lambda c: clone_stats(c, jnp.zeros((N,), jnp.float32)), jnp.arange(C)
    )

    # f(psi*) per (cell, clone), sharing the rfe=1 terms with the plain path
    base = _posterior_log_probs(Y, L, mu, log_alpha)  # includes -t log Z(0)
    # correction: [yW psi - t (log Z_c(psi) - log Z_c(0)) - psi^2/2 - 1/2 log(-f'')]
    dlogZ = (logsum1 - logsum0).T  # (N, C)
    neg_hess = t[:, None] * var_f.T + 1.0
    return (
        base
        + yW * psi
        - t[:, None] * dlogZ
        - 0.5 * psi * psi
        - 0.5 * jnp.log(neg_hess)
    )


def _narrowest_exact(Y_new):
    """Host->device transfer dtype: counts are usually small integers, so
    ship int8/int16 (4x/2x less PCIe traffic than f32) and widen on device;
    fall back to f32 for fractional or large values."""
    if Y_new.size == 0:
        return np.float32
    if np.issubdtype(Y_new.dtype, np.integer):
        mx, mn = Y_new.max(), Y_new.min()
    elif float(np.max(np.abs(Y_new - np.round(Y_new)))) == 0.0:
        mx, mn = Y_new.max(), Y_new.min()
    else:
        return np.float32
    # counts should be non-negative, but assign_cells (unlike setup_fit) does
    # not validate that — never let a corrupt negative value wrap in the cast
    if mn < 0:
        return np.float32
    if mx <= np.iinfo(np.int8).max:
        return np.int8
    if mx <= np.iinfo(np.int16).max:
        return np.int16
    return np.float32


def assign_cells(
    fit,
    Y_new,
    copy_number_data=None,
    clone_call_probability: float = 0.95,
    saturate: bool = True,
    saturation_threshold: float = 6,
    latent: str = "auto",
    newton_iters: int = 8,
):
    """Assign new cells to clones using a fitted model's parameters.

    Args:
      fit: a :class:`~clonealign_tpu.fit.ClonealignFit` (from ``clonealign``
        or ``run_clonealign``).
      Y_new: (N_new, G') raw counts over the fit's ``retained_genes`` (same
        order). Subset your expression matrix to those genes first.
      copy_number_data: the (G', C) copy numbers used in the fit (saturated
        values are re-derived if you pass the raw matrix with the default
        threshold). Required because the fit object stores parameters, not
        the data.
      clone_call_probability: threshold for the "unassigned" fallback.
      saturate / saturation_threshold: MUST match the settings the model was
        fitted with (defaults mirror the fit API's defaults) so serving
        scores against the same saturated L the fit saw.
      latent: how to treat the fitted latent factor for unseen cells.
        ``"ignore"`` sets rfe = 1 (exact for K=0 fits). ``"refine"``
        estimates each new cell's psi per clone by a Laplace approximation
        (module docstring) — requires a K=1 fit. ``"auto"`` (default)
        refines when the fit has a K=1 latent space, else ignores.
      newton_iters: Newton steps for the psi solve (``latent="refine"``).

    Returns:
      (clones, clone_probs): list of labels and the (N_new, C) posterior.
    """
    from .api import _parse_copy_number
    from .utils.sparsity import is_scipy_sparse as _is_sparse

    sparse = _is_sparse(Y_new)
    if sparse:
        # canonicalize FIRST: COO (and non-canonical CSR) may hold duplicate
        # entries that sum on conversion — the wire dtype must be chosen
        # from the summed values or a true count of e.g. 200 stored as two
        # 100-entries would pick int8 and wrap to -56 in the downcast
        Y_new = Y_new.tocsr()
        Y_new.sum_duplicates()
    else:
        Y_new = np.asarray(Y_new)
    G = len(fit.ml_params["mu"])
    if Y_new.ndim != 2 or Y_new.shape[1] != G:
        raise ValueError(
            f"Y_new must be (n_cells, {G}) over the fit's retained_genes; got "
            f"{Y_new.shape}"
        )
    if copy_number_data is None:
        raise ValueError("copy_number_data (genes x clones, over retained_genes) is required")
    L, _names = _parse_copy_number(copy_number_data, G)
    if saturate:
        L = np.minimum(L, float(saturation_threshold))

    if latent not in ("auto", "ignore", "refine"):
        raise ValueError(f"latent must be 'auto', 'ignore', or 'refine', got {latent!r}")
    W = fit.ml_params.get("W")
    K = 0 if W is None else np.asarray(W).shape[1]
    if latent == "refine" and K != 1:
        raise ValueError(
            f"latent='refine' requires a K=1 fit (this fit has K={K}); "
            "use latent='ignore'"
        )
    refine = (latent == "refine") or (latent == "auto" and K == 1)

    mu = jnp.asarray(fit.ml_params["mu"], jnp.float32)
    alpha = np.asarray(fit.ml_params["alpha"], np.float64)
    log_alpha = jnp.asarray(np.log(alpha / alpha.sum()), jnp.float32)

    if sparse:
        # device needs it dense (the posterior is two matmuls); assemble the
        # dense copy directly ON DEVICE in the narrow dtype from row chunks,
        # so the host never holds an N x G densification
        from .utils.sparsity import device_dense_from_sparse_rows

        # Y_new is canonical CSR (duplicates summed above), so .data holds
        # the true stored values; zeros are in-range for any dtype
        store = _narrowest_exact(Y_new.data)
        Yd = device_dense_from_sparse_rows(Y_new, np.dtype(store))
    else:
        Yd = jnp.asarray(Y_new.astype(_narrowest_exact(Y_new)))
    Ld = jnp.asarray(L, jnp.float32)
    if refine:
        lp = _posterior_log_probs_refined(
            Yd, Ld, mu, log_alpha, jnp.asarray(W, jnp.float32),
            newton_iters=int(newton_iters),
        )
    else:
        lp = _posterior_log_probs(Yd, Ld, mu, log_alpha)
    probs = np.asarray(jax.nn.softmax(lp, axis=1))
    clones = _assign.clone_assignment(probs, fit.clone_names, clone_call_probability)
    return clones, probs
