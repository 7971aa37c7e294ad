"""Allele-specific (allelic-imbalance) likelihood
(reference R/allele-specific.R:17-58).

Per variant v and cell n, the alternative-allele count alt[v,n] out of
coverage cov[v,n] is beta-binomial distributed. Variants where the clone's
copy number is 2 are balanced — BetaBinomial(2, 2); otherwise imbalanced —
an equal mixture of BetaBinomial(0.1, 1.9) and BetaBinomial(1.9, 0.1).
Summing over variants gives an (N, C) clone log-likelihood added to the
expression term (reference R/inference-tflow.R:302-304).

Accelerator form: the per-variant mixture terms are precomputed once as (V, N)
matrices; the clone selection + variant sum is two (N, V) x (V, C) matmuls
instead of the reference's stacked/transposed (C, V, N) where-reduce
(reference R/allele-specific.R:37-47).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def beta_binomial_log_prob(k, n, alpha, beta):
    """Beta-binomial log-pmf in lgamma form (reference R/allele-specific.R:52-58)."""
    lg = jax.lax.lgamma
    ll = lg(n + 1.0) - lg(k + 1.0) - lg(n - k + 1.0)
    ll = ll + lg(k + alpha) + lg(n - k + beta) - lg(alpha + beta + n)
    ll = ll - lg(jnp.asarray(alpha, k.dtype)) - lg(jnp.asarray(beta, k.dtype)) + lg(
        jnp.asarray(alpha + beta, k.dtype)
    )
    return ll


def construct_ai_likelihood(clone_allele, alt, cov):
    """(N, C) beta-binomial clone log-likelihood.

    Args:
      clone_allele: (V, C) copy number at each variant per clone.
      alt: (V, N) alternative-allele counts.
      cov: (V, N) coverage counts.
    """
    log_half = jnp.log(jnp.asarray(0.5, alt.dtype))
    p1_low = log_half + beta_binomial_log_prob(alt, cov, 0.1, 1.9)
    p1_high = log_half + beta_binomial_log_prob(alt, cov, 1.9, 0.1)
    p1 = jnp.logaddexp(p1_low, p1_high)  # (V, N) imbalanced mixture
    p2 = beta_binomial_log_prob(alt, cov, 2.0, 2.0)  # (V, N) balanced

    is_cn2 = (clone_allele == 2).astype(alt.dtype)  # (V, C)
    # sum over variants, selecting p2 where CN==2 else p1
    return p2.T @ is_cn2 + p1.T @ (1.0 - is_cn2)  # (N, C)


def snv_clone_probs(v_log_prob):
    """Normalized clone probabilities from the SNV likelihood alone
    (reference R/inference-tflow.R:436-440)."""
    return jax.nn.softmax(v_log_prob, axis=1)


def sanitize_allele_info(clone_allele, cov, ref, n_cells, n_clones):
    """Shape checks (reference R/allele-specific.R:61-71): ``cov``/``ref``
    are cell-by-variant as passed by the user."""
    V = clone_allele.shape[0]
    if clone_allele.shape[1] != n_clones:
        raise ValueError(
            f"clone_allele has {clone_allele.shape[1]} clones, expected {n_clones}"
        )
    for name, m in (("cov", cov), ("ref", ref)):
        if m.shape[0] != n_cells:
            raise ValueError(f"{name} must have {n_cells} rows (cells), got {m.shape[0]}")
        if m.shape[1] != V:
            raise ValueError(f"{name} must have {V} columns (variants), got {m.shape[1]}")
        if (np.asarray(m) < 0).any():
            raise ValueError(f"{name} must be non-negative counts")
    # alt = cov - ref must be non-negative; ref > cov means the ref/cov slots
    # were swapped (or alt counts were passed as ref) and would silently
    # corrupt the beta-binomial log-likelihood with lgamma of negatives
    if (np.asarray(ref) > np.asarray(cov)).any():
        raise ValueError(
            "ref counts exceed cov at some (cell, variant): cov must be the "
            "TOTAL coverage and ref the reference-allele subset of it"
        )
    return V
