"""Float64 NumPy oracle: a literal transcription of the reference's TF graph
semantics (reference R/inference-tflow.R:276-336), materializing the full
(S, C, N, G) probability tensor exactly as the reference does. Used only in
tests to validate the decomposed device implementation term by term.
"""

import numpy as np

# -- tiny special-function shims so the oracle needs only numpy ------------


def _lgamma(x):
    from math import lgamma as _l

    return np.vectorize(_l)(np.asarray(x, dtype=np.float64))


def _softplus(x):
    x = np.asarray(x, dtype=np.float64)
    return np.logaddexp(0.0, x)


def _log_sigmoid(x):
    x = np.asarray(x, dtype=np.float64)
    return -np.logaddexp(0.0, -x)


def _softmax(x, axis=-1):
    x = np.asarray(x, dtype=np.float64)
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def _log_softmax(x, axis=-1):
    x = np.asarray(x, dtype=np.float64)
    m = x.max(axis=axis, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(axis=axis, keepdims=True))


def _normal_log_prob(x, loc=0.0, scale=1.0):
    z = (np.asarray(x, np.float64) - loc) / scale
    return -0.5 * z * z - np.log(scale) - 0.5 * np.log(2 * np.pi)


def oracle_log_p_y_on_c(Y, L, mu_samples, psi, W, X=None, beta=None):
    """(S, C, N) log-lik via the reference's einsum chain, float64."""
    Y = np.asarray(Y, np.float64)
    L = np.asarray(L, np.float64)
    mu_samples = np.asarray(mu_samples, np.float64)
    N, G = Y.shape
    S = mu_samples.shape[0]
    C = L.shape[1]

    if W is not None and W.shape[1] > 0:
        log_rfe = np.asarray(psi, np.float64) @ np.asarray(W, np.float64).T
        if beta is not None and beta.shape[1] > 0:
            log_rfe = log_rfe + np.asarray(X, np.float64) @ np.asarray(beta, np.float64).T
        rfe = np.exp(log_rfe)
    else:
        rfe = np.ones((N, G))

    # reference R/inference-tflow.R:288-292, literally
    mu_scg = np.einsum("sg,gc->scg", mu_samples, L)
    mu_sgcn = np.einsum("scg,ng->sgcn", mu_scg, rfe)
    norm = 1.0 / mu_sgcn.sum(axis=1)  # (S, C, N)
    mu_sgcn_norm = np.einsum("sgcn,scn->sgcn", mu_sgcn, norm)
    probs_scng = np.transpose(mu_sgcn_norm, (0, 2, 3, 1))  # (S, C, N, G)

    s_tot = Y.sum(axis=1)
    log_binom = _lgamma(s_tot + 1) - _lgamma(Y + 1).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        logp = np.log(probs_scng)
    term = np.where(Y[None, None, :, :] == 0, 0.0, Y[None, None, :, :] * logp)
    return log_binom[None, None, :] + term.sum(axis=3)  # (S, C, N)


def oracle_elbo(
    Y,
    L,
    mu_base,
    qmu_loc,
    qmu_log_scale,
    gamma_logits,
    alpha_unconstr,
    psi=None,
    W=None,
    chi_unconstr=None,
    X=None,
    beta=None,
    extra_log_lik=None,
    fix_alpha=False,
):
    """Full ELBO, float64, following reference R/inference-tflow.R:298-336."""
    mu_samples = _softplus(mu_base)
    S = mu_samples.shape[0]
    C = L.shape[1]

    p_y = oracle_log_p_y_on_c(Y, L, mu_samples, psi, W, X, beta)
    if extra_log_lik is not None:
        p_y = p_y + np.asarray(extra_log_lik, np.float64).T[None, :, :]

    gamma = _softmax(gamma_logits, axis=1)
    log_gamma = _log_softmax(gamma_logits, axis=1)

    E_p_y_on_c = p_y.mean(axis=0)  # (C, N)
    EE_p_y = (gamma * E_p_y_on_c.T).sum()

    if fix_alpha:
        log_alpha = _log_softmax(np.zeros_like(alpha_unconstr))
    else:
        log_alpha = _log_softmax(alpha_unconstr)

    dir_x = np.exp(log_alpha) + 1e-3
    dir_conc = 1.0 / C
    dirichlet_lp = ((dir_conc - 1.0) * np.log(dir_x)).sum() - C * float(_lgamma(dir_conc))

    E_log_p_p = (
        (log_alpha[None, :] * gamma).sum()
        + _normal_log_prob(np.log(mu_samples)).sum() / S
        + dirichlet_lp
    )

    if W is not None and W.shape[1] > 0:
        chi = np.exp(np.asarray(chi_unconstr, np.float64))
        w_scale = np.sqrt(1.0 / chi)
        E_log_p_p += _normal_log_prob(np.asarray(W, np.float64), 0.0, w_scale[None, :]).sum()
        E_log_p_p += (np.log(chi) - chi).sum()  # Gamma(2,1) log-prob
        E_log_p_p += _normal_log_prob(np.asarray(psi, np.float64)).sum()

    scale = np.exp(np.asarray(qmu_log_scale, np.float64))
    qmu_lp = _normal_log_prob(mu_base, np.asarray(qmu_loc, np.float64)[None, :], scale[None, :])
    qmu_lp = qmu_lp - _log_sigmoid(mu_base)
    E_log_q = qmu_lp.mean(axis=0).sum() + np.where(gamma == 0, 0.0, gamma * log_gamma).sum()

    return EE_p_y + E_log_p_p - E_log_q
