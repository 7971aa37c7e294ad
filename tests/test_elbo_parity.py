"""ELBO parity: the decomposed likelihood/ELBO must match a literal
float64 transcription of the reference graph (tests/oracle.py) term by term.
This is the numerical-parity bar from BASELINE.md (1e-4 relative), tested at
float64 where agreement should be ~1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clonealign_tpu.io.datasets import load_example_sce
from clonealign_tpu.models import multinomial as mm

from oracle import oracle_elbo, oracle_log_p_y_on_c


def _rand_state(N=23, G=17, C=3, K=1, P=0, S=2, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.poisson(3.0, (N, G)).astype(np.float64)
    Y[0] += 1  # ensure no zero-count cells
    L = rng.integers(1, 5, (G, C)).astype(np.float64)
    params = mm.CloneAlignParams(
        W=jnp.asarray(rng.normal(0, 0.3, (G, K))),
        chi_unconstr=jnp.asarray(rng.normal(0, 0.2, (K,))),
        psi=jnp.asarray(rng.normal(0, 1, (N, K))),
        beta=jnp.asarray(rng.normal(0, 0.1, (G, P))),
        alpha_unconstr=jnp.asarray(rng.normal(0, 0.5, (C,))),
        qmu_loc=jnp.asarray(rng.normal(0, 1, (G,))),
        qmu_log_scale=jnp.asarray(rng.normal(0, 0.3, (G,))),
        gamma_logits=jnp.asarray(rng.normal(0, 1, (N, C))),
    )
    X = rng.normal(0, 1, (N, P)) if P else None
    mu_base = rng.normal(0.5, 1.0, (S, G))
    return Y, L, X, params, mu_base


@pytest.mark.parametrize("K,P", [(1, 0), (0, 0), (2, 2)])
def test_log_p_y_on_c_matches_oracle(K, P):
    Y, L, X, params, mu_base = _rand_state(K=K, P=P, seed=K * 10 + P)
    data = mm.prepare_data(Y, L, x=X, dtype=jnp.float64)
    ours = mm.log_p_y_on_c(params, data, jnp.asarray(mu_base))
    ref = oracle_log_p_y_on_c(
        Y, L, np.logaddexp(0, mu_base), np.asarray(params.psi), np.asarray(params.W),
        X, np.asarray(params.beta),
    )
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-9, atol=1e-7)


@pytest.mark.parametrize("K,P,S,fix_alpha", [(1, 0, 1, False), (0, 0, 3, False), (2, 2, 2, True)])
def test_elbo_matches_oracle(K, P, S, fix_alpha):
    Y, L, X, params, mu_base = _rand_state(K=K, P=P, S=S, seed=42 + K)
    data = mm.prepare_data(Y, L, x=X, dtype=jnp.float64)
    config = mm.ModelConfig(K=K, P=P, mc_samples=S, fix_alpha=fix_alpha)

    # Inject the oracle's mu_base draw by monkeypatching the sampler path:
    # call the internal pieces directly with the same base draws.
    mu_b = jnp.asarray(mu_base)

    def elbo_with_fixed_base(params):
        # re-implement elbo()'s body deterministically via its public parts
        import clonealign_tpu.models.multinomial as m

        orig = m.sample_mu_base
        m.sample_mu_base = lambda p, k, s: mu_b
        try:
            val = m.elbo(params, data, jax.random.PRNGKey(0), config)
        finally:
            m.sample_mu_base = orig
        return val

    ours = float(elbo_with_fixed_base(params))
    ref = oracle_elbo(
        Y, L, mu_base,
        np.asarray(params.qmu_loc), np.asarray(params.qmu_log_scale),
        np.asarray(params.gamma_logits), np.asarray(params.alpha_unconstr),
        psi=np.asarray(params.psi), W=np.asarray(params.W),
        chi_unconstr=np.asarray(params.chi_unconstr),
        X=X, beta=np.asarray(params.beta), fix_alpha=fix_alpha,
    )
    np.testing.assert_allclose(ours, ref, rtol=1e-9)


@pytest.mark.slow
def test_elbo_finite_on_example_data():
    sce = load_example_sce()
    keep = sce.counts.sum(axis=0) > 0  # gene filter, threshold 0
    Y = sce.counts[:, keep].astype(np.float64)
    L = np.minimum(sce.copy_number[keep], 6.0)
    key = jax.random.PRNGKey(0)
    params = mm.init_params(Y, L, key, K=1, dtype=jnp.float64)
    data = mm.prepare_data(Y, L, dtype=jnp.float64)
    config = mm.ModelConfig(K=1, mc_samples=1)
    val = mm.elbo(params, data, key, config)
    assert np.isfinite(float(val))


def test_gamma_warm_start_shrink_semantics():
    Y, L, X, params, mu_base = _rand_state()
    data = mm.prepare_data(Y, L, dtype=jnp.float64)
    config = mm.ModelConfig(K=1, mc_samples=1)
    key = jax.random.PRNGKey(1)
    full = mm.gamma_warm_start_logits(params, data, key, config, initial_shrink=5.0)
    off = mm.gamma_warm_start_logits(params, data, key, config, initial_shrink=0.0)
    double = mm.gamma_warm_start_logits(params, data, key, config, initial_shrink=10.0)
    assert np.allclose(np.asarray(off), 0.0)
    np.testing.assert_allclose(np.asarray(double), 2 * np.asarray(full), rtol=1e-12)
    # full-strength logits are normalized log-probs: logsumexp over clones = 0
    lse = jax.scipy.special.logsumexp(full, axis=1)
    np.testing.assert_allclose(np.asarray(lse), 0.0, atol=1e-8)


def _elbo_straightforward(params, data, mu_b, config, extra_log_lik=None):
    """The pre-decomposition ELBO: gamma contracted against the FULL
    per-(clone, cell) log-likelihood from log_p_y_on_c, exactly as the
    reference graph does (reference R/inference-tflow.R:306-336). Used to
    prove elbo()'s constant-cotangent decomposition (its docstring) is an
    identity for both the value and every gradient."""
    S = config.mc_samples
    mu_samples = mm.softplus(mu_b)
    p_y = mm.log_p_y_on_c(params, data, mu_b, extra_log_lik, config)
    gamma = jax.nn.softmax(params.gamma_logits, axis=1)
    log_gamma = jax.nn.log_softmax(params.gamma_logits, axis=1)
    E = jnp.mean(p_y, axis=0)
    EE = jnp.sum(gamma * jnp.where(gamma == 0, 0.0, E.T))
    log_alpha = jax.nn.log_softmax(params.alpha_unconstr)
    C = log_alpha.shape[0]
    dir_x = jnp.exp(log_alpha) + 1e-3
    dir_lp = jnp.sum((1.0 / C - 1.0) * jnp.log(dir_x)) - C * jax.lax.lgamma(
        jnp.asarray(1.0 / C, dir_x.dtype)
    )
    Epp = (
        jnp.sum(log_alpha[None, :] * gamma)
        + jnp.sum(mm._normal_log_prob(jnp.log(mu_samples))) / S
        + dir_lp
    )
    chi = jnp.exp(params.chi_unconstr)
    Epp = Epp + (
        jnp.sum(mm._normal_log_prob(params.W, 0.0, jnp.sqrt(1 / chi)[None, :]))
        + jnp.sum(jnp.log(chi) - chi)
        + jnp.sum(mm._normal_log_prob(params.psi))
    )
    scale = jnp.exp(params.qmu_log_scale)
    qlp = mm._normal_log_prob(
        mu_b, params.qmu_loc[None, :], scale[None, :]
    ) - jax.nn.log_sigmoid(mu_b)
    Eq = jnp.sum(jnp.mean(qlp, axis=0)) + jnp.sum(
        jnp.where(gamma == 0, 0.0, gamma * log_gamma)
    )
    return EE + Epp - Eq


@pytest.mark.parametrize(
    "K,P,S,with_extra", [(1, 0, 2, False), (0, 0, 1, False), (2, 2, 3, False), (1, 0, 1, True)]
)
def test_decomposed_elbo_gradients_match_straightforward_form(K, P, S, with_extra):
    """elbo() pulls the per-cell-constant likelihood terms (log_binom, A1,
    A2 via colsum_Y) out of the gamma contraction. This must be an exact
    identity — softmax rows sum to 1 and per-cell shifts are annihilated by
    the softmax Jacobian — for the value AND all parameter gradients, in
    every configuration (latent dims, covariates, MC samples, and the
    allele-specific extra term, which stays inside the contraction)."""
    Y, L, X, params, mu_base = _rand_state(K=K, P=P, S=S, seed=7 + K + P)
    data = mm.prepare_data(Y, L, x=X, dtype=jnp.float64)
    config = mm.ModelConfig(K=K, P=P, mc_samples=S)
    mu_b = jnp.asarray(mu_base)
    extra = None
    if with_extra:
        rng = np.random.default_rng(99)
        extra = jnp.asarray(rng.normal(-3, 1, (Y.shape[0], L.shape[1])))

    import clonealign_tpu.models.multinomial as m

    orig = m.sample_mu_base
    m.sample_mu_base = lambda p, k, s: mu_b
    try:
        v_new, g_new = jax.value_and_grad(
            lambda p: mm.elbo(p, data, jax.random.PRNGKey(0), config, extra)
        )(params)
    finally:
        m.sample_mu_base = orig
    v_ref, g_ref = jax.value_and_grad(
        lambda p: _elbo_straightforward(p, data, mu_b, config, extra)
    )(params)

    np.testing.assert_allclose(float(v_new), float(v_ref), rtol=1e-12)
    for name in params._fields:
        a, b = getattr(g_new, name), getattr(g_ref, name)
        if a.size == 0:
            continue
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-11,
            err_msg=f"gradient mismatch for {name}",
        )


def test_elbo_colsum_fallback_matches_precomputed():
    """A hand-built ModelData without colsum_Y must evaluate identically
    (elbo() computes the column sums on the fly)."""
    Y, L, X, params, mu_base = _rand_state(K=1, P=0, S=1, seed=11)
    data = mm.prepare_data(Y, L, dtype=jnp.float64)
    assert data.colsum_Y is not None
    data_nocs = data._replace(colsum_Y=None)
    config = mm.ModelConfig(K=1, P=0, mc_samples=1)
    key = jax.random.PRNGKey(3)
    a = float(mm.elbo(params, data, key, config))
    b = float(mm.elbo(params, data_nocs, key, config))
    np.testing.assert_allclose(a, b, rtol=1e-12)
