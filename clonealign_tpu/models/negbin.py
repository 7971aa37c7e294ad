"""Legacy v1 model family: the negative-binomial dosage-mixture.

clonealign v1 assigned cells to clones under a negative-binomial likelihood
with a per-gene *dosage indicator* rho_g deciding whether gene g's expression
follows the clone copy-number profile:

    y_ng ~ NB(mean = s_n * ((1 - rho_g) mu_g + rho_g beta_g Lp[g, pi_n]),
              size = phi_g)

Provenance: the reference deleted the v1 inference code in v2 but kept the
driver script — reference inst/create_model3_synthetic.R:3-29 is the
generative spec, :45-52 shows the Gibbs E-step (`gibbs_pi_rho`) with clone /
rho probabilities read off the sample traces (`clone_probs_from_gibbs`,
`rho_probs_from_gibbs`), :62-79 the per-gene L-BFGS M-step over
(mu, beta, phi) with a `lambda` penalty and `l_g_hat = rowMeans(Lp)`, and
:104-105 the full MC-EM driver `inference_em(Y, Lp, rel_tol, max_iter,
lambda, rho_init)`. SURVEY.md §2.2 item 14 records the functions as dead
references; this module rebuilds the family rather than the (unavailable)
line-level behavior.

Accelerator-first design, mapped from those semantics:

- The Gibbs sweep over (pi_n, rho_g) becomes a *structured mean-field*
  E-step q(pi, rho) = prod_n q(pi_n) prod_g q(rho_g) with closed-form CAVI
  updates — deterministic, fully jittable, and exact where Gibbs only
  approximates by sampling. Clone/rho probabilities are the variational
  marginals themselves (the analog of trace frequencies).
- The per-gene L-BFGS M-step becomes batched Adam steps on ALL genes
  jointly in unconstrained space (log mu, log beta, log phi) — one (G,)-wide
  vectorized update instead of G serial optimizers (a generalized-EM
  M-step: each iteration improves, rather than maximizes, the bound).
- The `lambda` identifiability penalty keeps the two rates comparable where
  the data cannot separate them (a gene with q(rho_g)=0 carries no signal
  about beta_g, and vice versa): -lambda * (mu_g - beta_g * l_g_hat)^2,
  matching the script's call signature (lambda, l_g_hat).
- The (N, G, C) clone-conditional likelihood tensor is never materialized:
  every E-step quantity is accumulated per clone over (N, G) blocks with
  `lax.scan` (C is small), exactly like the v2 engine's gene-blocked
  normalizer.

The whole fit (init -> CAVI/Adam loop -> convergence) is one jitted program
with a sliding-window relative-change stop on the ELBO, mirroring the v2
loop semantics (reference R/inference-tflow.R:404-416).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from jax.scipy.special import gammaln


class NegbinData(NamedTuple):
    Y: jax.Array       # (N, G) counts
    Lp: jax.Array      # (G, C) per-clone mean-normalized copy number
    s: jax.Array       # (N,) size factors
    l_hat: jax.Array   # (G,) rowMeans(Lp) — the script's l_g_hat


class NegbinParams(NamedTuple):
    log_mu: jax.Array       # (G,)
    log_beta: jax.Array     # (G,)
    log_phi: jax.Array      # (G,)
    alpha_logits: jax.Array  # (C,) clone prior (closed-form M-step)


class NegbinPosterior(NamedTuple):
    gamma: jax.Array    # (N, C) q(pi_n = c)
    r: jax.Array        # (G,)   q(rho_g = 1)


def nb_log_prob(y, mean, phi):
    """Negative-binomial log-pmf in (mean, size) parametrization — the form
    R's ``rnbinom(mu=, size=)`` draws from (reference
    inst/create_model3_synthetic.R:27)."""
    log_mp = jnp.log(phi + mean)
    return (
        gammaln(y + phi) - gammaln(phi) - gammaln(y + 1.0)
        + phi * (jnp.log(phi) - log_mp)
        + y * (jnp.log(mean) - log_mp)
    )


def _llk0(params: NegbinParams, data: NegbinData):
    """(N, G) log NB(y | s_n mu_g, phi_g) — the rho=0 branch (no clone dep)."""
    mu = jnp.exp(params.log_mu)
    phi = jnp.exp(params.log_phi)
    return nb_log_prob(data.Y, data.s[:, None] * mu[None, :], phi[None, :])


class _NBConsts(NamedTuple):
    """Parameter-independent reductions of Y, computed once per fit."""
    lgamma_y1_sum: jax.Array   # sum_ng lgamma(y + 1)


def _nb_constants(data: NegbinData) -> _NBConsts:
    return _NBConsts(lgamma_y1_sum=jnp.sum(gammaln(data.Y + 1.0)))


def _accumulate(params: NegbinParams, data: NegbinData, gene_w, cell_w):
    """Single clone-scan computing both E-step accumulators without an
    (N, G, C) intermediate:

      A[n, c] = sum_g gene_w[g] * D_c[n, g]    (gamma update, gene_w = r)
      B[g]    = sum_c cell_w[n, c]-weighted column sums of D_c
                                               (r update, cell_w = gamma)

    with D_c = llk1_c - llk0. Every gammaln in the two NB log-pmfs cancels
    in that difference, leaving

      D_c = (y + phi) * log((phi + m0) / (phi + m1_c)) + y * q_c,
      q_c[g] = log(beta_g Lp[g,c]) - log mu_g          (cell-independent),

    so the clone scan pays exactly one transcendental — log(phi + m1_c) —
    per element per clone instead of 2 gammaln + 2 log. D_c is assembled
    ELEMENTWISE (q_c broadcast into the fused expression, not hoisted into
    a separate Y @ (w*q) matmul): near the optimum the two parts cancel to
    small residuals per element, and keeping the cancellation inside the
    fusion keeps both the f32 forward values and the autodiff cotangents
    (y - (y+phi) m_c/(phi+m_c), netted per element) at residual scale
    instead of big-sum-minus-big-sum scale. It also keeps the only dots
    (N,G)-by-vector matvecs, which XLA runs at full f32.
    """
    beta = jnp.exp(params.log_beta)
    phi = jnp.exp(params.log_phi)
    C = data.Lp.shape[1]

    m0 = data.s[:, None] * jnp.exp(params.log_mu)[None, :]
    log_pm0 = jnp.log(phi[None, :] + m0)
    Yp = data.Y + phi[None, :]
    q = (params.log_beta[:, None] + jnp.log(data.Lp)
         - params.log_mu[:, None])                # (G, C)

    def one_clone(B, c):
        log_pm1 = jnp.log(
            phi[None, :] + data.s[:, None] * (beta * data.Lp[:, c])[None, :]
        )
        D_c = Yp * (log_pm0 - log_pm1) + data.Y * q[:, c][None, :]
        A_col = D_c @ gene_w                      # (N,)
        B = B + cell_w[:, c] @ D_c                # (G,)
        return B, A_col

    B0 = jnp.zeros(data.Lp.shape[0], data.Y.dtype)
    B, A_cols = jax.lax.scan(one_clone, B0, jnp.arange(C))
    return A_cols.T, B                            # (N, C), (G,)


def _llk0_sum(params: NegbinParams, data: NegbinData, consts: _NBConsts):
    """sum_ng log NB(y | s_n mu_g, phi_g) with the y-independent gammalns
    reduced out: gammaln(phi) is a per-gene sum and gammaln(y+1) a
    precomputed constant, so only one gammaln — gammaln(y+phi), which the
    phi gradient genuinely needs — survives per element. The y*log(m0)
    term stays ELEMENTWISE (log m0 = log s + log mu by broadcast add, no
    transcendental) so the log_mu cotangent nets y - (y+phi) m0/(phi+m0)
    per element instead of colsum(Y) minus a separately-summed sigma term
    (big-minus-big is f32 gradient noise; see _accumulate's docstring)."""
    phi = jnp.exp(params.log_phi)
    m0 = data.s[:, None] * jnp.exp(params.log_mu)[None, :]
    log_m0 = jnp.log(data.s)[:, None] + params.log_mu[None, :]
    Yp = data.Y + phi[None, :]
    N = data.Y.shape[0]
    core = gammaln(Yp) - Yp * jnp.log(phi[None, :] + m0) + data.Y * log_m0
    return (
        jnp.sum(core)
        - N * jnp.sum(gammaln(phi))
        - consts.lgamma_y1_sum
        + N * jnp.sum(phi * params.log_phi)
    )


@jax.jit
def _accumulate_A(params: NegbinParams, data: NegbinData, gene_w):
    """The A accumulator alone (serving path: no r update, so no B pass).
    Module-level jit: re-wrapping _accumulate per call would retrace and
    recompile on every serving batch."""
    beta = jnp.exp(params.log_beta)
    phi = jnp.exp(params.log_phi)
    C = data.Lp.shape[1]
    m0 = data.s[:, None] * jnp.exp(params.log_mu)[None, :]
    log_pm0 = jnp.log(phi[None, :] + m0)
    Yp = data.Y + phi[None, :]
    q = (params.log_beta[:, None] + jnp.log(data.Lp)
         - params.log_mu[:, None])

    def one_clone(_, c):
        log_pm1 = jnp.log(
            phi[None, :] + data.s[:, None] * (beta * data.Lp[:, c])[None, :]
        )
        D_c = Yp * (log_pm0 - log_pm1) + data.Y * q[:, c][None, :]
        return 0, D_c @ gene_w

    _, A_cols = jax.lax.scan(one_clone, 0, jnp.arange(C))
    return A_cols.T                               # (N, C)


def _llk0_netted_sum(params: NegbinParams, data: NegbinData):
    """sum_ng log NB(y | s_n mu_g, phi_g) with every term netted INSIDE one
    fused elementwise expression before the single reduction. ~2 gammaln
    per element more expensive than _llk0_sum, but its f32 value noise is
    at small-element scale — _llk0_sum assembles the total from separately
    reduced ~1e9-magnitude pieces (sum gammaln(Yp), N*sum gammaln(phi), ...)
    whose f32 ulps (~hundreds) put a noise floor near rel_tol * |ELBO| at
    100k x 2k scale, so the convergence monitor never fires. Use THIS form
    for the monitored ELBO (once per iteration); the Adam loss keeps the
    cheap form — it only consumes gradients, whose dominant cotangents net
    per element either way (measured equal, tests/gradnoise probe r3)."""
    phi = jnp.exp(params.log_phi)[None, :]
    m0 = data.s[:, None] * jnp.exp(params.log_mu)[None, :]
    log_m0 = jnp.log(data.s)[:, None] + params.log_mu[None, :]
    Yp = data.Y + phi
    core = (
        gammaln(Yp) - gammaln(phi) - gammaln(data.Y + 1.0)
        + phi * params.log_phi[None, :]
        - Yp * jnp.log(phi + m0)
        + data.Y * log_m0
    )
    return jnp.sum(core)


def _expected_llk(params: NegbinParams, data: NegbinData,
                  post: NegbinPosterior, consts: Optional[_NBConsts] = None):
    """E_q[log p(Y | pi, rho, params)] — the M-step objective's data term.

    = sum_ng (1 - r_g) llk0_ng + sum_c sum_ng gamma_nc r_g llk1_c[n, g]
    = sum_ng llk0_ng + sum_g r_g * B_g   with B from the gamma-weighted scan.
    """
    if consts is None:
        consts = _nb_constants(data)
    _, B = _accumulate(params, data, post.r, post.gamma)
    return _llk0_sum(params, data, consts) + jnp.dot(post.r, B)


def _mstep_objective(params: NegbinParams, data: NegbinData,
                     post: NegbinPosterior, lam,
                     consts: Optional[_NBConsts] = None):
    """Penalized expected log-likelihood (per-gene L-BFGS analog,
    reference inst/create_model3_synthetic.R:62-75)."""
    mu = jnp.exp(params.log_mu)
    beta = jnp.exp(params.log_beta)
    penalty = lam * jnp.sum((mu - beta * data.l_hat) ** 2)
    return _expected_llk(params, data, post, consts) - penalty


def _elbo(params: NegbinParams, data: NegbinData, post: NegbinPosterior,
          lam, rho_prior):
    """Mean-field ELBO: E[log p(Y, pi, rho)] + H(q) - penalty. The loop's
    convergence monitor (the v1 script's `rel_tol`)."""
    _, B = _accumulate(params, data, post.r, post.gamma)
    return _elbo_with_B(params, data, post, B, lam, rho_prior)


def _elbo_with_B(params: NegbinParams, data: NegbinData,
                 post: NegbinPosterior, B, lam, rho_prior):
    """ELBO assembled from a precomputed gamma-weighted B pass (the E-step
    already has one in hand). Uses the NETTED llk0 sum — the convergence
    monitor must resolve rel_tol-sized changes in f32 (see
    _llk0_netted_sum) — so this is the single authoritative assembly for
    monitored ELBO values."""
    penalty = lam * jnp.sum(
        (jnp.exp(params.log_mu) - jnp.exp(params.log_beta) * data.l_hat) ** 2
    )
    return (
        _llk0_netted_sum(params, data) + jnp.dot(post.r, B) - penalty
        + _elbo_extras(params, data, post, rho_prior)
    )


def _elbo_extras(params: NegbinParams, data: NegbinData,
                 post: NegbinPosterior, rho_prior):
    """The ELBO minus the penalized expected log-likelihood: clone/dosage
    priors plus the mean-field entropies (no Y-sized work)."""
    log_alpha = jax.nn.log_softmax(params.alpha_logits)
    gamma, r = post.gamma, post.r
    eps_entropy = jnp.where(gamma > 0, gamma * jnp.log(jnp.clip(gamma, 1e-30)), 0.0)
    h_gamma = -jnp.sum(eps_entropy)
    h_r = -jnp.sum(
        jnp.where(r > 0, r * jnp.log(jnp.clip(r, 1e-30)), 0.0)
        + jnp.where(r < 1, (1 - r) * jnp.log(jnp.clip(1 - r, 1e-30)), 0.0)
    )
    prior_pi = jnp.sum(gamma @ log_alpha)
    prior_rho = jnp.sum(
        r * jnp.log(rho_prior) + (1 - r) * jnp.log1p(-rho_prior)
    )
    return prior_pi + prior_rho + h_gamma + h_r


# --- Chebyshev sufficient-statistics fast path ------------------------------
#
# Every cell-indexed quantity the VEM touches depends on cell n only through
# (y_ng, s_n): the log-likelihood pieces are, per gene (and clone), smooth
# 1-D functions of t_n = log s_n multiplied by either y_ng or 1. Expanding
# those functions in a degree-D Chebyshev series over [min t, max t] (the
# z_cheb normalizer trick, models/multinomial._compute_logZ_cheb) turns every
# cell sum into a contraction against PARAMETER-INDEPENDENT sufficient
# statistics:
#
#     sum_n y_ng f_g(t_n)  ~=  sum_d coef_gd(params) * YT_gd,
#     YT = Y^T @ T,  T[n, d] = T_d(x_n)   (computed ONCE per fit),
#
# and, for the gamma-weighted E-step accumulator B, against per-iteration
# stats YGT = Y^T @ (gamma (x) T) and GT = gamma^T @ T (posterior-dependent
# but parameter-independent — gamma is FIXED during the M-step). The one term
# not of this form, sum_n gammaln(y_ng + phi_g), depends on y alone: counts
# are integers, so it collapses onto a per-gene value histogram,
# sum_v hist_vg gammaln(v + phi_g).
#
# Consequence: the whole M-step objective (and its gradient) costs
# O(G * (V + C*D)) per inner Adam step — INDEPENDENT of the cell count — so
# the inner optimization that dominated the exact path (one O(N*G*C) clone
# scan per Adam step) becomes effectively free, and each EM iteration reads
# Y exactly twice (the E-step A matmul and the YGT stats matmul).
#
# f32 noise structure (why this matches the exact path's netting, see
# _accumulate's docstring): the functions expanded are the NETTED per-element
# coefficient functions — the y-coefficient of the clone difference is
# q_c + log(phi+m0) - log(phi+m1c), whose values are already at residual
# scale near the optimum — so the netting happens in the scalar node values
# BEFORE any big reduction, and the parameter-gradients flow through the
# node table (d/dlog_mu of the llk0 y-coefficient evaluates 1 - sigma at the
# nodes: no big-minus-big cancellation ever materializes at stats scale).
#
# All Y-carrying matmuls are pinned to full precision: reduced-precision
# matmul inputs were measured to cost real accuracy on this family (clone
# accuracy 1.0 -> 0.88, NEWS 0.3.0), and these thin contractions are bound
# by reading Y, so HIGHEST costs nothing (the same reasoning as the v2
# A-group pin, models/multinomial.py).


class NegbinChebStats(NamedTuple):
    """Per-fit sufficient statistics for the Chebyshev M-step (param- and
    posterior-independent; one O(N*G) pass each, computed once).

    The gammaln(y + phi) term splits by count value: values below ``V0``
    (almost all ELEMENTS) hit an exact per-gene histogram; the rare large
    values go through a Chebyshev expansion in log y, where gammaln(e^u +
    phi) is entire-function smooth (its nearest singularity sits ~pi away
    in the imaginary direction, so convergence is geometric with a large
    ratio) — ``tailT`` holds the per-gene sums of the tail basis."""
    T: jax.Array         # (N, D+1) Chebyshev basis at the scaled log s
    YT: jax.Array        # (G, D+1) Y^T @ T; YT[:, 0] is colsum(Y)
    sumT: jax.Array      # (D+1,)   column sums of T
    hist: jax.Array      # (V0, G)  per-gene histogram of values < V0
    vals: jax.Array      # (V0,)    0..V0-1
    nodes_t: jax.Array   # (D+1,)   log size factors at the Chebyshev nodes
    theta: jax.Array     # (D+1,)   node angles (for the DCT transform)
    tailT: jax.Array     # (G, Dt+1) sum over {y >= V0} of T_d(scaled log y)
    tail_nodes_u: jax.Array  # (Dt+1,) log-count values at the tail nodes
    tail_theta: jax.Array    # (Dt+1,)


def _cheb_basis(x: jax.Array, degree: int) -> jax.Array:
    """(N, D+1) Chebyshev-Vandermonde columns by the T_j recurrence."""
    cols = [jnp.ones_like(x), x]
    for _ in range(2, degree + 1):
        cols.append(2.0 * x * cols[-1] - cols[-2])
    return jnp.stack(cols[: degree + 1], axis=-1)


def _cheb_transform(fvals: jax.Array, theta: jax.Array) -> jax.Array:
    """Node values (..., D+1) -> Chebyshev coefficients (..., D+1), with the
    mean centered through the transform so the cancellation that produces
    the small high-order coefficients happens on O(spread) values (the
    _compute_logZ_cheb hygiene; full precision for the same reason)."""
    D1 = fvals.shape[-1]
    dt = fvals.dtype
    f0 = jnp.mean(fvals, axis=-1, keepdims=True)
    jj = jnp.arange(D1, dtype=dt)
    M = jnp.cos(jj[:, None] * theta[None, :])           # (D+1, D+1)
    with jax.default_matmul_precision("highest"):
        coef = (2.0 / D1) * jnp.einsum("...k,jk->...j", fvals - f0, M)
    coef = coef.at[..., 0].mul(0.5)
    coef = coef.at[..., 0].add(f0[..., 0])
    return coef


def _angles(degree: int, dtype) -> jax.Array:
    k = jnp.arange(degree + 1, dtype=dtype)
    return jnp.pi * (k + 0.5) / (degree + 1)


@functools.partial(
    jax.jit,
    static_argnames=("degree", "n_vals", "tail_degree", "chunk"),
)
def _cheb_stats_program(data: NegbinData, ymax, *, degree: int, n_vals: int,
                        tail_degree: int, chunk: int = 65_536):
    t = jnp.log(data.s)
    t_min, t_max = jnp.min(t), jnp.max(t)
    mid = 0.5 * (t_min + t_max)
    half = jnp.maximum(0.5 * (t_max - t_min), 1e-6)
    x = (t - mid) / half
    T = _cheb_basis(x, degree)                          # (N, D+1)
    with jax.default_matmul_precision("highest"):
        YT = jnp.einsum("ng,nd->gd", data.Y, T)
    N, G = data.Y.shape
    dt = data.Y.dtype

    # tail range in u = log y over [log V0, log ymax] (inclusive; the scaled
    # coordinate is clipped so ymax itself maps inside [-1, 1])
    u_lo = jnp.log(jnp.asarray(float(n_vals), dt))
    u_hi = jnp.maximum(jnp.log(jnp.maximum(ymax, float(n_vals))), u_lo + 1e-6)
    u_mid = 0.5 * (u_lo + u_hi)
    u_half = jnp.maximum(0.5 * (u_hi - u_lo), 1e-6)

    # one chunked pass over Y: exact value histogram for y < V0 (scatter
    # rows >= V0 are dropped by the clip-to-extra-row trick) + tail basis
    # sums. Chunked so no (N, G)-shaped temp beyond Y itself ever exists
    # (an int32 index copy of a 1M x 2k Y would be 8 GB).
    cols = jnp.arange(G, dtype=jnp.int32)[None, :]
    hist = jnp.zeros((n_vals + 1, G), dt)
    tailT = jnp.zeros((G, tail_degree + 1), dt)
    for lo in range(0, N, chunk):
        Yc = jax.lax.slice_in_dim(data.Y, lo, min(lo + chunk, N), axis=0)
        idx = jnp.minimum(Yc, float(n_vals)).astype(jnp.int32)
        hist = hist.at[idx, cols].add(1.0)
        mask = (Yc >= float(n_vals)).astype(dt)
        xu = jnp.clip((jnp.log(jnp.maximum(Yc, 1.0)) - u_mid) / u_half,
                      -1.0, 1.0)
        b_prev = mask                                  # mask * T_0
        b_cur = mask * xu                              # mask * T_1
        acc = [jnp.sum(b_prev, axis=0), jnp.sum(b_cur, axis=0)]
        for _ in range(2, tail_degree + 1):
            b_prev, b_cur = b_cur, 2.0 * xu * b_cur - b_prev
            acc.append(jnp.sum(b_cur, axis=0))
        tailT = tailT + jnp.stack(acc[: tail_degree + 1], axis=-1)
    hist = hist[:n_vals]

    theta = _angles(degree, dt)
    tail_theta = _angles(tail_degree, dt)
    return NegbinChebStats(
        T=T, YT=YT, sumT=jnp.sum(T, axis=0), hist=hist,
        vals=jnp.arange(n_vals, dtype=dt),
        nodes_t=mid + half * jnp.cos(theta), theta=theta,
        tailT=tailT,
        tail_nodes_u=u_mid + u_half * jnp.cos(tail_theta),
        tail_theta=tail_theta,
    )


def negbin_cheb_stats(data: NegbinData, degree: int = 12,
                      hist_cap: int = 1024,
                      tail_degree: int = 16) -> NegbinChebStats:
    """Build the per-fit sufficient statistics for the Chebyshev VEM path.

    Requires integer counts (the gammaln(y + phi) value-histogram and the
    log-y tail expansion are exact/valid only on integers). ``hist_cap``
    bounds the exact histogram (values below it — almost all elements);
    larger values go through the degree-``tail_degree`` log-y expansion.
    """
    Ymax = float(jnp.max(data.Y))
    if not bool(jnp.all(data.Y == jnp.floor(data.Y))):
        raise ValueError(
            "likelihood_impl='cheb' requires integer counts (the "
            "gammaln(y + phi) histogram is exact only on integers); "
            "use the exact path for non-integer Y"
        )
    n_vals = min(int(Ymax) + 1, int(hist_cap))
    return _cheb_stats_program(
        data, jnp.asarray(Ymax, data.Y.dtype),
        degree=int(degree), n_vals=n_vals, tail_degree=int(tail_degree),
    )


class _NBChebCoeffs(NamedTuple):
    """Chebyshev coefficients of the netted per-element functions of
    x = scaled log s (all parameter-DEPENDENT; rebuilt per evaluation from
    O(G*C*D) node values — tiny next to any Y pass)."""
    g0: jax.Array   # (G, D+1)    y-coeff of llk0:  log m0 - log(phi+m0)
    h0: jax.Array   # (G, D+1)    1-coeff of llk0:  -phi * log(phi+m0)
    yc: jax.Array   # (G, C, D+1) y-coeff of D_c:   q_c + u_c
    oc: jax.Array   # (G, C, D+1) 1-coeff of D_c:   phi * u_c


def _netted_cheb_coeffs(params: NegbinParams, data: NegbinData,
                        stats: NegbinChebStats) -> _NBChebCoeffs:
    phi = jnp.exp(params.log_phi)                       # (G,)
    s_nodes = jnp.exp(stats.nodes_t)                    # (D+1,)
    m0 = jnp.exp(params.log_mu)[:, None] * s_nodes[None, :]   # (G, D+1)
    logpm0 = jnp.log(phi[:, None] + m0)
    g0 = params.log_mu[:, None] + stats.nodes_t[None, :] - logpm0
    h0 = -phi[:, None] * logpm0
    k1 = jnp.exp(params.log_beta)[:, None] * data.Lp    # (G, C)
    logpm1 = jnp.log(
        phi[:, None, None] + k1[:, :, None] * s_nodes[None, None, :]
    )                                                   # (G, C, D+1)
    u = logpm0[:, None, :] - logpm1
    q = (params.log_beta[:, None] + jnp.log(data.Lp)
         - params.log_mu[:, None])                      # (G, C)
    return _NBChebCoeffs(
        g0=_cheb_transform(g0, stats.theta),
        h0=_cheb_transform(h0, stats.theta),
        yc=_cheb_transform(q[:, :, None] + u, stats.theta),
        oc=_cheb_transform(phi[:, None, None] * u, stats.theta),
    )


class _NBGammaStats(NamedTuple):
    """Per-E-step statistics (posterior-dependent, parameter-independent —
    gamma is fixed through the following M-step's inner Adam loop)."""
    YGT: jax.Array  # (G, C, D+1) sum_n y_ng gamma_nc T_d(x_n)
    GT: jax.Array   # (C, D+1)    sum_n gamma_nc T_d(x_n)


def _gamma_stats(data: NegbinData, stats: NegbinChebStats,
                 gamma: jax.Array) -> _NBGammaStats:
    N = data.Y.shape[0]
    C = gamma.shape[1]
    D1 = stats.T.shape[1]
    U = (gamma[:, :, None] * stats.T[:, None, :]).reshape(N, C * D1)
    with jax.default_matmul_precision("highest"):
        YGT = jnp.einsum("ng,nk->gk", data.Y, U).reshape(-1, C, D1)
        GT = jnp.einsum("nc,nd->cd", gamma, stats.T)
    return _NBGammaStats(YGT=YGT, GT=GT)


def _B_from_stats(coeffs: _NBChebCoeffs, ps: _NBGammaStats) -> jax.Array:
    """B_g = sum_nc gamma_nc D_c[n, g], assembled from stats (no Y pass)."""
    return (jnp.einsum("gcd,gcd->g", coeffs.yc, ps.YGT)
            + jnp.einsum("gcd,cd->g", coeffs.oc, ps.GT))


def _llk0_sum_cheb(params: NegbinParams, stats: NegbinChebStats,
                   coeffs: _NBChebCoeffs, consts: _NBConsts, N):
    phi = jnp.exp(params.log_phi)
    hist_term = jnp.sum(
        stats.hist * gammaln(stats.vals[:, None] + phi[None, :])
    )
    # tail of gammaln(y + phi): per-gene Chebyshev in log y contracted
    # against the precomputed tail basis sums (exactly zero tail elements
    # -> tailT is all zeros and this term vanishes identically)
    tail_nodes = gammaln(
        jnp.exp(stats.tail_nodes_u)[None, :] + phi[:, None]
    )                                                   # (G, Dt+1)
    tail_term = jnp.sum(
        _cheb_transform(tail_nodes, stats.tail_theta) * stats.tailT
    )
    return (
        hist_term + tail_term
        - N * jnp.sum(gammaln(phi))
        - consts.lgamma_y1_sum
        + N * jnp.sum(phi * params.log_phi)
        + jnp.sum(coeffs.g0 * stats.YT)
        + jnp.dot(jnp.sum(coeffs.h0, axis=0), stats.sumT)
    )


def _estep_A_cheb(data: NegbinData, stats: NegbinChebStats,
                  coeffs: _NBChebCoeffs, gene_w: jax.Array) -> jax.Array:
    """A[n, c] = sum_g gene_w_g D_c[n, g] via ONE thin (N,G)x(G,C(D+1))
    matmul + a Chebyshev contraction per cell (replaces the exact path's
    O(N*G*C) log-heavy clone scan; one Y read total)."""
    G, C, D1 = coeffs.yc.shape
    M = (gene_w[:, None, None] * coeffs.yc).reshape(G, C * D1)
    k = jnp.einsum("g,gcd->cd", gene_w, coeffs.oc)      # (C, D+1)
    with jax.default_matmul_precision("highest"):
        YM = (data.Y @ M).reshape(-1, C, D1)            # (N, C, D+1)
        A = jnp.einsum("nd,ncd->nc", stats.T, YM) + stats.T @ k.T
    return A


def _mstep_objective_cheb(params: NegbinParams, data: NegbinData,
                          stats: NegbinChebStats, ps: _NBGammaStats,
                          r: jax.Array, lam, consts: _NBConsts):
    """The penalized expected log-likelihood from sufficient statistics:
    O(G*(V + C*D)) per evaluation — no cell-indexed work at all."""
    coeffs = _netted_cheb_coeffs(params, data, stats)
    mu = jnp.exp(params.log_mu)
    beta = jnp.exp(params.log_beta)
    penalty = lam * jnp.sum((mu - beta * data.l_hat) ** 2)
    N = data.Y.shape[0]
    return (_llk0_sum_cheb(params, stats, coeffs, consts, N)
            + jnp.dot(r, _B_from_stats(coeffs, ps)) - penalty)


def prepare_negbin_data(Y, L, s=None, dtype=jnp.float32,
                        chunk: int = 32_768) -> NegbinData:
    """Normalize L to the script's Lp = L / colMeans(L) (reference
    inst/create_model3_synthetic.R:17) and default size factors to row sums
    (the multiplicative cell scale; mu/beta absorb the global factor).

    ``Y`` may be a scipy CSR/CSC matrix: the totals come from the sparse
    structure and the device copy is assembled from row chunks at the
    target dtype, so peak host memory is O(nnz + chunk x G) — a 1M x 2k
    count matrix never exists densely on the host (same contract as the
    v2 path's ``prepare_data_sparse``)."""
    from ..utils.sparsity import is_scipy_sparse

    L = jnp.asarray(L, dtype)
    if is_scipy_sparse(Y):
        Ysp = Y.tocsr()
        N, G = Ysp.shape
        if L.ndim != 2 or G != L.shape[0]:
            raise ValueError(
                f"Y must be (N, G) and L (G, C) with matching G; got "
                f"{Ysp.shape} and {L.shape}"
            )
        totals = np.asarray(Ysp.sum(axis=1)).ravel()
        if (totals == 0).any():
            raise ValueError("all cells must have nonzero counts")
        from ..utils.sparsity import device_dense_from_sparse_rows

        Yd = device_dense_from_sparse_rows(Ysp, np.dtype(dtype), chunk)
        if s is None:
            s = jnp.asarray(totals / totals.mean(), dtype)
        else:
            s = jnp.asarray(s, dtype)
        Lp = L / jnp.mean(L, axis=0, keepdims=True)
        return NegbinData(Y=Yd, Lp=Lp, s=s, l_hat=jnp.mean(Lp, axis=1))

    Y = jnp.asarray(Y, dtype)
    if Y.ndim != 2 or L.ndim != 2 or Y.shape[1] != L.shape[0]:
        raise ValueError(
            f"Y must be (N, G) and L (G, C) with matching G; got "
            f"{Y.shape} and {L.shape}"
        )
    if jnp.any(jnp.sum(Y, axis=1) == 0):
        raise ValueError("all cells must have nonzero counts")
    Lp = L / jnp.mean(L, axis=0, keepdims=True)
    if s is None:
        # scale so mean(s) = 1: mu then carries the magnitude (identifiable)
        totals = jnp.sum(Y, axis=1)
        s = totals / jnp.mean(totals)
    else:
        s = jnp.asarray(s, dtype)
    return NegbinData(Y=Y, Lp=Lp, s=s, l_hat=jnp.mean(Lp, axis=1))


def init_negbin_params(data: NegbinData, dtype=jnp.float32) -> NegbinParams:
    """Moment init: mu from size-factor-normalized gene means, beta = mu /
    l_hat (so the two branches start indistinguishable, like the script's
    beta <- mu), phi from the NB method of moments (var = m + m^2/phi)."""
    Ynorm = data.Y / data.s[:, None]
    mu0 = jnp.clip(jnp.mean(Ynorm, axis=0), 1e-6)
    m = data.s[:, None] * mu0[None, :]
    resid = (data.Y - m) ** 2 - m
    phi0 = jnp.clip(
        jnp.sum(m**2, axis=0) / jnp.clip(jnp.sum(resid, axis=0), 1e-6),
        0.05, 1e4,
    )
    C = data.Lp.shape[1]
    return NegbinParams(
        log_mu=jnp.log(mu0).astype(dtype),
        log_beta=jnp.log(mu0 / jnp.clip(data.l_hat, 1e-6)).astype(dtype),
        log_phi=jnp.log(phi0).astype(dtype),
        alpha_logits=jnp.zeros((C,), dtype),
    )


class _EMState(NamedTuple):
    params: NegbinParams
    opt_state: tuple
    post: NegbinPosterior
    i: jax.Array
    trace: jax.Array
    window: jax.Array


class NegbinResult(NamedTuple):
    params: NegbinParams
    post: NegbinPosterior
    elbo_trace: jax.Array
    n_iter: jax.Array
    final_elbo: jax.Array
    # Adam moments at exit — lets `resume_from` continue the exact
    # trajectory (needed e.g. where single XLA executions have a wall
    # budget; each chunk stays under it). None on pre-resume results.
    opt_state: Optional[tuple] = None
    # Which backend produced this result: None = exact clone-scan path,
    # int = Chebyshev sufficient-statistics path of that degree. Set by the
    # run_negbin_em wrapper (plain Python int, not a traced leaf) so
    # resume_from can REFUSE a silently-mixed trajectory across impls
    # (advisor r3): the two loops optimize slightly different monitored
    # objectives and carry incompatible Adam-noise structure.
    cheb_degree: Optional[int] = None


class _EMStateCheb(NamedTuple):
    params: NegbinParams
    opt_state: tuple
    post: NegbinPosterior
    pstats: _NBGammaStats
    i: jax.Array
    trace: jax.Array
    window: jax.Array


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "rel_tol", "lam", "rho_prior",
                     "learning_rate", "m_steps", "window_size",
                     "lr_decay_rate", "lr_decay_iters"),
)
def _run_negbin_em_program(
    data: NegbinData,
    rho_init: Optional[jax.Array] = None,
    stats: Optional[NegbinChebStats] = None,
    *,
    max_iter: int = 100,
    rel_tol: float = 1e-6,
    lam: float = 1.0,
    rho_prior: float = 0.5,
    learning_rate: float = 0.05,
    m_steps: int = 5,
    window_size: int = 10,
    lr_decay_rate: float = 0.4,
    lr_decay_iters: int = 100,
    resume_from: Optional[NegbinResult] = None,
) -> NegbinResult:
    """Jitted core of :func:`run_negbin_em` (which validates resume/impl
    compatibility and stamps the backend marker before/after this program).
    """
    import optax

    if lr_decay_rate == 1.0:
        lr = learning_rate
    else:
        # per-Adam-step schedule; its count lives in opt_state, so
        # resume_from continues the decay where the previous chunk left off
        lr = optax.exponential_decay(
            learning_rate,
            transition_steps=m_steps * lr_decay_iters,
            decay_rate=lr_decay_rate,
        )
    opt = optax.adam(lr)
    G, C = data.Lp.shape
    if resume_from is None:
        params = init_negbin_params(data, data.Y.dtype)
        r0 = (jnp.full((G,), 0.5, data.Y.dtype) if rho_init is None
              else jnp.asarray(rho_init, data.Y.dtype))
        gamma0 = jnp.full((data.Y.shape[0], C), 1.0 / C, data.Y.dtype)
        post = NegbinPosterior(gamma=gamma0, r=r0)
        opt_state = opt.init(
            (params.log_mu, params.log_beta, params.log_phi)
        )
    else:
        if rho_init is not None:
            raise ValueError(
                "rho_init conflicts with resume_from (the resumed "
                "posterior already carries r); pass one or the other"
            )
        if resume_from.opt_state is None:
            raise ValueError(
                "resume_from has no optimizer state (result predates "
                "resume support?)"
            )
        params = resume_from.params
        post = resume_from.post
        opt_state = resume_from.opt_state

    logit_prior = jnp.log(rho_prior) - jnp.log1p(-rho_prior)
    consts = _nb_constants(data)

    if stats is None:
        def estep(params, post):
            log_alpha = jax.nn.log_softmax(params.alpha_logits)
            # gamma from current r
            A, _ = _accumulate(params, data, post.r, post.gamma)
            gamma = jax.nn.softmax(log_alpha[None, :] + A, axis=1)
            # r from the NEW gamma (proper CAVI ordering)
            _, B = _accumulate(params, data, post.r, gamma)
            r = jax.nn.sigmoid(logit_prior + B)
            # B is exactly _expected_llk's gamma-weighted scan for the new
            # posterior, so the caller can assemble the ELBO without
            # re-running the clone scan.
            return NegbinPosterior(gamma=gamma, r=r), B

        def elbo_from_B(params, post, B):
            return _elbo_with_B(params, data, post, B, lam, rho_prior)

        def mstep(params, opt_state, post, _pstats=None):
            # closed-form alpha (exact M-step for the clone prior)
            alpha = jnp.clip(jnp.mean(post.gamma, axis=0), 1e-12)
            params = params._replace(alpha_logits=jnp.log(alpha))

            def loss(rates):
                p = params._replace(log_mu=rates[0], log_beta=rates[1],
                                    log_phi=rates[2])
                return -_mstep_objective(p, data, post, lam, consts)

            def one_step(carry, _):
                rates, opt_state = carry
                g = jax.grad(loss)(rates)
                updates, opt_state = opt.update(g, opt_state)
                rates = optax.apply_updates(rates, updates)
                return (rates, opt_state), None

            rates0 = (params.log_mu, params.log_beta, params.log_phi)
            (rates, opt_state), _ = jax.lax.scan(
                one_step, (rates0, opt_state), None, length=m_steps
            )
            return params._replace(log_mu=rates[0], log_beta=rates[1],
                                   log_phi=rates[2]), opt_state

        if resume_from is None:
            post, B0 = estep(params, post)
        else:
            # the previous chunk's last body iteration already ran its
            # E-step; re-running it here would move the posterior off that
            # trajectory. One B pass re-evaluates the ELBO at that state.
            _, B0 = _accumulate(params, data, post.r, post.gamma)
        elbo0 = elbo_from_B(params, post, B0)
        trace = (jnp.full((max_iter + 1,), jnp.nan, data.Y.dtype)
                 .at[0].set(elbo0))
        window = jnp.full((window_size,), 1e3, data.Y.dtype)

        def cond(st: _EMState):
            return ((st.i < max_iter)
                    & (jnp.mean(jnp.abs(st.window)) >= rel_tol))

        def body(st: _EMState):
            params, opt_state = mstep(st.params, st.opt_state, st.post)
            post, B = estep(params, st.post)
            e = elbo_from_B(params, post, B)
            prev = st.trace[st.i]
            rel = (e - prev) / jnp.abs(prev)
            return _EMState(
                params=params, opt_state=opt_state, post=post, i=st.i + 1,
                trace=st.trace.at[st.i + 1].set(e),
                window=jnp.roll(st.window, 1).at[0].set(rel),
            )

        st = jax.lax.while_loop(
            cond, body,
            _EMState(params=params, opt_state=opt_state, post=post,
                     i=jnp.asarray(0), trace=trace, window=window),
        )
        return NegbinResult(
            params=st.params, post=st.post, elbo_trace=st.trace,
            n_iter=st.i, final_elbo=st.trace[st.i],
            opt_state=st.opt_state,
        )

    # --- Chebyshev sufficient-statistics loop --------------------------------
    def elbo_cheb(params, post, B):
        coeffs = _netted_cheb_coeffs(params, data, stats)
        penalty = lam * jnp.sum(
            (jnp.exp(params.log_mu)
             - jnp.exp(params.log_beta) * data.l_hat) ** 2
        )
        N = data.Y.shape[0]
        return (_llk0_sum_cheb(params, stats, coeffs, consts, N)
                + jnp.dot(post.r, B) - penalty
                + _elbo_extras(params, data, post, rho_prior))

    def estep_cheb(params, post):
        log_alpha = jax.nn.log_softmax(params.alpha_logits)
        coeffs = _netted_cheb_coeffs(params, data, stats)
        A = _estep_A_cheb(data, stats, coeffs, post.r)
        gamma = jax.nn.softmax(log_alpha[None, :] + A, axis=1)
        ps = _gamma_stats(data, stats, gamma)
        B = _B_from_stats(coeffs, ps)
        r = jax.nn.sigmoid(logit_prior + B)
        # ps is parameter-independent, so the NEXT M-step's inner Adam
        # loop reuses it verbatim — no Y pass inside the optimizer.
        return NegbinPosterior(gamma=gamma, r=r), ps, B

    def mstep_cheb(params, opt_state, post, ps):
        alpha = jnp.clip(jnp.mean(post.gamma, axis=0), 1e-12)
        params = params._replace(alpha_logits=jnp.log(alpha))

        def loss(rates):
            p = params._replace(log_mu=rates[0], log_beta=rates[1],
                                log_phi=rates[2])
            return -_mstep_objective_cheb(p, data, stats, ps, post.r,
                                          lam, consts)

        def one_step(carry, _):
            rates, opt_state = carry
            g = jax.grad(loss)(rates)
            updates, opt_state = opt.update(g, opt_state)
            rates = optax.apply_updates(rates, updates)
            return (rates, opt_state), None

        rates0 = (params.log_mu, params.log_beta, params.log_phi)
        (rates, opt_state), _ = jax.lax.scan(
            one_step, (rates0, opt_state), None, length=m_steps
        )
        return params._replace(log_mu=rates[0], log_beta=rates[1],
                               log_phi=rates[2]), opt_state

    if resume_from is None:
        post, ps0, B0 = estep_cheb(params, post)
    else:
        ps0 = _gamma_stats(data, stats, post.gamma)
        B0 = _B_from_stats(_netted_cheb_coeffs(params, data, stats), ps0)
    elbo0 = elbo_cheb(params, post, B0)
    trace = jnp.full((max_iter + 1,), jnp.nan, data.Y.dtype).at[0].set(elbo0)
    window = jnp.full((window_size,), 1e3, data.Y.dtype)

    def cond_cheb(st: _EMStateCheb):
        return (st.i < max_iter) & (jnp.mean(jnp.abs(st.window)) >= rel_tol)

    def body_cheb(st: _EMStateCheb):
        params, opt_state = mstep_cheb(st.params, st.opt_state, st.post,
                                       st.pstats)
        post, ps, B = estep_cheb(params, st.post)
        e = elbo_cheb(params, post, B)
        prev = st.trace[st.i]
        rel = (e - prev) / jnp.abs(prev)
        return _EMStateCheb(
            params=params, opt_state=opt_state, post=post, pstats=ps,
            i=st.i + 1,
            trace=st.trace.at[st.i + 1].set(e),
            window=jnp.roll(st.window, 1).at[0].set(rel),
        )

    st = jax.lax.while_loop(
        cond_cheb, body_cheb,
        _EMStateCheb(params=params, opt_state=opt_state, post=post,
                     pstats=ps0, i=jnp.asarray(0), trace=trace,
                     window=window),
    )
    # exact final ELBO at the converged state (one exact clone scan), so
    # fits are comparable across impls and against the golden pins
    _, B_exact = _accumulate(st.params, data, st.post.r, st.post.gamma)
    final = _elbo_with_B(st.params, data, st.post, B_exact, lam, rho_prior)
    return NegbinResult(
        params=st.params, post=st.post, elbo_trace=st.trace,
        n_iter=st.i, final_elbo=final,
        opt_state=st.opt_state,
    )


def run_negbin_em(
    data: NegbinData,
    rho_init: Optional[jax.Array] = None,
    stats: Optional[NegbinChebStats] = None,
    *,
    resume_from: Optional[NegbinResult] = None,
    **em_kwargs,
) -> NegbinResult:
    """The full variational-EM fit as one jitted program.

    Each iteration: CAVI gamma update (from current r) -> CAVI r update
    (from the new gamma) -> closed-form alpha -> ``m_steps`` Adam steps on
    (log mu, log beta, log phi). Stops when the mean |relative ELBO change|
    over ``window_size`` iterations drops below ``rel_tol`` (the v2 loop's
    criterion, reference R/inference-tflow.R:404-416, reused for the v1
    family whose own stopping rule is unrecorded).

    The Adam step size decays smoothly: lr(i) = learning_rate *
    lr_decay_rate ** (i / lr_decay_iters) over EM iterations i. A CONSTANT
    lr never converges at scale: f32 gradient noise (~10% of |g| at
    100k x 2k, measured) drives a fixed-size random walk near the optimum
    — the monitored ELBO oscillates at ~3e-4 relative and degrades past
    ~300 iterations, so rel_tol can never fire. With decay the ELBO climbs
    monotonically through that plateau and the window criterion triggers
    (measured: better final ELBO AND earlier stop than constant lr).
    ``lr_decay_rate=1.0`` restores the constant-lr behavior.

    Scale note: the monitored ELBO is evaluated in f32, whose tree-reduce
    noise over N*G elements is ~5e-6 relative at N*G ~ 2e8 — rel_tol below
    that floor cannot trigger on huge inputs; budget with ``max_iter``
    (quality plateaus by ~100-200 iterations at that scale) or raise
    rel_tol to ~1e-5.

    ``resume_from``: a previous :class:`NegbinResult` — continues its
    trajectory exactly (params, posterior, and Adam moments are all
    carried). Caveat: the convergence WINDOW restarts each chunk, so a
    chunked run takes the same steps as one long run but may stop at a
    different iteration — identical only when neither stops early
    (e.g. ``rel_tol=0`` or pre-convergence segments).

    ``stats``: a :class:`NegbinChebStats` (from :func:`negbin_cheb_stats`)
    switches the whole loop onto the Chebyshev sufficient-statistics path:
    each EM iteration reads Y exactly twice (E-step A matmul + YGT stats
    matmul) and the inner Adam steps cost O(G*(V + C*D)) — independent of
    the cell count — so deep inner refinement (large ``m_steps``) is
    effectively free. The monitored ``elbo_trace`` is then the Chebyshev
    objective (a ~1e-6-relative-accurate surrogate whose CHANGES track the
    exact ELBO's); ``final_elbo`` is re-evaluated EXACTLY at the converged
    state, so it is comparable across impls (and may differ from
    ``elbo_trace[n_iter]`` by the approximation gap). Resume chunks must
    keep the same impl AND (for cheb) the same degree: each result carries a
    ``cheb_degree`` marker and this wrapper raises on a mismatch rather than
    silently continuing a mixed trajectory (the two loops optimize slightly
    different monitored objectives with incompatible Adam-noise structure).
    """
    degree = None if stats is None else int(stats.T.shape[1]) - 1
    if resume_from is not None:
        prev = getattr(resume_from, "cheb_degree", None)
        if prev != degree:
            def _impl(d):
                return "exact" if d is None else f"cheb (degree {d})"
            raise ValueError(
                "resume_from was produced by the "
                f"{_impl(prev)} backend but this call selects "
                f"{_impl(degree)}; resume chunks must keep the same impl "
                "(pass the same `stats` argument, or none, as the "
                "original run)"
            )
        # strip the host-side marker before entering the jitted program
        # (an int leaf would be traced; None keeps the pytree structure
        # identical to the program's own output)
        resume_from = resume_from._replace(cheb_degree=None)
    result = _run_negbin_em_program(
        data, rho_init, stats, resume_from=resume_from, **em_kwargs
    )
    return result._replace(cheb_degree=degree)


@functools.partial(jax.jit, static_argnames=("n_iter", "rho_prior"))
def _gibbs_program(data: NegbinData, params: NegbinParams, key,
                   pi0, rho0, *, n_iter: int, rho_prior: float):
    logit_prior = jnp.log(rho_prior) - jnp.log1p(-rho_prior)
    log_alpha = jax.nn.log_softmax(params.alpha_logits)
    C = data.Lp.shape[1]

    def sweep(state, key):
        pi, rho = state
        k_pi, k_rho = jax.random.split(key)
        dtype = data.Y.dtype
        onehot = jax.nn.one_hot(pi, C, dtype=dtype)
        # pi | rho: categorical over clones with the rho-gated likelihood
        A, _ = _accumulate(params, data, rho, onehot)
        pi = jax.random.categorical(k_pi, log_alpha[None, :] + A, axis=1)
        # rho | pi: per-gene Bernoulli with the pi-conditioned odds
        onehot = jax.nn.one_hot(pi, C, dtype=dtype)
        _, B = _accumulate(params, data, rho, onehot)
        rho = jax.random.bernoulli(
            k_rho, jax.nn.sigmoid(logit_prior + B)
        ).astype(dtype)
        return (pi, rho), (pi, rho)

    keys = jax.random.split(key, n_iter)
    _, (pi_trace, rho_trace) = jax.lax.scan(sweep, (pi0, rho0), keys)
    return pi_trace, rho_trace


def gibbs_pi_rho(
    Y,
    L,
    *,
    params: Optional[NegbinParams] = None,
    n_iter: int = 20,
    rho_init=None,
    pi_init=None,
    rho_prior: float = 0.5,
    s=None,
    seed: int = 0,
    key=None,
    dtype=jnp.float32,
):
    """Collapsed Gibbs sweep over (pi_n, rho_g) — the reference's deleted
    `gibbs_pi_rho(rho, data, params, n_iter)` (called at
    inst/create_model3_synthetic.R:45), rebuilt as array programs.

    Each sweep samples every cell's clone jointly (one categorical over the
    rho-gated log-likelihood — cells are conditionally independent given
    rho) and every gene's dosage indicator jointly (Bernoulli given the new
    assignments) — two clone-scans per sweep, no (N, G, C) tensor, the whole
    chain one ``lax.scan`` under jit. ``params`` defaults to the moment
    initialization; pass a :class:`NegbinParams` (e.g. from a
    :func:`run_negbin_em` fit) to sample under fitted rates.

    Returns ``{"pi_trace": (n_iter, N), "rho_trace": (n_iter, G)}`` as
    NumPy arrays, the shape the script's trace-consumers expect.
    """
    data = prepare_negbin_data(Y, L, s=s, dtype=dtype)
    if params is None:
        params = init_negbin_params(data, dtype)
    if key is None:
        key = jax.random.PRNGKey(int(seed))
    N = data.Y.shape[0]
    G, C = data.Lp.shape
    key, k_pi0 = jax.random.split(key)
    pi0 = (jax.random.randint(k_pi0, (N,), 0, C) if pi_init is None
           else jnp.asarray(pi_init, jnp.int32))
    rho0 = (jnp.full((G,), 0.5, dtype) if rho_init is None
            else jnp.asarray(rho_init, dtype))
    pi_trace, rho_trace = _gibbs_program(
        data, params, key, pi0, rho0,
        n_iter=int(n_iter), rho_prior=float(rho_prior),
    )
    return {
        "pi_trace": np.asarray(pi_trace),
        "rho_trace": np.asarray(rho_trace),
    }


def clone_probs_from_gibbs(pi_trace, C: int, burn_in: int = 0) -> np.ndarray:
    """(N, C) clone frequencies over the trace (the reference's deleted
    `clone_probs_from_gibbs(pi_traces, C)`,
    inst/create_model3_synthetic.R:46)."""
    pi_trace = np.asarray(pi_trace)[burn_in:]
    if pi_trace.ndim != 2 or pi_trace.shape[0] == 0:
        raise ValueError("pi_trace must be (n_iter, N) with n_iter > burn_in")
    counts = np.stack([(pi_trace == c).mean(axis=0) for c in range(C)], axis=1)
    return counts


def rho_probs_from_gibbs(rho_trace, burn_in: int = 0) -> np.ndarray:
    """(G, 2) posterior [P(rho=0), P(rho=1)] over the trace (the
    reference's deleted `rho_probs_from_gibbs(traces$rho_trace)`,
    inst/create_model3_synthetic.R:51 — the script takes a per-gene
    `which.max` over its two columns)."""
    rho_trace = np.asarray(rho_trace)[burn_in:]
    if rho_trace.ndim != 2 or rho_trace.shape[0] == 0:
        raise ValueError("rho_trace must be (n_iter, G) with n_iter > burn_in")
    p1 = rho_trace.mean(axis=0)
    return np.stack([1 - p1, p1], axis=1)


@dataclass
class ClonealignV1Fit:
    """Fit object for the legacy family — the v1 analog of the v2
    ``ClonealignFit`` contract (clone labels + posterior probabilities +
    ML params + convergence trace)."""
    clone: list
    clone_probs: np.ndarray         # (N, C)
    rho_probs: np.ndarray           # (G,) q(rho_g = 1)
    mu: np.ndarray
    beta: np.ndarray
    phi: np.ndarray
    alpha: np.ndarray
    elbo_trace: np.ndarray
    n_iter: int
    final_elbo: float
    clone_names: list = field(default_factory=list)
    # mean total counts of the TRAINING cells. The NB likelihood is scale-
    # sensitive in s (unlike the multinomial, which conditions on totals),
    # so serving must put new cells' size factors on the fit's scale:
    # s_new = totals_new / s_mean. NaN on fits saved before this field.
    s_mean: float = float("nan")

    def __repr__(self):
        N, C = self.clone_probs.shape
        return (
            f"A clonealign_v1 (negative-binomial dosage mixture) fit for "
            f"{N} cells, {len(self.mu)} genes, and {C} clones\n"
            f"   converged in {self.n_iter} iterations, "
            f"final ELBO {self.final_elbo:.4f}"
        )

    def save(self, path) -> str:
        """Persist to .npz (the v1 analog of ClonealignFit.save; the
        ``model`` tag lets loaders and the CLI dispatch on family).
        Returns the path actually written (np.savez appends ``.npz``)."""
        np.savez_compressed(
            path,
            model="negbin_v1",
            clone=np.asarray(self.clone, dtype=object),
            clone_probs=self.clone_probs,
            rho_probs=self.rho_probs,
            mu=self.mu, beta=self.beta, phi=self.phi, alpha=self.alpha,
            elbo_trace=self.elbo_trace,
            n_iter=self.n_iter, final_elbo=self.final_elbo,
            clone_names=np.asarray(self.clone_names, dtype=object),
            s_mean=self.s_mean,
        )
        return path if str(path).endswith(".npz") else f"{path}.npz"

    @classmethod
    def load(cls, path) -> "ClonealignV1Fit":
        with np.load(path, allow_pickle=True) as z:
            if "model" not in z.files or str(z["model"]) != "negbin_v1":
                tag = str(z["model"]) if "model" in z.files else "<absent>"
                raise ValueError(
                    f"not a clonealign v1 fit: model tag {tag}"
                )
            return cls(
                clone=[str(c) for c in z["clone"]],
                clone_probs=z["clone_probs"],
                rho_probs=z["rho_probs"],
                mu=z["mu"], beta=z["beta"], phi=z["phi"], alpha=z["alpha"],
                elbo_trace=z["elbo_trace"],
                n_iter=int(z["n_iter"]),
                final_elbo=float(z["final_elbo"]),
                clone_names=[str(c) for c in z["clone_names"]],
                s_mean=float(z["s_mean"]) if "s_mean" in z else float("nan"),
            )


def inference_em(
    Y,
    L,
    *,
    max_iter: int = 100,
    rel_tol: float = 1e-6,
    lam: float = 1.0,
    rho_init=None,
    rho_prior: float = 0.5,
    s=None,
    learning_rate: float = 0.05,
    m_steps: Optional[int] = None,
    clone_call_probability: float = 0.95,
    clone_names=None,
    dtype=jnp.float32,
    verbose: bool = True,
    likelihood_impl: str = "exact",
    z_degree: int = 12,
) -> ClonealignV1Fit:
    """Fit the v1 negative-binomial dosage mixture (the function the
    reference's legacy driver calls: inst/create_model3_synthetic.R:104-105
    `inference_em(Y, Lp, rel_tol, max_iter, lambda, rho_init)` — deleted
    upstream, rebuilt here as deterministic variational EM).

    Returns a :class:`ClonealignV1Fit` whose ``clone_probs`` / ``rho_probs``
    are the variational marginals (the analog of
    `clone_probs_from_gibbs` / `rho_probs_from_gibbs`,
    reference inst/create_model3_synthetic.R:46-52).

    ``likelihood_impl="cheb"`` switches the loop onto the Chebyshev
    sufficient-statistics path (see :func:`run_negbin_em`): inner Adam
    steps stop touching Y entirely, so ``m_steps`` defaults to 30 there
    (vs 5 on the exact path, where each inner step costs a full clone
    scan). Requires integer counts; ``z_degree`` sets the expansion degree
    over the log-size-factor range.
    """
    if likelihood_impl not in ("exact", "cheb"):
        raise ValueError(
            f"likelihood_impl must be 'exact' or 'cheb', got "
            f"{likelihood_impl!r}"
        )
    if m_steps is None:
        m_steps = 30 if likelihood_impl == "cheb" else 5
    data = prepare_negbin_data(Y, L, s=s, dtype=dtype)
    stats = (negbin_cheb_stats(data, degree=int(z_degree))
             if likelihood_impl == "cheb" else None)
    C = data.Lp.shape[1]
    if clone_names is None:
        # default clone naming, as the v2 driver does (reference
        # R/clonealign.R:249-254)
        import string

        clone_names = list(string.ascii_uppercase[:C]) if C <= 26 else [
            f"clone_{i}" for i in range(C)
        ]
    if verbose:
        print("Optimizing ELBO (v1 negative-binomial family)")
    result = run_negbin_em(
        data,
        None if rho_init is None else jnp.asarray(rho_init, dtype),
        stats,
        max_iter=int(max_iter), rel_tol=float(rel_tol), lam=float(lam),
        rho_prior=float(rho_prior), learning_rate=float(learning_rate),
        m_steps=int(m_steps),
    )
    gamma = np.asarray(result.post.gamma, np.float64)
    from .. import assign as _assign

    clones = _assign.clone_assignment(gamma, clone_names, clone_call_probability)
    n_iter = int(result.n_iter)
    return ClonealignV1Fit(
        clone=list(clones),
        clone_probs=gamma,
        rho_probs=np.asarray(result.post.r, np.float64),
        mu=np.asarray(jnp.exp(result.params.log_mu), np.float64),
        beta=np.asarray(jnp.exp(result.params.log_beta), np.float64),
        phi=np.asarray(jnp.exp(result.params.log_phi), np.float64),
        alpha=np.asarray(jax.nn.softmax(result.params.alpha_logits), np.float64),
        elbo_trace=np.asarray(result.elbo_trace, np.float64)[: n_iter + 1],
        n_iter=n_iter,
        final_elbo=float(result.final_elbo),
        clone_names=[str(c) for c in clone_names],
        s_mean=float(np.asarray(jnp.sum(data.Y, axis=1)).mean()),
    )


def classify_cells(
    fit: ClonealignV1Fit,
    Y_new,
    L,
    s=None,
    clone_call_probability: float = 0.95,
    dtype=jnp.float32,
):
    """Assign NEW cells under a fitted v1 model — no refit (the v1 analog
    of :func:`clonealign_tpu.serve.assign_cells`).

    The clone posterior for an unseen cell is the CAVI gamma update under
    the fitted rates with the fitted dosage marginals q(rho) as gene
    weights:  log q(pi=c) = log alpha_c + sum_g r_g D_c[n, g] + const —
    one clone scan over (N_new, G), closed form, no optimization.

    Size factors: the NB mean is s_n * rate, so s carries real scale
    (the multinomial conditions totals away; the v1 family does not).
    New cells default to s = totals / fit.s_mean — the TRAINING cells'
    mean total — so a deeper-sequenced serving batch is not mistaken for
    higher expression. Pass ``s`` explicitly to override. Fits saved
    before ``s_mean`` existed fall back to the serving batch's own mean
    (exact when sequencing depth matches the training run).

    Returns ``(clones, clone_probs)`` like the v2 serving path.
    """
    from ..utils.sparsity import is_scipy_sparse

    if s is None:
        if is_scipy_sparse(Y_new):
            totals = np.asarray(Y_new.sum(axis=1), np.float64).ravel()
        else:
            totals = np.asarray(Y_new, np.float64).sum(axis=1)
        denom = fit.s_mean if np.isfinite(fit.s_mean) else totals.mean()
        s = totals / denom
    data = prepare_negbin_data(Y_new, L, s=s, dtype=dtype)
    if len(fit.mu) != data.Lp.shape[0]:
        raise ValueError(
            f"fit has {len(fit.mu)} genes but Y_new/L have "
            f"{data.Lp.shape[0]}; serve over the fit's genes, same order"
        )
    params = NegbinParams(
        log_mu=jnp.log(jnp.asarray(fit.mu, dtype)),
        log_beta=jnp.log(jnp.asarray(fit.beta, dtype)),
        log_phi=jnp.log(jnp.asarray(fit.phi, dtype)),
        alpha_logits=jnp.log(jnp.asarray(fit.alpha, dtype)),
    )
    r = jnp.asarray(fit.rho_probs, dtype)
    C = data.Lp.shape[1]
    A = _accumulate_A(params, data, r)
    gamma = np.asarray(
        jax.nn.softmax(jnp.log(jnp.asarray(fit.alpha, dtype))[None, :] + A, axis=1),
        np.float64,
    )
    from .. import assign as _assign

    names = fit.clone_names or [
        f"clone_{i}" for i in range(C)
    ]
    clones = _assign.clone_assignment(gamma, names, clone_call_probability)
    return clones, gamma
