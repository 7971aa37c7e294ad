"""Allele-specific joint fit at benchmark scale: 100k cells x 2k genes x 10
clones with V=1000 variants. Prints one JSON line naming the device.

The SNP side is generated on-device (the (N, V) upload is a one-time
ingest cost, not a fit cost). The timed section
is what serving large cohorts pays per fit: the beta-binomial clone
log-likelihood build (construct_ai_likelihood — two (V-contracted) matmuls)
plus the full VI sweep with the (N, C) term joined in.

Usage: python benchmarks/allele_scale.py [--cells 100000] [--variants 1000]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=100_000)
    ap.add_argument("--genes", type=int, default=2_000)
    ap.add_argument("--clones", type=int, default=10)
    ap.add_argument("--variants", type=int, default=1_000)
    ap.add_argument("--restarts", type=int, default=3)
    ap.add_argument("--max-iter", type=int, default=100)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import make_synthetic
    from clonealign_tpu.infer import run_inference
    from clonealign_tpu.models import multinomial as mm
    from clonealign_tpu.models.allele import construct_ai_likelihood
    from clonealign_tpu.utils.cache import enable_persistent_cache
    from clonealign_tpu.utils.profiling import device_label

    enable_persistent_cache()
    N, G, C, V, R = args.cells, args.genes, args.clones, args.variants, args.restarts

    key = jax.random.PRNGKey(0)
    k_expr, k_allele, k_fit = jax.random.split(key, 3)
    Y, L, _z = make_synthetic(k_expr, N, G, C, jnp.float32, out_dtype=jnp.int8)

    k1, k2, k3 = jax.random.split(k_allele, 3)
    clone_allele = jax.random.randint(k1, (V, C), 1, 4).astype(jnp.float32)
    cov_vn = jax.random.randint(k2, (V, N), 1, 10).astype(jnp.float32)
    alt_vn = jnp.floor(cov_vn * jax.random.uniform(k3, (V, N)))
    jax.block_until_ready((Y, clone_allele, cov_vn, alt_vn))

    data = mm.prepare_data(Y, L, dtype=jnp.float32, y_storage=jnp.int8)
    config = mm.ModelConfig(K=1, P=0, mc_samples=1)

    @jax.jit
    def sweep(keys, data, extra):
        shared_pca = mm.pca_init_scores(
            data.Y, 1, mm.lane0_pca_key(keys[0]), jnp.float32
        )
        shared_mu = mm.data_mu_guess(data.Y, jnp.float32)

        def one_fit(k):
            k_init, k_run = jax.random.split(k)
            p0 = mm.init_params(
                data.Y, data.L, k_init, K=1, dtype=jnp.float32,
                pca_scores=shared_pca, mu_guess=shared_mu,
            )
            res = run_inference(
                p0, data, k_run, config, max_iter=args.max_iter, rel_tol=1e-6,
                learning_rate=0.1, extra_log_lik=extra,
                elbo_eval="reuse", loop_impl="scan", unroll=4, remat=False,
            )
            return res.final_elbo, res.params.gamma_logits

        elbos, gammas = jax.lax.map(one_fit, keys)
        best = jnp.argmax(elbos)
        return elbos, jnp.argmax(gammas[best], axis=1)

    @jax.jit
    def allele_term(ca, alt, cov):
        return construct_ai_likelihood(ca, alt, cov)

    keys = jax.random.split(k_fit, R)
    # compile both programs (excluded from timing)
    extra = allele_term(clone_allele, alt_vn, cov_vn)
    jax.block_until_ready(extra)
    jax.block_until_ready(sweep(keys, data, extra))

    elapsed = float("inf")
    for rep in (1, 2):
        t0 = time.perf_counter()
        extra = allele_term(clone_allele, alt_vn, cov_vn)
        finals, assigned = sweep(
            jax.random.split(jax.random.fold_in(k_fit, rep), R), data, extra
        )
        assigned = np.asarray(assigned)
        finals = np.asarray(finals)
        elapsed = min(elapsed, time.perf_counter() - t0)

    print(json.dumps({
        "config": f"allele-scale {N//1000}kx{G}x{C} (V={V}), {R} restarts",
        "elapsed_s": round(elapsed, 3),
        "cells_per_sec": round(N * R / elapsed, 1),
        "steps_per_sec": round(args.max_iter * R / elapsed, 1),
        "final_elbos": [round(float(f), 1) for f in finals],
        "hw": device_label(),
    }))


if __name__ == "__main__":
    main()
