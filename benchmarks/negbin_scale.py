"""On-device scale measurement for the legacy v1 NB family
(models/negbin.py). Prints one JSON line naming the device it ran on.

Data is the model3 generative spec (reference
inst/create_model3_synthetic.R:3-29) sampled ON-DEVICE through the exact
gamma-Poisson mixture representation of the NB, so the measurement is the
fit, not a host-to-device transfer. The timed run uses a FRESH dataset
(different seed) so call memoization cannot under-report, and fetches the
result.

Usage: python benchmarks/negbin_scale.py [--cells 100000] [--genes 2000]
       [--clones 4] [--max-iter 100]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def gen_model3_on_device(seed, N, G, C, dtype, chunk=10_000):
    """model3 spec with jax.random; chunked over cells (the Poisson
    rejection sampler holds ~8 temporaries of its operand)."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    kr, kp, km, kf, kL, ks, ky = jax.random.split(key, 7)
    rho = (jax.random.uniform(kr, (G,)) < (0.9 / 1.1)).astype(dtype)
    pi = jax.random.randint(kp, (N,), 0, C)
    mu = jax.random.uniform(km, (G,), dtype, 1.0, 2.0)
    beta = mu
    phi = jax.random.gamma(kf, jnp.full((G,), 4.0, dtype))  # Gamma(4, 1)
    L = jax.random.randint(kL, (G, C), 1, C + 1).astype(dtype)
    Lp = L / jnp.mean(L, axis=0, keepdims=True)
    s = jax.random.uniform(ks, (N,), dtype, 500.0, 10_000.0)

    @jax.jit
    def gen_chunk(k, s_c, pi_c):
        m = s_c[:, None] * ((1 - rho)[None, :] * mu[None, :]
                            + (rho * beta)[None, :] * Lp[:, pi_c].T)
        k1, k2 = jax.random.split(k)
        lam = jax.random.gamma(
            k1, jnp.broadcast_to(phi[None, :], m.shape)
        ) * (m / phi[None, :])
        return jax.random.poisson(k2, lam).astype(dtype)

    n_chunks = (N + chunk - 1) // chunk
    keys = jax.random.split(ky, n_chunks)
    parts = [
        gen_chunk(keys[i], s[i * chunk:(i + 1) * chunk],
                  pi[i * chunk:(i + 1) * chunk])
        for i in range(n_chunks)
    ]
    return jnp.concatenate(parts, axis=0), L, rho, pi


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=100_000)
    ap.add_argument("--genes", type=int, default=2_000)
    ap.add_argument("--clones", type=int, default=4)
    ap.add_argument("--max-iter", type=int, default=100)
    ap.add_argument("--chunk-iters", type=int, default=None,
                    help="run the fit as resume_from-chained chunks of this "
                    "many iterations (bounds the length of one execution)")
    ap.add_argument("--m-steps", type=int, default=None,
                    help="inner Adam steps per EM iteration "
                    "(run_negbin_em m_steps; default 5 exact / 30 cheb)")
    ap.add_argument("--impl", default="exact", choices=["exact", "cheb"],
                    help="likelihood backend: exact clone scan or the "
                    "Chebyshev sufficient-statistics path")
    args = ap.parse_args()
    if args.m_steps is None:
        args.m_steps = 30 if args.impl == "cheb" else 5

    from clonealign_tpu.utils.cache import enable_persistent_cache
    from clonealign_tpu.utils.profiling import device_label
    enable_persistent_cache()
    import jax
    import jax.numpy as jnp
    from clonealign_tpu.models import negbin as nb

    N, G, C = args.cells, args.genes, args.clones
    dtype = jnp.float32

    def fit(data):
        """One fit, optionally as resume-chained chunks; returns
        (result, total_iters_run)."""
        stats = (nb.negbin_cheb_stats(data) if args.impl == "cheb"
                 else None)
        if args.chunk_iters is None:
            res = nb.run_negbin_em(data, None, stats, max_iter=args.max_iter,
                                   rel_tol=1e-6, m_steps=args.m_steps)
            jax.block_until_ready(res.final_elbo)
            return res, int(res.n_iter)
        res, total = None, 0
        while total < args.max_iter:
            step = min(args.chunk_iters, args.max_iter - total)
            res = nb.run_negbin_em(data, None, stats, max_iter=step,
                                   rel_tol=1e-6,
                                   m_steps=args.m_steps, resume_from=res)
            jax.block_until_ready(res.final_elbo)
            n = int(res.n_iter)
            total += n
            print(f"  chunk: {n} iters, elbo "
                  f"{float(res.final_elbo):.6g}", file=sys.stderr)
            if n < step:   # the window criterion fired inside the chunk
                break
        return res, total

    t0 = time.perf_counter()
    Y, L, rho, pi = gen_model3_on_device(11, N, G, C, dtype)
    jax.block_until_ready(Y)
    print(f"gen A {time.perf_counter()-t0:.1f}s", file=sys.stderr)
    data = nb.prepare_negbin_data(Y, L, dtype=dtype)

    t0 = time.perf_counter()
    res, _ = fit(data)
    t_first = time.perf_counter() - t0
    print(f"compile+fit {t_first:.2f}s iters={int(res.n_iter)}",
          file=sys.stderr)

    Y2, L2, rho2, pi2 = gen_model3_on_device(22, N, G, C, dtype)
    jax.block_until_ready(Y2)
    data2 = nb.prepare_negbin_data(Y2, L2, dtype=dtype)
    del Y, Y2

    t0 = time.perf_counter()
    res2, n_iter_total = fit(data2)
    elbo = float(np.asarray(res2.final_elbo))   # fetch = real completion
    t_warm = time.perf_counter() - t0

    gamma = np.asarray(res2.post.gamma)
    n_iter = n_iter_total
    line = {
        "metric": f"v1 negbin VEM scale test {N}x{G}x{C}, one device",
        "hw": device_label(),
        "elapsed_s": round(t_warm, 3),
        "compile_plus_fit_s": round(t_first, 2),
        "s_per_iter": round(t_warm / max(n_iter, 1), 4),
        "cells_per_sec": round(N / t_warm, 1),
        "n_iter": n_iter,
        "final_elbo": elbo,
        "accuracy": round(float((gamma.argmax(1) == np.asarray(pi2)).mean()), 4),
        "rho_accuracy": round(float(
            ((np.asarray(res2.post.r) > 0.5)
             == np.asarray(rho2).astype(bool)).mean()), 4),
        "m_steps": args.m_steps,
        "impl": args.impl,
        "note": "run_negbin_em, f32 defaults; on-device model3 data; "
                "warm-cache time on a fresh dataset",
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
