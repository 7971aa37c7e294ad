"""One-device scale headroom: 500k cells x 2k genes x 10 clones,
10-restart sweep. Prints one JSON line naming the device it ran on
(ground-truth accuracy is expected at 1.0).

Usage: python benchmarks/scale_test.py [--cells 500000] [--genes 2000]
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
    ap.add_argument("--cells", type=int, default=500_000)
    ap.add_argument("--genes", type=int, default=2_000)
    ap.add_argument("--clones", type=int, default=10)
    ap.add_argument("--restarts", type=int, default=10)
    ap.add_argument("--max-iter", type=int, default=100)
    ap.add_argument("--sparse", action="store_true",
                    help="ingest counts as scipy CSR (no host densification)")
    ap.add_argument("--impl", default="auto", choices=("auto", "z_cheb"),
                    help="likelihood backend (z_cheb: Chebyshev normalizer)")
    ap.add_argument("--batching", default="map", choices=("map", "vmap"),
                    help="restart batching probe knob (with z_cheb the "
                    "per-lane working set is O(N*C*D), not O(N*G), so "
                    "vmap fits at 500k x 2k)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import make_synthetic
    from clonealign_tpu.infer import run_inference
    from clonealign_tpu.models import multinomial as mm
    from clonealign_tpu.utils.cache import enable_persistent_cache
    from clonealign_tpu.utils.profiling import device_label

    enable_persistent_cache()
    N, G, C, R = args.cells, args.genes, args.clones, args.restarts

    key = jax.random.PRNGKey(0)
    # counts generated directly in int8 (exact; the generator raises if a
    # count would wrap): a 1M x 2k matrix never exists in f32 (8 GB)
    # on-device, and prepare_data reuses the int8 array zero-copy
    Y, L, z = make_synthetic(key, N, G, C, jnp.float32, chunk=25_000,
                             out_dtype=jnp.int8)
    ingest = "dense"
    if args.sparse:
        # sparse ingestion path: Y leaves the device as scipy CSR and comes
        # back through prepare_data_sparse — host peak is O(nnz), never
        # N x G x 8 bytes (e.g. 500k x 2k float64 would be 8 GB dense)
        import scipy.sparse as sp

        Y_sp = sp.csr_matrix(np.asarray(Y))
        del Y
        host_mb = (Y_sp.data.nbytes + Y_sp.indices.nbytes + Y_sp.indptr.nbytes) / 1e6
        ingest = f"sparse csr ({host_mb:.0f} MB host, density {Y_sp.nnz / (N * G):.3f})"
        data = mm.prepare_data(Y_sp, L, dtype=jnp.float32, y_storage=jnp.int8)
        del Y_sp
    else:
        data = mm.prepare_data(Y, L, dtype=jnp.float32, y_storage=jnp.int8)
        del Y
    config = mm.ModelConfig(K=1, P=0, mc_samples=1, likelihood_impl=args.impl)

    @jax.jit
    def sweep(keys, data):
        # deterministic init passes shared across restarts (restarts.py
        # does the same); under "map" batching each sequential lane would
        # otherwise repay the full blocked-PCA cost
        shared_pca = mm.pca_init_scores(
            data.Y, 1, mm.lane0_pca_key(keys[0]), jnp.float32
        )
        shared_mu = mm.data_mu_guess(data.Y, jnp.float32)

        def one_fit(k):
            ki, kr = jax.random.split(k)
            p0 = mm.init_params(
                data.Y, data.L, ki, K=1, dtype=jnp.float32,
                pca_scores=shared_pca, mu_guess=shared_mu,
            )
            r = run_inference(
                p0, data, kr, config, max_iter=args.max_iter,
                elbo_eval="reuse", loop_impl="scan", unroll=4,
                # remat only when the gene-blocked Z path kicks in (storing
                # per-block exp residuals would defeat the blocking); below
                # that threshold storing the forward intermediates is faster.
                # z_cheb never gene-blocks (its normalizer is the Chebyshev
                # node table + Clenshaw, no N x G exp residuals), so remat
                # there only re-runs cheap work.
                remat=args.impl != "z_cheb" and N * G > (1 << 30),
            )
            return r.final_elbo, jnp.argmax(r.params.gamma_logits, axis=1)
        if args.batching == "vmap":
            elbos, assign = jax.vmap(one_fit)(keys)
        else:
            elbos, assign = jax.lax.map(one_fit, keys)
        best = jnp.argmax(elbos)
        return elbos, assign[best]

    keys = jax.random.split(jax.random.PRNGKey(1), R)
    out = sweep(keys, data)
    jax.block_until_ready(out)  # compile (excluded)

    elapsed = float("inf")
    for rep in (2, 3):
        t0 = time.perf_counter()
        elbos, a = sweep(jax.random.split(jax.random.PRNGKey(rep), R), data)
        a = np.asarray(a)
        elapsed = min(elapsed, time.perf_counter() - t0)

    acc = float((a == np.asarray(z)).mean())
    print(json.dumps({
        "metric": f"scale test {N}x{G}x{C}, {R} restarts, one device, {ingest}"
        + ("" if args.impl == "auto" else f", {args.impl}")
        + ("" if args.batching == "map" else ", vmap restarts"),
        "elapsed_s": round(elapsed, 2),
        "cells_per_sec": round(N * R / elapsed, 1),
        "accuracy": acc,
        "hw": device_label(),
    }))


if __name__ == "__main__":
    main()
