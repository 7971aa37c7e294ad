"""Run every BASELINE.json benchmark config; one JSON line each.

Configs (BASELINE.json):
  1. bundled example_sce 200 x 100 x 3, single restart
  2. synthetic model3 1k x 500 x 5
  3. multi-restart: 10 vmapped fits, 5k x 1k, max-ELBO selection
  4. allele-specific joint fit
  5. large-scale 100k x 5k x 10, 10 restarts (needs a GPU; set SKIP_LARGE=1
     to skip)

Usage: python benchmarks/run_all.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def report(name, n_cells, n_restarts, elapsed, fit=None, extra=None):
    from clonealign_tpu.utils.profiling import device_label

    out = {
        "config": name,
        "elapsed_s": round(elapsed, 3),
        "cells_per_sec": round(n_cells * n_restarts / elapsed, 1),
        "steps_per_sec": None,
        "hw": device_label(),
        **(extra or {}),
    }
    if fit is not None:
        out["final_elbo"] = round(float(fit.convergence_info.final_elbo), 2)
        out["n_iters"] = int(fit.convergence_info.n_iters)
        out["steps_per_sec"] = round(out["n_iters"] * n_restarts / elapsed, 1)
    print(json.dumps(out), flush=True)


def config1_example_sce():
    from clonealign_tpu import clonealign
    from clonealign_tpu.io.datasets import load_example_sce

    sce = load_example_sce()
    L = dict(zip(sce.clone_names, sce.copy_number.T))
    clonealign(sce.counts, L, max_iter=200, seed=9, verbose=False)  # warm up compile
    t0 = time.perf_counter()
    fit = clonealign(sce.counts, L, max_iter=200, seed=0, verbose=False)
    report("1: example_sce 200x100x3", sce.n_cells, 1, time.perf_counter() - t0, fit)


def config2_model3():
    from clonealign_tpu import clonealign
    from clonealign_tpu.synth import assignment_accuracy, simulate_model3

    sim = simulate_model3(N=1000, G=500, C=5, seed=1)
    clonealign(sim.Y, sim.L, max_iter=200, seed=9, verbose=False)  # compile warm-up
    t0 = time.perf_counter()
    fit = clonealign(sim.Y, sim.L, max_iter=200, seed=0, verbose=False)
    elapsed = time.perf_counter() - t0
    acc = assignment_accuracy(fit.clone, fit.clone_names, sim.clone_idx)
    report("2: model3 1kx500x5", 1000, 1, elapsed, fit, {"accuracy": round(acc, 4)})


def config3_multirestart():
    from clonealign_tpu import run_clonealign
    from clonealign_tpu.synth import simulate_multinomial

    sim = simulate_multinomial(N=5000, G=1000, C=4, seed=2, mean_total=2000)
    run_clonealign(
        sim.Y, sim.L, initial_shrinks=(0, 5), n_repeats=5, max_iter=100,
        seed=9, verbose=False, print_elbos=False,
    )  # compile warm-up (identical restart-sweep program shape)
    t0 = time.perf_counter()
    fit = run_clonealign(
        sim.Y, sim.L, initial_shrinks=(0, 5), n_repeats=5, max_iter=100,
        seed=0, verbose=False, print_elbos=False,
    )
    elapsed = time.perf_counter() - t0
    report(
        "3: multirestart 10x (5k x 1k)", 5000, 10, elapsed, fit,
        {"best_run": int(fit.multirun_info["best_run"])},
    )


def config4_allele():
    from clonealign_tpu import clonealign
    from clonealign_tpu.synth import simulate_multinomial

    rng = np.random.default_rng(3)
    sim = simulate_multinomial(N=2000, G=500, C=3, seed=3, mean_total=2000)
    V = 200
    clone_allele = rng.integers(1, 4, (V, 3)).astype(float)
    cov = rng.integers(1, 30, (2000, V)).astype(float)
    ref = np.floor(cov * rng.uniform(0, 1, cov.shape))
    clonealign(
        sim.Y, sim.L, clone_allele=clone_allele, cov=cov, ref=ref,
        max_iter=200, seed=9, verbose=False,
    )  # compile warm-up
    t0 = time.perf_counter()
    fit = clonealign(
        sim.Y, sim.L, clone_allele=clone_allele, cov=cov, ref=ref,
        max_iter=200, seed=0, verbose=False,
    )
    elapsed = time.perf_counter() - t0
    report("4: allele-specific 2kx500x3 (V=200)", 2000, 1, elapsed, fit)


def config5_large():
    # delegate to the headline bench (its own warm-up/compile handling)
    import bench

    bench.main()


def main():
    from clonealign_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    config1_example_sce()
    config2_model3()
    config3_multirestart()
    config4_allele()
    if os.environ.get("SKIP_LARGE") != "1":
        config5_large()


if __name__ == "__main__":
    main()
