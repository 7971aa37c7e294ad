"""Out-of-box headline probe.

Times a PLAIN ``run_clonealign(Y, L, seed=...)`` — no tuning knobs — at the
headline 100k x 5k x 10 scale on the device, now that the shipped
defaults resolve to the benchmarked configuration (y_storage="auto" -> int8,
likelihood_impl="auto" -> z_cheb, remat="auto" -> off under z_cheb). The
reference defines the product surface as its defaults
(reference R/clonealign.R:184-203 and R/clonealign.R:35-38: 3 shrinks x 3
repeats, max_iter=200, rel_tol=1e-6); this probe measures exactly that call.

Reported split:
  setup_s  — host-side parse/validate/filter + device upload (one-time data
             loading; scales with host RAM and link bandwidth)
  fit_s    — everything after setup: the compiled sweep + fit packaging
             (the number comparable to bench.py's tuned sweep time)
  total_s  — end-to-end wall clock of the second call (compile cached)

Prints one JSON line naming the device it ran on.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from clonealign_tpu.utils.cache import enable_persistent_cache
    from clonealign_tpu.utils.profiling import device_label

    enable_persistent_cache()

    from bench import make_synthetic

    smoke = os.environ.get("BENCH_SMOKE") == "1"
    N, G, C = (512, 128, 4) if smoke else (100_000, 5_000, 10)
    max_iter = 200

    key = jax.random.PRNGKey(0)
    k_data, _ = jax.random.split(key)
    Yd, Ld, _z = make_synthetic(k_data, N, G, C, jnp.float32, out_dtype=jnp.int16)
    # the user's starting point: host-resident integer counts
    Y = np.asarray(jax.device_get(Yd))
    L = np.asarray(jax.device_get(Ld), np.float64)
    del Yd, Ld

    from clonealign_tpu import restarts as _restarts
    from clonealign_tpu import run_clonealign

    # Record setup time from INSIDE each measured call, so setup and fit
    # are attributed within the same run. Wrapping the sweep driver's
    # setup_fit keeps the measured call a literal plain run_clonealign
    # (the added block_until_ready only moves the upload sync a few lines
    # earlier).
    _setup_orig = _restarts.setup_fit
    setup_times = []

    def _timed_setup(*a, **k):
        t0 = time.perf_counter()
        ctx = _setup_orig(*a, **k)
        jax.block_until_ready(ctx.data.Y)
        setup_times.append(time.perf_counter() - t0)
        return ctx

    _restarts.setup_fit = _timed_setup

    def one_call(seed):
        t0 = time.perf_counter()
        # verbose/print_elbos off so stdout stays a clean JSON line; every
        # QC default (per-fit correlations AND multirun median correlations,
        # both on-device since round 4) runs exactly as a plain call would.
        fit = run_clonealign(Y, L, seed=seed, verbose=False, print_elbos=False)
        return fit, time.perf_counter() - t0

    # call 1: compile (excluded)
    fit, _ = one_call(0)
    # same-run link floor: a bare device_put of the wire bytes gives each
    # committed row its own transfer context
    t0 = time.perf_counter()
    d = jax.device_put(Y.astype(np.int8))
    d.block_until_ready()
    put_floor_s = time.perf_counter() - t0
    del d

    total_s = setup_s = float("inf")
    for rep in (1, 2):
        fit, t = one_call(rep)
        if t < total_s:
            total_s, setup_s = t, setup_times[-1]

    n_iters = int(fit.convergence_info.n_iters)
    elbos = [round(float(e), 1) for e in fit.multirun_info["elbos"]]
    out = {
        "metric": ("out_of_box run_clonealign (smoke)" if smoke else
                   "out_of_box run_clonealign (100k x 5k x 10, defaults: "
                   "9 restarts, max_iter=200, rel_tol=1e-6)"),
        "total_s": round(total_s, 2),
        "setup_s": round(setup_s, 2),
        "fit_s": round(total_s - setup_s, 2),
        "put_int8_floor_s": round(put_floor_s, 2),
        "cells_assigned_per_sec": round(N * 9 / max(total_s - setup_s, 1e-9), 1),
        "best_run_n_iters": n_iters,
        "y_storage_resolved": str(np.dtype(np.int8)) if not smoke else "auto",
        "final_elbos": elbos,
        "config": {"N": N, "G": G, "C": C, "restarts": 9, "max_iter": max_iter},
        "hw": device_label(),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
