"""Headline benchmark: large-scale clone assignment throughput.

Config (BASELINE.json config 5): 100k cells x 5k genes x 10 clones, 10
restarts, full VI fit each. With more than one device the sweep runs
mesh-sharded over all of them.

Prints the device (JAX platform, device kind and count, and the card's name
and power limit from nvidia-smi) and then ONE JSON line. It measures a GPU
and fails when none is present; BENCH_SMOKE=1 is an explicit small CPU (or
GPU) smoke run whose numbers are not device measurements.
"""

import json
import os
import time

import numpy as np


def make_synthetic(key, N, G, C, dtype, chunk=10_000, out_dtype=None):
    """Clone-structured Poisson counts generated on-device (conditioning on
    totals makes Poisson rows exactly the model's multinomial). Generated in
    cell chunks: jax.random.poisson's rejection sampler carries ~8 copies of
    its operand through a while_loop, which OOMs at 100k x 5k in one shot.

    ``out_dtype`` (e.g. jnp.int16) stores the counts narrow as they are
    generated, so a 1M x 2k matrix never exists in float32 (8 GB) on-device.
    Counts are small integers, so integer narrowing is exact."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3, k4 = jax.random.split(key, 4)
    L = jax.random.randint(k1, (G, C), 1, 5).astype(dtype)
    mu = jnp.exp(jax.random.normal(k2, (G,), dtype) * 0.5)
    z = jax.random.randint(k3, (N,), 0, C)

    # the rejection sampler holds ~8 live copies of the chunk; bound the
    # chunk by ELEMENTS so wide-G configs don't OOM during generation
    chunk = min(chunk, N, max(256, 50_000_000 // G))
    n_chunks = -(-N // chunk)
    N_pad = n_chunks * chunk
    z_pad = jnp.pad(z, (0, N_pad - N))
    store = dtype if out_dtype is None else out_dtype

    check_range = jnp.issubdtype(jnp.dtype(store), jnp.integer)
    limit = jnp.iinfo(jnp.dtype(store)).max if check_range else 0

    @jax.jit
    def gen_chunk(k, z_c):
        rates = mu[None, :] * L[:, z_c].T  # (chunk, G)
        rates = rates * (2000.0 / jnp.sum(rates, axis=1, keepdims=True))
        y = jax.random.poisson(k, rates).astype(dtype)
        y = y.at[:, 0].add((jnp.sum(y, axis=1) == 0).astype(dtype))
        return y.astype(store), jnp.max(y)

    keys = jax.random.split(k4, n_chunks)
    parts = []
    for i in range(n_chunks):
        yc, mx = gen_chunk(keys[i], z_pad[i * chunk : (i + 1) * chunk])
        if check_range and float(mx) > limit:
            raise ValueError(
                f"narrow out_dtype {jnp.dtype(store).name} would wrap: chunk max "
                f"{float(mx):.0f} > {limit}"
            )
        parts.append(yc)
    Y = jnp.concatenate(parts, axis=0)[:N] if n_chunks > 1 else parts[0][:N]
    return Y, L, z


def build_sweep(config, dtype, max_iter):
    """The benchmark's restart sweep as ONE jitted on-device program:
    restarts VMAPPED (batched Adam loops: the batched thin matmuls amortize
    per-step overheads, and the decomposed ELBO keeps the per-lane working
    set small), scan-based iteration (unroll=4), gradients without remat,
    convergence monitored from the training-step ELBO. Only the winning
    assignment leaves the device.

    When ``data`` is mesh-sharded (cells x genes NamedShardings from
    parallel/sharding.py), GSPMD propagates the shardings through the whole
    program — the same sweep scales across devices unchanged."""
    import jax
    import jax.numpy as jnp

    from clonealign_tpu.infer import run_inference
    from clonealign_tpu.models import multinomial as mm

    @jax.jit
    def sweep(keys, data):
        # deterministic init passes shared across lanes (restarts.py does
        # the same)
        shared_pca = mm.pca_init_scores(
            data.Y, 1, mm.lane0_pca_key(keys[0]), dtype
        )
        shared_mu = mm.data_mu_guess(data.Y, dtype)

        def one_fit(k):
            k_init, k_run = jax.random.split(k)
            params0 = mm.init_params(
                data.Y, data.L, k_init, K=1, dtype=dtype,
                pca_scores=shared_pca, mu_guess=shared_mu,
            )
            res = run_inference(
                params0, data, k_run, config,
                max_iter=max_iter, rel_tol=1e-6, learning_rate=0.1,
                elbo_eval="reuse", loop_impl="scan", unroll=4, remat=False,
            )
            return res.final_elbo, res.params.gamma_logits
        elbos, gammas = jax.vmap(one_fit)(keys)
        best = jnp.argmax(elbos)
        return elbos, jnp.argmax(gammas[best], axis=1)

    return sweep


def main():
    import jax
    import jax.numpy as jnp

    smoke = os.environ.get("BENCH_SMOKE") == "1"
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not smoke:
        raise SystemExit(
            f"bench.py: no GPU found (JAX platform {dev.platform!r}); set "
            "BENCH_SMOKE=1 for an explicit small smoke run"
        )
    print(f"platform={dev.platform} device_kind={dev.device_kind} "
          f"count={len(jax.devices())}")
    from clonealign_tpu.utils.cache import enable_persistent_cache
    from clonealign_tpu.utils.profiling import gpu_name_and_power_limit

    if dev.platform == "gpu":
        print(f"nvidia-smi: {'; '.join(gpu_name_and_power_limit())}")

    enable_persistent_cache()

    from clonealign_tpu.models import multinomial as mm

    # smoke stays deliberately tiny: with >1 (virtual) device the whole sweep
    # compiles through GSPMD partitioning, which takes minutes on a 1-core
    # host at the full config (VERDICT r2 weak item 5)
    N, G, C, R = (512, 128, 4, 2) if smoke else (100_000, 5_000, 10, 10)
    max_iter = 30 if smoke else 100
    dtype = jnp.float32

    key = jax.random.PRNGKey(0)
    k_data, k_fit = jax.random.split(key)
    Y, L, _z = make_synthetic(k_data, N, G, C, dtype)
    jax.block_until_ready(Y)

    # Y stored int8: EXACT (counts are small integers; prepare_data raises
    # if any count exceeds int8 range) and a quarter of the bytes of f32.
    # Assignments verified identical to the f32 path at this scale.
    data = mm.prepare_data(Y, L, dtype=dtype, y_storage=jnp.int8)
    # z_cheb: the Chebyshev log-normalizer (models/multinomial.py).
    # BENCH_EXACT=1 switches back to the exact likelihood path.
    impl = "auto" if os.environ.get("BENCH_EXACT") == "1" else "z_cheb"
    config = mm.ModelConfig(K=1, P=0, mc_samples=1, likelihood_impl=impl)

    # On a multi-device host the sweep runs mesh-sharded: all devices on the
    # cells axis (data parallel — cells are the unbounded dimension), ELBO /
    # gradient reductions are all-reduces. One device keeps the plain path.
    n_dev = len(jax.devices())
    mesh = None
    if n_dev > 1:
        from clonealign_tpu.parallel.sharding import make_mesh, shard_data

        mesh = make_mesh()
        data = shard_data(data, mesh)

    sweep = build_sweep(config, dtype, max_iter)
    keys = jax.random.split(k_fit, R)

    # compile (excluded from timing)
    out = sweep(keys, data)
    jax.block_until_ready(out)

    # best of 2 timed runs (distinct keys, so no layer can memoize results)
    elapsed = float("inf")
    for rep in (1, 2):
        t0 = time.perf_counter()
        finals, assigned = sweep(jax.random.split(jax.random.fold_in(k_fit, rep), R), data)
        assigned = np.asarray(assigned)
        finals = np.asarray(finals)
        elapsed = min(elapsed, time.perf_counter() - t0)

    cells_per_sec = N * R / elapsed
    hw = f"{n_dev}-device mesh {dict(mesh.shape)}" if mesh else "one device"
    step_s = elapsed / (max_iter * R)
    # HBM traffic: with the restarts VMAPPED, the thin Y contractions batch
    # across all R lanes (Y @ [W_1..W_R]), so Y is read twice per BATCHED
    # step — not per lane. "effective" = that floor divided by the measured
    # batched-step time: how close the step runs to its memory-bound speed
    # of light. (Dividing by the per-LANE time would overstate bandwidth by
    # up to R x.)
    batched_step_s = elapsed / max_iter
    y_bytes = np.dtype(np.int8).itemsize * N * G
    out = {
        "metric": f"cells_assigned_per_sec (100k x 5k x 10, 10 restarts, {hw}, {impl})"
        if not smoke
        else f"cells_assigned_per_sec (smoke, {hw}, {impl})",
        "value": round(cells_per_sec, 1),
        "unit": "cells/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": n_dev,
        "elapsed_s": round(elapsed, 2),
        "vi_steps_per_sec": round(max_iter * R / elapsed, 1),
        "ms_per_step": round(1000 * step_s, 3),
        "effective_GBps": round(2 * y_bytes / batched_step_s / 1e9, 1),
        "config": {"N": N, "G": G, "C": C, "restarts": R, "max_iter": max_iter},
        "final_elbos": [round(float(f), 1) for f in finals],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
