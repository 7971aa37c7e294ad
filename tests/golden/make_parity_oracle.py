"""Regenerate parity_oracle.npz — the CPU float64/float32 oracle fits the
on-device parity checks (chip_smoke.py's parity phase,
tests/test_gpu_hardware.py) compare against.

Run on any CPU host:

    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python tests/golden/make_parity_oracle.py

Both fits are deterministic given the pinned seeds (jax.random threefry is
backend- and machine-independent); regenerate only after a deliberate
semantic change to the model or loop, together with the pins in
tests/test_golden.py.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from clonealign_tpu import clonealign  # noqa: E402
from clonealign_tpu.io.datasets import load_example_sce  # noqa: E402
from clonealign_tpu.synth import simulate_multinomial  # noqa: E402

# Converged-fit configs shared with the device profile: max_iter high enough
# that the sliding-window criterion, not the iteration cap, shapes the end
# state comparably across precisions.
MAX_ITER = 500
CONFIGS = {
    "example": dict(seed=7),
    "synth": dict(seed=11),
    "allele": dict(seed=13),
    "rich": dict(seed=17),
}


def allele_dataset():
    """Expression + SNV data for the allele-specific path (reference
    R/allele-specific.R wired at R/inference-tflow.R:167-187). The SNV
    inputs are SAVED into the oracle npz so the on-chip test fits
    byte-identical arrays — generation determinism never matters."""
    sim = simulate_multinomial(N=1000, G=400, C=3, seed=5, mean_total=1500)
    rng = np.random.default_rng(0)
    V = 200
    C = sim.L.shape[1]
    clone_allele = rng.integers(1, 4, (V, C)).astype(np.float64)
    cov = rng.poisson(8.0, (1000, V)).astype(np.float64)
    # alt fraction ~0.5 where the true clone's CN is 2, imbalanced otherwise
    cn = clone_allele[:, np.asarray(sim.clone_idx)]             # (V, N)
    p = np.where(cn == 2, 0.5, np.where(rng.random(cn.shape) < 0.5, 0.05, 0.95))
    alt = rng.binomial(cov.T.astype(np.int64), p).astype(np.float64)  # (V, N)
    ref = cov - alt.T
    return sim, clone_allele, cov, ref


def rich_dataset():
    """The non-default corner: K=2 latent factors, P=2 covariates,
    mc_samples=3, fix_alpha — the paths that add their own contractions
    (``A1`` + ``X @ beta``, per-sample Z) and their own on-device
    matmul-precision exposure. Covariates are committed into the npz so the
    on-chip test fits byte-identical arrays."""
    sim = simulate_multinomial(N=2000, G=500, C=3, seed=21, mean_total=1500)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2000, 2))
    return sim, x


def datasets():
    sce = load_example_sce()
    sim = simulate_multinomial(N=5000, G=1000, C=4, seed=3, mean_total=2000)
    asim, clone_allele, cov, ref = allele_dataset()
    rsim, rich_x = rich_dataset()
    return {
        "example": (sce.counts, sce.copy_number, {}, {}),
        "synth": (sim.Y, sim.L, {}, {}),
        "allele": (
            np.asarray(asim.Y), np.asarray(asim.L),
            dict(clone_allele=clone_allele, cov=cov, ref=ref), {},
        ),
        "rich": (
            np.asarray(rsim.Y), np.asarray(rsim.L),
            dict(x=rich_x),
            dict(K=2, mc_samples=3, fix_alpha=True),
        ),
    }


def main():
    out = {}
    for name, (Y, L, extra, opts) in datasets().items():
        for dtype, tag in (("float64", "64"), ("float32", "32")):
            fit = clonealign(
                Y, L, max_iter=MAX_ITER, seed=CONFIGS[name]["seed"],
                dtype=dtype, verbose=False, **extra, **opts,
            )
            out[f"{name}_elbo{tag}"] = float(fit.convergence_info.final_elbo)
            out[f"{name}_clone{tag}"] = np.array(list(fit.clone))
            if "clone_allele" in extra:
                out[f"{name}_snv{tag}"] = np.asarray(fit.clone_probs_from_snv)
        # The f32 entries above use the shipped defaults: likelihood_impl
        # "auto" -> z_cheb in the K=1/P=0/S=1 corner ONLY past the ~1M-
        # element size gate (api.setup_fit; round 4). Under the gate,
        # "synth" (5M elements) trains z_cheb; "example" (20k), "allele"
        # (400k) and "rich" (K=2) train exact. Pin the EXACT-normalizer f32
        # path separately on the example data so the on-chip profile keeps
        # covering both backends explicitly.
        if name == "example":
            fit = clonealign(
                Y, L, max_iter=MAX_ITER, seed=CONFIGS[name]["seed"],
                dtype="float32", verbose=False, likelihood_impl="xla",
            )
            out["example_elbo32_xla"] = float(fit.convergence_info.final_elbo)
            out["example_clone32_xla"] = np.array(list(fit.clone))
        if extra:
            # commit the inputs so the device profile fits identical arrays
            out[f"{name}_Y"] = np.asarray(Y, np.int16)
            out[f"{name}_L"] = np.asarray(L)
            for k, v in extra.items():
                out[f"{name}_{k}"] = v
    path = os.path.join(os.path.dirname(__file__), "parity_oracle.npz")
    np.savez(path, **out)
    print("wrote", path)
    for k, v in out.items():
        if np.ndim(v) == 0:
            print(f"  {k} = {v}")


if __name__ == "__main__":
    main()
