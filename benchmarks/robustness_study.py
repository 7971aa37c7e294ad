"""Model-misspecification robustness study.

The clonealign paper's central simulation asks: what fraction of genes must
actually follow the copy-number-dosage relationship for clone assignment to
remain valid? (Reference docstring: "comprehensive simulations regarding the
robustness of the model to mis-specification", R/clonealign.R:141-144; the
generator is the model3 spec, inst/create_model3_synthetic.R:8, where rho_g
is the per-gene dosage indicator.)

This sweeps the dosage fraction and reports assignment accuracy per level:
one JSON line per level, each naming the device; optional accuracy curve
PNG with --plot.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def simulate_with_dosage_fraction(frac, N=500, G=300, C=4, seed=0):
    """model3-style NB data where exactly `frac` of genes follow dosage."""
    rng = np.random.default_rng(seed)
    n_dosage = int(round(frac * G))
    rho = np.zeros(G, int)
    rho[rng.permutation(G)[:n_dosage]] = 1
    pi = rng.integers(0, C, N)
    mu = rng.uniform(1, 2, G)
    phi = rng.gamma(4, 1, G)
    L = rng.integers(1, C + 1, (G, C)).astype(np.float64)
    Lp = L / L.mean(axis=0, keepdims=True)
    s = rng.uniform(500, 10_000, N)
    m = s[:, None] * ((1 - rho)[None, :] * mu[None, :] + (rho * mu)[None, :] * Lp[:, pi].T)
    p = phi[None, :] / (phi[None, :] + m)
    Y = rng.negative_binomial(np.broadcast_to(phi[None, :], m.shape), p).astype(np.float64)
    Y[Y.sum(axis=1) == 0, 0] += 1
    return Y, L, pi


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fractions", default="0.1,0.2,0.3,0.5,0.7,0.9,1.0")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args()

    from clonealign_tpu import clonealign
    from clonealign_tpu.synth import assignment_accuracy
    from clonealign_tpu.utils.cache import enable_persistent_cache
    from clonealign_tpu.utils.profiling import device_label

    enable_persistent_cache()

    fractions = [float(f) for f in args.fractions.split(",")]
    results = []
    for frac in fractions:
        accs = []
        for r in range(args.repeats):
            Y, L, pi = simulate_with_dosage_fraction(frac, seed=100 * r + 7)
            fit = clonealign(Y, L, max_iter=150, seed=r, verbose=False)
            accs.append(assignment_accuracy(fit.clone, fit.clone_names, pi))
        row = {
            "dosage_fraction": frac,
            "accuracy_mean": round(float(np.mean(accs)), 4),
            "accuracy_min": round(float(np.min(accs)), 4),
            "repeats": args.repeats,
        }
        row["hw"] = device_label()
        results.append(row)
        print(json.dumps(row), flush=True)

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        xs = [r["dosage_fraction"] for r in results]
        ys = [r["accuracy_mean"] for r in results]
        lo = [r["accuracy_min"] for r in results]
        fig, ax = plt.subplots(figsize=(5, 3.2), constrained_layout=True)
        ax.plot(xs, ys, "o-", lw=2)
        ax.fill_between(xs, lo, ys, alpha=0.2)
        ax.set_xlabel("Fraction of genes following CN dosage")
        ax.set_ylabel("Assignment accuracy")
        ax.set_ylim(0, 1.05)
        ax.axhline(1 / 4, ls=":", c="gray", lw=1)  # chance level (C=4)
        fig.savefig("robustness_study.png", dpi=130)
        print("wrote robustness_study.png")


if __name__ == "__main__":
    main()
