"""Run clonealign's user path once on an NVIDIA GPU and check every result.

    python chip_smoke.py                 # one card: every phase below
    python chip_smoke.py --only main     # device + main + precision + serving
    python chip_smoke.py --only parity   # device + parity
    python chip_smoke.py --four-cards    # four cards: device + the mesh phase

Phases on one card, in order:

* device    — JAX's first device must be a GPU (there is no CPU fallback).
              Prints its kind, the device count, its ``bytes_limit`` and the
              card's name and power limit from ``nvidia-smi``.
* main      — ``run_clonealign(Y, L)`` on host integer arrays at 100k cells x
              5k genes x 10 clones with the reference defaults (3 shrinks x 3
              repeats, ``max_iter=200``, while loop with early stop, fresh
              ELBO monitoring, ``y_storage`` and ``likelihood_impl`` left at
              "auto"). Checks assignment accuracy against the generator's
              truth and a finite final ELBO; prints wall times and
              ``peak_bytes_in_use``.
* precision — the exact ELBO of the fitted parameters under the shipped
              matmul-precision policy against every contraction at HIGHEST.
* serving   — ``assign_cells`` on 20k new cells from the same generator.
* parity    — converged fits against the committed CPU oracles
              (tests/golden/parity_oracle.npz).

``--four-cards`` runs the main call on the same data over a (cells 4 x
genes 1) mesh, a (cells 2 x genes 2) mesh and one device, and compares
them; no other phase runs.

Everything runs in this one process, which holds the card(s); ``nvidia-smi``
runs as a child that does not touch JAX. The data is made from ``--seed``.
The last line of stdout is ``{"ok": true, "device": {...}}``; a failed phase
makes the script exit non-zero without printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import NamedTuple

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(REPO, "tests", "golden", "parity_oracle.npz")

# The bars every phase is held to.
MIN_ACCURACY = 0.99        # assignment accuracy vs the generator's truth
PRECISION_REL = 1e-4       # shipped precision policy vs all-HIGHEST ELBO
PARITY_REL = 1e-4          # converged f32 ELBO vs the f64 oracle
MESH_ELBO_REL = 2e-5       # mesh vs one-device best final ELBO
MESH_AGREEMENT = 0.999     # mesh vs one-device assignment agreement
PARITY_MAX_ITER = 500      # converged-fit config of make_parity_oracle.py
# q(mu)'s scale is not part of the fit object; the precision phase
# evaluates the fitted location at this fixed scale.
PRECISION_QMU_SCALE = 0.1

FULL_SIZE = dict(cells=100_000, genes=5_000, clones=10, new_cells=20_000)


class CheckFailed(AssertionError):
    pass


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)


class CompileStats:
    """Persistent-cache hits and backend compile seconds, from JAX's own
    monitoring events (registered before the first compile)."""

    def __init__(self):
        import jax.monitoring

        self.hits = 0
        self.written = 0
        self.backend_compile_s = 0.0
        self.saved_s = 0.0
        jax.monitoring.register_event_listener(self._event)
        jax.monitoring.register_event_duration_secs_listener(self._duration)

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.written += 1

    def _duration(self, event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.backend_compile_s += secs
        elif event == "/jax/compilation_cache/compile_time_saved_sec":
            self.saved_s += secs

    def line(self, cache_dir) -> str:
        return (
            f"cache_dir={cache_dir} cache_hits={self.hits} "
            f"entries_written={self.written} "
            f"backend_compile_s={self.backend_compile_s:.2f} "
            f"compile_s_saved_by_cache={self.saved_s:.2f}"
        )


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

class Dataset(NamedTuple):
    Y: np.ndarray          # (cells, genes) int32 counts, the fit's input
    L: np.ndarray          # (genes, clones) copy numbers
    truth: np.ndarray      # (cells,) generating clone
    Y_new: np.ndarray      # (new_cells, genes) int32 counts for serving
    truth_new: np.ndarray  # (new_cells,)


def make_dataset(cells, genes, clones, new_cells, seed) -> Dataset:
    """Cells from the model's own generator (synth.simulate_multinomial),
    held on the host as integer arrays the way a user holds counts. The
    serving cells are further draws of the same generator."""
    from clonealign_tpu.synth import simulate_multinomial

    sim = simulate_multinomial(
        N=cells + new_cells, G=genes, C=clones, seed=seed
    )
    Y = sim.Y.astype(np.int32)
    return Dataset(
        Y=Y[:cells], L=sim.L, truth=np.asarray(sim.clone_idx[:cells]),
        Y_new=Y[cells:], truth_new=np.asarray(sim.clone_idx[cells:]),
    )


def accuracy(clones, clone_names, truth) -> float:
    """Fraction of ALL cells called as their generating clone (an
    unassigned call counts as wrong)."""
    index = {str(c): i for i, c in enumerate(clone_names)}
    called = np.asarray([index.get(str(c), -1) for c in clones])
    return float(np.mean(called == np.asarray(truth)))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(n_cards: int) -> None:
    import jax

    from clonealign_tpu.utils.profiling import gpu_name_and_power_limit

    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu", f"first device is {d.platform!r}, not a GPU")
    check(len(devs) >= n_cards, f"{len(devs)} GPU(s) visible, need {n_cards}")
    check(all(x.platform == "gpu" for x in devs), f"mixed devices: {devs}")
    limit = (d.memory_stats() or {}).get("bytes_limit")
    log("device", f"platform={d.platform} kind={d.device_kind} "
                  f"count={len(devs)} bytes_limit={limit}")
    for line in gpu_name_and_power_limit():
        log("device", f"nvidia-smi: {line}")


def phase_main(data: Dataset, seed: int):
    """The reference-default multi-restart fit, called twice (the second
    call reuses the compiled programs)."""
    import jax

    from clonealign_tpu import run_clonealign

    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        fit = run_clonealign(data.Y, data.L, seed=seed, verbose=False)
        walls.append(time.perf_counter() - t0)
    acc = accuracy(fit.clone, fit.clone_names, data.truth)
    elbo = float(fit.convergence_info.final_elbo)
    info = fit.multirun_info
    log("main", f"cells={data.Y.shape[0]} genes={data.Y.shape[1]} "
                f"clones={data.L.shape[1]} restarts={len(info['elbos'])} "
                f"best_run={info['best_run']} "
                f"n_iters={fit.convergence_info.n_iters}")
    log("main", f"first_call_s={walls[0]:.2f} second_call_s={walls[1]:.2f} "
                f"peak_bytes_in_use="
                f"{(jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')}")
    log("main", f"final_elbo={elbo!r} accuracy={acc:.5f} (bar {MIN_ACCURACY})")
    check(np.isfinite(elbo), f"final ELBO is not finite: {elbo}")
    check(acc >= MIN_ACCURACY, f"accuracy {acc:.5f} < {MIN_ACCURACY}")
    return fit


def fitted_params(fit, dtype):
    """The fit's point estimates as model parameters (see
    PRECISION_QMU_SCALE for q(mu)'s scale)."""
    import jax.numpy as jnp

    from clonealign_tpu.models import multinomial as mm

    ml = fit.ml_params
    G = len(ml["mu"])
    K = ml["W"].shape[1] if "W" in ml else 0

    def arr(x):
        return jnp.asarray(np.asarray(x, np.float64), dtype)

    return mm.CloneAlignParams(
        W=arr(ml["W"]) if K else jnp.zeros((G, 0), dtype),
        chi_unconstr=arr(np.log(ml["chi"])) if K else jnp.zeros((0,), dtype),
        psi=arr(ml["psi"]) if K else jnp.zeros((len(ml["s"]), 0), dtype),
        beta=arr(ml["beta"]) if "beta" in ml else jnp.zeros((G, 0), dtype),
        alpha_unconstr=arr(np.log(ml["alpha"])),
        qmu_loc=arr(mm.safe_inverse_softplus(np.asarray(ml["mu"], np.float64))),
        qmu_log_scale=arr(np.full(G, np.log(PRECISION_QMU_SCALE))),
        gamma_logits=arr(np.log(np.maximum(ml["clone_probs"], 1e-30))),
    )


def exact_elbo(params, data, key, config, precision=None) -> float:
    """mm.elbo through the exact normalizer, traced afresh so the
    module's precision policy (or ``precision`` for every contraction) is
    the one in force."""
    import jax

    from clonealign_tpu.models import multinomial as mm

    config = config._replace(likelihood_impl="xla")
    saved = mm._A_PRECISION, mm._Z_PRECISION
    try:
        if precision is not None:
            mm._A_PRECISION = mm._Z_PRECISION = precision
        with jax.default_matmul_precision(precision or "default"):
            fn = jax.jit(lambda p, d, k: mm.elbo(p, d, k, config))
            return float(fn(params, data, key))
    finally:
        mm._A_PRECISION, mm._Z_PRECISION = saved


def phase_precision(fit, data: Dataset, seed: int) -> None:
    import jax

    from clonealign_tpu.api import setup_fit
    from clonealign_tpu.models import multinomial as mm

    ctx = setup_fit(data.Y, data.L, verbose=False)
    params = fitted_params(fit, ctx.jdtype)
    key = jax.random.PRNGKey(seed)
    shipped = exact_elbo(params, ctx.data, key, ctx.config)
    highest = exact_elbo(params, ctx.data, key, ctx.config, "highest")
    rel = abs(shipped - highest) / abs(highest)
    log("precision", f"policy A={mm._A_PRECISION} Z={mm._Z_PRECISION} "
                     f"y_storage={ctx.data.Y.dtype}")
    log("precision", f"elbo_shipped={shipped!r} elbo_highest={highest!r} "
                     f"rel_diff={rel:.3e} (bar {PRECISION_REL})")
    check(np.isfinite(shipped) and np.isfinite(highest), "ELBO not finite")
    check(rel <= PRECISION_REL, f"rel diff {rel:.3e} > {PRECISION_REL}")


def phase_serving(fit, data: Dataset) -> None:
    from clonealign_tpu.serve import assign_cells

    keep = np.asarray(fit.retained_genes)
    Y_new = data.Y_new[:, keep]
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        clones, probs = assign_cells(fit, Y_new, data.L[keep])
        walls.append(time.perf_counter() - t0)
    acc = accuracy(clones, fit.clone_names, data.truth_new)
    log("serving", f"new_cells={Y_new.shape[0]} first_call_s={walls[0]:.3f} "
                   f"second_call_s={walls[1]:.3f}")
    log("serving", f"accuracy={acc:.5f} (bar {MIN_ACCURACY})")
    check(probs.shape == (Y_new.shape[0], data.L.shape[1]), "probs shape")
    check(acc >= MIN_ACCURACY, f"accuracy {acc:.5f} < {MIN_ACCURACY}")


# --- parity against the committed CPU oracles ------------------------------

def _fit_summary(fit):
    return (
        float(fit.convergence_info.final_elbo),
        np.array(list(fit.clone)),
        fit.ml_params["clone_probs"],
        float(fit.convergence_info.sd_final_elbo),
    )


def parity_problems(name, elbo, clone, probs, oracle, sd=0.0, tag="32"):
    """Compare a float32 fit with the oracles. The bars: final ELBO within
    max(1e-4 relative, 3 x the fit's own final-ELBO sd) of the f64 oracle
    (the reported ELBO is a mean of 20 stochastic evaluations, so its own
    MC noise floors the achievable agreement); labels equal to the CPU f32
    oracle; against the f64 oracle, flips only at the 0.95 call threshold
    (max prob within 0.01 of it). Returns (metrics, problems)."""
    e64 = float(oracle[f"{name}_elbo64"])
    tol = max(PARITY_REL * abs(e64), 3.0 * sd)
    c32 = oracle[f"{name}_clone{tag}"]
    c64 = oracle[f"{name}_clone64"]
    flips32 = int((clone != c32).sum())
    flips64 = np.flatnonzero(clone != c64)
    off_boundary = [i for i in flips64 if abs(probs[i].max() - 0.95) >= 0.01]
    metrics = dict(
        rel_err=abs(elbo - e64) / abs(e64), bar_rel=tol / abs(e64),
        flips_vs_f32=flips32, flips_vs_f64=len(flips64),
        off_boundary_flips=len(off_boundary),
    )
    problems = []
    if not abs(elbo - e64) < tol:
        problems.append(f"ELBO {elbo} vs f64 {e64} (|diff| {abs(elbo - e64):.3g}"
                        f" > tol {tol:.3g})")
    if flips32:
        problems.append(f"{flips32} label flips vs the CPU f32 oracle")
    if off_boundary:
        problems.append(f"{len(off_boundary)} flips vs f64 off the 0.95 boundary")
    return metrics, problems


def _example():
    from clonealign_tpu.io.datasets import load_example_sce

    sce = load_example_sce()
    return sce.counts, sce.copy_number


def _synth5k():
    from clonealign_tpu.synth import simulate_multinomial

    sim = simulate_multinomial(N=5000, G=1000, C=4, seed=3, mean_total=2000)
    return sim.Y, sim.L


def _converged(Y, L, seed, **kw):
    from clonealign_tpu import clonealign

    return clonealign(Y, L, max_iter=PARITY_MAX_ITER, seed=seed,
                      dtype="float32", verbose=False, **kw)


def _case(name, fit, oracle, tag="32"):
    elbo, clone, probs, sd = _fit_summary(fit)
    return parity_problems(name, elbo, clone, probs, oracle, sd, tag)


def parity_cases():
    """name -> callable(oracle) returning (metrics, problems)."""

    def example(oracle):
        """Reference data: 200 cells x 100 genes x 3 clones."""
        return _case("example", _converged(*_example(), 7), oracle)

    def synth5k(oracle):
        return _case("synth", _converged(*_synth5k(), 11), oracle)

    def allele(oracle):
        fit = _converged(
            oracle["allele_Y"], oracle["allele_L"], 13,
            clone_allele=oracle["allele_clone_allele"],
            cov=oracle["allele_cov"], ref=oracle["allele_ref"],
        )
        metrics, problems = _case("allele", fit, oracle)
        snv = np.asarray(fit.clone_probs_from_snv)
        if not np.allclose(snv, oracle["allele_snv32"], rtol=1e-3, atol=1e-4):
            problems.append("SNV clone probabilities differ from the f32 oracle")
        return metrics, problems

    def rich(oracle):
        """K=2 latent factors, P=2 covariates, mc_samples=3, fix_alpha."""
        fit = _converged(oracle["rich_Y"], oracle["rich_L"], 17,
                         x=oracle["rich_x"], K=2, mc_samples=3, fix_alpha=True)
        return _case("rich", fit, oracle)

    def streaming(oracle):
        """fit_streaming reproduces the in-core fit."""
        from clonealign_tpu import clonealign
        from clonealign_tpu.stream import fit_streaming

        Y, L = _example()
        kw = dict(max_iter=60, seed=7, dtype="float32", verbose=False)
        core = clonealign(Y, L, **kw)
        strm = fit_streaming(Y, L, chunk_cells=80, **kw)
        e0 = float(core.convergence_info.final_elbo)
        e1 = float(strm.convergence_info.final_elbo)
        flips = int(sum(a != b for a, b in zip(strm.clone, core.clone)))
        rel = abs(e1 - e0) / abs(e0)
        problems = []
        if flips:
            problems.append(f"{flips} label flips vs the in-core fit")
        if not rel < PARITY_REL:
            problems.append(f"ELBO rel diff {rel:.3e} vs the in-core fit")
        return dict(rel_err=rel, bar_rel=PARITY_REL, flips=flips), problems

    def exact(oracle):
        """The exact normalizer, explicitly requested, on the example."""
        fit = _converged(*_example(), 7, likelihood_impl="xla")
        metrics, problems = _case("example", fit, oracle, tag="32_xla")
        # this path's bar is the plain 1e-4, without the sd floor
        if not metrics["rel_err"] < PARITY_REL:
            problems.append(f"ELBO rel err {metrics['rel_err']:.3e} >= {PARITY_REL}")
        return metrics, problems

    def z_cheb(oracle):
        """The Chebyshev normalizer, explicitly requested, on the 5k
        synthetic (the smallest oracle config past the auto size gate)."""
        return _case("synth", _converged(*_synth5k(), 11,
                                         likelihood_impl="z_cheb"), oracle)

    return dict(example=example, synth5k=synth5k, allele=allele, rich=rich,
                streaming=streaming, exact=exact, z_cheb=z_cheb)


def z_cheb_on_example(oracle) -> dict:
    """A measurement, not a bar: explicit z_cheb on the 200 x 100 example,
    below the size gate that routes "auto" there to the exact path."""
    fit = _converged(*_example(), 7, likelihood_impl="z_cheb")
    metrics, _ = _case("example", fit, oracle)
    return metrics


def phase_parity(names=None) -> None:
    oracle = np.load(ORACLE, allow_pickle=True)
    cases = parity_cases()
    failed = []
    for name in names or list(cases):
        t0 = time.perf_counter()
        metrics, problems = cases[name](oracle)
        wall = time.perf_counter() - t0
        shown = " ".join(
            f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
            for k, v in metrics.items()
        )
        log("parity", f"{name} {shown} wall_s={wall:.2f} "
                      f"{'ok' if not problems else 'FAIL: ' + '; '.join(problems)}")
        if problems:
            failed.append(name)
    if names is None:
        m = z_cheb_on_example(oracle)
        log("parity", f"z_cheb_on_example (measured, no bar) "
                      f"rel_err={m['rel_err']:.3e} flips_vs_f32={m['flips_vs_f32']}")
    check(not failed, f"parity failed: {failed}")


def phase_four_cards(data: Dataset, seed: int) -> None:
    """One run_clonealign call over two meshes of four devices and on one
    device, the same data and seed; the meshes must agree with one device."""
    import jax

    from clonealign_tpu import run_clonealign
    from clonealign_tpu.parallel.sharding import make_mesh

    devs = jax.devices()[:4]
    check(len(devs) == 4, f"{len(devs)} devices visible, need 4")
    layouts = [
        ("cells4_genes1", make_mesh(devs)),
        ("cells2_genes2", make_mesh(devs, gene_parallelism=2)),
        ("one_device", None),
    ]
    fits = {}
    for name, mesh in layouts:
        t0 = time.perf_counter()
        fit = run_clonealign(data.Y, data.L, mesh=mesh, seed=seed, verbose=False)
        wall = time.perf_counter() - t0
        fits[name] = fit
        acc = accuracy(fit.clone, fit.clone_names, data.truth)
        log("four_cards", f"{name} wall_s={wall:.2f} "
                          f"final_elbo={float(fit.convergence_info.final_elbo)!r} "
                          f"n_iters={fit.convergence_info.n_iters} "
                          f"accuracy={acc:.5f}")
        check(acc >= MIN_ACCURACY, f"{name}: accuracy {acc:.5f} < {MIN_ACCURACY}")
    ref = fits["one_device"]
    e_ref = float(ref.convergence_info.final_elbo)
    for name, _ in layouts[:2]:
        fit = fits[name]
        e = float(fit.convergence_info.final_elbo)
        rel = abs(e - e_ref) / abs(e_ref)
        agree = float(np.mean(np.asarray(fit.clone) == np.asarray(ref.clone)))
        log("four_cards", f"{name} vs one_device: elbo_rel_diff={rel:.3e} "
                          f"(bar {MESH_ELBO_REL}) agreement={agree:.5f} "
                          f"(bar {MESH_AGREEMENT})")
        check(rel <= MESH_ELBO_REL, f"{name}: ELBO rel diff {rel:.3e}")
        check(agree >= MESH_AGREEMENT, f"{name}: agreement {agree:.5f}")


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def run_phases(only, four_cards, size, seed) -> list[str]:
    """Run the selected phases after the device phase; return the names of
    the phases that failed. A phase that needs the main fit is skipped
    (and counted as failed) when the main phase failed."""
    failed = []

    def attempt(name, fn, *args):
        try:
            return fn(*args)
        except Exception:
            traceback.print_exc()
            log(name, "FAILED")
            failed.append(name)
            return None

    need_data = four_cards or only in (None, "main")
    data = None
    if need_data:
        if four_cards:  # no serving phase: no new cells
            size = dict(size, new_cells=0)
        t0 = time.perf_counter()
        data = make_dataset(seed=seed, **size)
        log("data", f"generate_s={time.perf_counter() - t0:.2f} "
                    f"Y={data.Y.shape} {data.Y.dtype} Y_new={data.Y_new.shape}")
    if four_cards:
        attempt("four_cards", phase_four_cards, data, seed)
        return failed
    if only in (None, "main"):
        fit = attempt("main", phase_main, data, seed)
        for name, fn, args in (
            ("precision", phase_precision, (data, seed)),
            ("serving", phase_serving, (data,)),
        ):
            if fit is None:
                log(name, "SKIPPED: the main phase failed")
                failed.append(name)
            else:
                attempt(name, fn, fit, *args)
    if only in (None, "parity"):
        attempt("parity", phase_parity)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--only", choices=("main", "parity"),
                    help="run the device phase and only this group")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX's first device is on platform "
              f"{dev.platform!r}); this script checks the card and has no "
              "CPU fallback", file=sys.stderr)
        return 1
    stats = CompileStats()
    from clonealign_tpu.utils.cache import enable_persistent_cache

    cache_dir = enable_persistent_cache()
    t_start = time.perf_counter()
    n_cards = 4 if args.four_cards else 1
    try:
        phase_device(n_cards)
    except Exception:
        traceback.print_exc()
        return 1
    failed = run_phases(args.only, args.four_cards, FULL_SIZE, args.seed)
    log("compile", stats.line(cache_dir))
    log("total", f"wall_s={time.perf_counter() - t_start:.1f}")
    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
