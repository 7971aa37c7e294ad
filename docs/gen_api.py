"""Regenerate docs/api.md from docstrings.

Usage: python docs/gen_api.py   (writes docs/api.md in place)

Each section lists fully-qualified callables; the generator emits the
signature (truncated for readability) and the first paragraph of the
docstring. Add new public functions here when they land.
"""

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SECTIONS = [
    ("Fitting", [
        "clonealign_tpu.api.clonealign",
        "clonealign_tpu.restarts.run_clonealign",
        "clonealign_tpu.api.setup_fit",
    ]),
    ("Streaming (out-of-HBM) fitting", [
        "clonealign_tpu.stream.fit_streaming",
        "clonealign_tpu.models.multinomial.elbo_cell_terms",
        "clonealign_tpu.models.multinomial.elbo_global_terms",
    ]),
    ("Serving", [
        "clonealign_tpu.serve.assign_cells",
    ]),
    ("Preprocessing & CNV", [
        "clonealign_tpu.preprocess.preprocess_for_clonealign",
        "clonealign_tpu.preprocess.get_outlying_genes",
        "clonealign_tpu.cnv.cnv_regions_to_genes",
        "clonealign_tpu.cnv.align_expression_to_cnv",
        "clonealign_tpu.api.saturate",
    ]),
    ("Clone calling & QC", [
        "clonealign_tpu.assign.clone_assignment",
        "clonealign_tpu.assign.recompute_clone_assignment",
        "clonealign_tpu.assign.compute_correlations",
        "clonealign_tpu.assign.compute_ca_fit_mse",
    ]),
    ("Fit object", [
        "clonealign_tpu.fit.ClonealignFit",
        "clonealign_tpu.fit.ConvergenceInfo",
    ]),
    ("Model internals", [
        "clonealign_tpu.models.multinomial.elbo",
        "clonealign_tpu.models.multinomial.log_p_y_on_c",
        "clonealign_tpu.models.multinomial.init_params",
        "clonealign_tpu.models.multinomial.prepare_data",
        "clonealign_tpu.models.multinomial.gamma_warm_start_logits",
        "clonealign_tpu.models.allele.construct_ai_likelihood",
        "clonealign_tpu.models.allele.beta_binomial_log_prob",
    ]),
    ("Legacy v1 family (negative-binomial dosage mixture)", [
        "clonealign_tpu.models.negbin.inference_em",
        "clonealign_tpu.models.negbin.run_negbin_em",
        "clonealign_tpu.models.negbin.prepare_negbin_data",
        "clonealign_tpu.models.negbin.nb_log_prob",
        "clonealign_tpu.models.negbin.gibbs_pi_rho",
        "clonealign_tpu.models.negbin.clone_probs_from_gibbs",
        "clonealign_tpu.models.negbin.rho_probs_from_gibbs",
        "clonealign_tpu.models.negbin.classify_cells",
        "clonealign_tpu.models.negbin.ClonealignV1Fit",
    ]),
    ("Inference engine", [
        "clonealign_tpu.infer.run_inference",
        "clonealign_tpu.infer.tf1_adam",
    ]),
    ("Parallelism", [
        "clonealign_tpu.parallel.sharding.make_mesh",
        "clonealign_tpu.parallel.sharding.shard_data",
        "clonealign_tpu.parallel.sharding.sharded_fit",
        "clonealign_tpu.parallel.sharding.sharded_negbin_fit",
        "clonealign_tpu.parallel.sharding.negbin_data_shardings",
        "clonealign_tpu.parallel.sharding.param_shardings",
        "clonealign_tpu.parallel.distributed.initialize",
        "clonealign_tpu.parallel.distributed.host_local_to_global",
    ]),
    ("Data IO", [
        "clonealign_tpu.io.datasets.load_example_sce",
        "clonealign_tpu.io.datasets.load_df_cnv",
        "clonealign_tpu.io.datasets.load_example_clonealign_fit",
        "clonealign_tpu.io.mtx.read_mtx",
        "clonealign_tpu.io.mtx.load_cellranger_dir",
        "clonealign_tpu.io.h5.read_h5ad",
        "clonealign_tpu.io.h5.read_10x_h5",
        "clonealign_tpu.io.rds.read_rda",
        "clonealign_tpu.io.rds.read_rds",
        "clonealign_tpu.io.rds.write_rds",
        "clonealign_tpu.fit.ClonealignFit.save_rds",
        "clonealign_tpu.fit.ClonealignFit.load_rds",
    ]),
    ("Synthetic data", [
        "clonealign_tpu.synth.simulate_model3",
        "clonealign_tpu.synth.simulate_multinomial",
        "clonealign_tpu.synth.assignment_accuracy",
    ]),
    ("Plotting", [
        "clonealign_tpu.plot.plot_clonealign",
        "clonealign_tpu.plot.plot_clonealign_adata",
        "clonealign_tpu.plot.plot_elbo",
    ]),
    ("Profiling & caching", [
        "clonealign_tpu.utils.profiling.trace",
        "clonealign_tpu.utils.profiling.timed",
        "clonealign_tpu.utils.cache.enable_persistent_cache",
    ]),
]

SIG_LIMIT = 90


def first_paragraph(doc):
    if not doc:
        return ""
    para = doc.strip().split("\n\n")[0]
    return " ".join(line.strip() for line in para.splitlines())


def entry(qualname):
    # longest importable prefix, then attribute-walk (handles methods)
    parts = qualname.split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        break
    try:
        sig = str(inspect.signature(obj))
    except (TypeError, ValueError):
        sig = "(...)"
    if len(sig) > SIG_LIMIT:
        sig = sig[: SIG_LIMIT - 4] + "...)"
    head = f"### `{qualname}{sig}`"
    return f"{head}\n\n{first_paragraph(inspect.getdoc(obj))}\n"


def main():
    out = ["# clonealign-tpu API reference\n"]
    out.append("*(generated from docstrings by docs/gen_api.py; "
               "first paragraph of each shown)*\n")
    for title, names in SECTIONS:
        out.append(f"\n## {title}\n")
        for n in names:
            out.append(entry(n))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "api.md")
    with open(path, "w") as f:
        f.write("\n".join(out))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
