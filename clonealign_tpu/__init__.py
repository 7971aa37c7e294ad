"""clonealign-tpu: accelerator-native probabilistic assignment of scRNA-seq
cells to cancer clones, run on NVIDIA GPUs (H100) through JAX and XLA.

A from-scratch JAX/XLA reimplementation of the capabilities of
kieranrcampbell/clonealign (Campbell et al., Genome Biology 2019): clones are
defined by copy-number profiles from shallow scDNA-seq, and cells measured
with scRNA-seq are assigned to them by reparametrization-gradient variational
inference on a multinomial likelihood in which clone-specific gene copy
numbers multiplicatively scale per-gene expression rates.

Public API (mirrors the reference's exported surface, NAMESPACE:3-7):

- :func:`clonealign` — fit a single model
- :func:`run_clonealign` — multi-restart sweep, best-ELBO fit
- :func:`preprocess_for_clonealign` — gene/cell filtering
- :func:`plot_clonealign` — CNV-vs-expression diagnostic plot
- :func:`recompute_clone_assignment` — re-threshold clone calls

Plus the legacy v1 model family (negative-binomial dosage mixture, whose
inference code the reference deleted in v2 — see ``models/negbin.py``):

- :func:`inference_em` — variational-EM fit of the v1 model

And the out-of-HBM scale path (no reference counterpart):

- :func:`fit_streaming` — the same full-batch fit with Y streamed through
  the device one cell chunk at a time (``stream.py``)
"""

from .api import clonealign, saturate
from .assign import (
    clone_assignment,
    compute_ca_fit_mse,
    compute_correlations,
    recompute_clone_assignment,
)
from .cnv import align_expression_to_cnv, cnv_regions_to_genes
from .fit import ClonealignFit, ConvergenceInfo
from .models.negbin import (
    ClonealignV1Fit,
    clone_probs_from_gibbs,
    gibbs_pi_rho,
    inference_em,
    rho_probs_from_gibbs,
)
from .preprocess import preprocess_for_clonealign
from .restarts import run_clonealign
from .serve import assign_cells
from .stream import fit_streaming

__version__ = "0.5.0"

__all__ = [
    "clonealign",
    "run_clonealign",
    "fit_streaming",
    "assign_cells",
    "preprocess_for_clonealign",
    "recompute_clone_assignment",
    "clone_assignment",
    "compute_correlations",
    "compute_ca_fit_mse",
    "align_expression_to_cnv",
    "cnv_regions_to_genes",
    "saturate",
    "ClonealignFit",
    "ConvergenceInfo",
    "inference_em",
    "gibbs_pi_rho",
    "clone_probs_from_gibbs",
    "rho_probs_from_gibbs",
    "ClonealignV1Fit",
    "__version__",
]

try:  # matplotlib is optional
    from .plot import plot_clonealign, plot_clonealign_adata  # noqa: F401

    __all__ += ["plot_clonealign", "plot_clonealign_adata"]
except ImportError:  # pragma: no cover
    pass
