"""GPU verification profile: converged-fit correctness on the card.

Run on a GPU host, one process per card, with::

    CLONEALIGN_GPU_TESTS=1 python -m pytest tests/test_gpu_hardware.py -m gpu -q

(conftest.py skips its CPU/x64 forcing under CLONEALIGN_GPU_TESTS=1.) The
same checks run, in-process, as the parity phase of ``python chip_smoke.py``,
which is the usual way to run them on the card.

What this proves, against the committed CPU oracles
(tests/golden/parity_oracle.npz, regenerated by
tests/golden/make_parity_oracle.py): with the shipped matmul-precision
policy (models/multinomial.py), converged float32 fits on the card land
within max(1e-4 relative, 3 x the fit's own final-ELBO sd) of the float64
oracle on the bundled reference data, a 5k x 1k synthetic, the
allele-specific joint fit and a K=2/P=2/S=3 rich config; their labels match
the CPU float32 oracle exactly, and differ from the float64 oracle only at
the 0.95 call threshold; the streaming fit reproduces the in-core fit; and
the exact and z_cheb normalizers, each requested explicitly, meet the same
bars.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def gpu():
    """Decided per test, never at import: every worker collects the same
    tests, and they skip where JAX finds no GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (CLONEALIGN_GPU_TESTS=1 on a GPU host)")


@pytest.fixture(scope="module")
def oracle():
    return np.load(cs.ORACLE, allow_pickle=True)


@pytest.mark.parametrize("name", list(cs.parity_cases()))
def test_fit_parity_on_gpu(name, oracle):
    metrics, problems = cs.parity_cases()[name](oracle)
    assert not problems, (name, metrics, problems)
