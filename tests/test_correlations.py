"""compute_correlations against hand-computed values (reference
R/clonealign.R:318-334 semantics: z-score expression over assigned cells,
Pearson r against the assigned clone's copy number, NaN where degenerate)."""

import numpy as np

from clonealign_tpu.assign import compute_correlations


def test_hand_computed_example():
    # 4 cells, 2 genes, 2 clones; one cell unassigned
    Y = np.array([
        [1.0, 10.0],
        [2.0, 20.0],
        [3.0, 30.0],
        [9.0, 90.0],  # unassigned -> dropped
    ])
    L = np.array([
        [1.0, 3.0],   # gene 0 CN per clone
        [2.0, 2.0],   # gene 1: same CN both clones
    ])
    clones = ["A", "A", "B", "unassigned"]
    out = compute_correlations(Y, L, clones, ["A", "B"])

    # gene 0: x = CN of assigned clone = [1,1,3]; y = z-scored [1,2,3]
    x = np.array([1.0, 1.0, 3.0])
    y = np.array([1.0, 2.0, 3.0])
    y = (y - y.mean()) / y.std(ddof=1)
    expected = np.corrcoef(x, y)[0, 1]
    np.testing.assert_allclose(out[0], expected, rtol=1e-12)

    # gene 1: x = [2,2,2] constant -> NaN (R cor returns NA)
    assert np.isnan(out[1])


def test_all_unassigned_gives_nan():
    Y = np.ones((3, 2))
    L = np.ones((2, 2))
    out = compute_correlations(Y, L, ["unassigned"] * 3, ["A", "B"])
    assert np.isnan(out).all()


def test_zero_variance_expression_nan():
    Y = np.array([[5.0, 1.0], [5.0, 2.0], [5.0, 3.0]])
    L = np.array([[1.0, 2.0], [1.0, 3.0]])
    out = compute_correlations(Y, L, ["A", "B", "B"], ["A", "B"])
    assert np.isnan(out[0])  # constant expression
    assert np.isfinite(out[1])


def test_compute_correlations_coo_input():
    """COO sparse input works (regression: row masking ran before tocsr)."""
    import numpy as np
    import scipy.sparse as sp

    from clonealign_tpu.assign import compute_correlations

    rng = np.random.default_rng(0)
    Y = rng.poisson(3, (30, 12)).astype(float)
    L = rng.integers(1, 5, (12, 3)).astype(float)
    clones = ["A", "B", "C", "unassigned"] * 7 + ["A", "B"]
    dense = compute_correlations(Y, L, clones, ["A", "B", "C"])
    coo = compute_correlations(sp.coo_matrix(Y), L, clones, ["A", "B", "C"])
    np.testing.assert_allclose(coo, dense, rtol=1e-12, equal_nan=True)


def test_device_path_matches_host():
    """The accelerator sufficient-statistics path (assign._clone_sums_device
    — used by the fit drivers when Y is device-resident; replaces a host
    pass over all of N x G) must
    reproduce the host pass: bit-comparably at float64 residency, and to QC
    precision for int8-stored counts."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    Y = rng.poisson(4, (57, 23)).astype(float)
    L = rng.integers(1, 5, (23, 3)).astype(float)
    clones = (["A", "B", "C", "unassigned"] * 15)[:57]
    names = ["A", "B", "C"]
    host = compute_correlations(Y, L, clones, names)
    dev64 = compute_correlations(
        Y, L, clones, names, device_Y=jnp.asarray(Y, jnp.float64)
    )
    np.testing.assert_allclose(dev64, host, rtol=1e-12, equal_nan=True)
    dev8 = compute_correlations(
        Y, L, clones, names, device_Y=jnp.asarray(Y, jnp.int8)
    )
    np.testing.assert_allclose(dev8, host, rtol=1e-5, atol=1e-7, equal_nan=True)


def test_device_path_cancellation_guard():
    """var_y = sum_y2 - sum_y^2/M cancels catastrophically in the f32 device
    sums for a near-constant high-mean gene; such genes are recomputed
    exactly on the host (and a truly constant gene must stay NaN, like R's
    cor). float32 device residency is the production configuration."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    N = 400
    Y = rng.poisson(4, (N, 4)).astype(float)
    Y[:, 0] = 10001.0                      # constant high-mean -> var 0 -> NaN
    Y[:, 1] = 10001.0                      # near-constant high-mean
    Y[rng.integers(0, N, 5), 1] += 1.0
    L = rng.integers(1, 5, (4, 3)).astype(float)
    clones = (["A", "B", "C"] * N)[:N]
    names = ["A", "B", "C"]
    host = compute_correlations(Y, L, clones, names)
    dev32 = compute_correlations(
        Y, L, clones, names, device_Y=jnp.asarray(Y, jnp.float32)
    )
    assert np.isnan(host[0]) and np.isnan(dev32[0])
    np.testing.assert_allclose(dev32, host, rtol=1e-6, atol=1e-9, equal_nan=True)


def test_device_path_all_unassigned():
    import jax.numpy as jnp

    Y = np.ones((3, 2))
    L = np.ones((2, 2))
    out = compute_correlations(
        Y, L, ["unassigned"] * 3, ["A", "B"], device_Y=jnp.asarray(Y)
    )
    assert np.isnan(out).all()
