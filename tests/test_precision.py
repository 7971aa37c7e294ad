"""bf16 Y-storage mode: assignments must agree with f32 and the ELBO stay
within bf16 rounding of it (models/multinomial.py prepare_data y_storage)."""

import jax.numpy as jnp
import numpy as np

from clonealign_tpu import clonealign
from clonealign_tpu.models import multinomial as mm
from clonealign_tpu.synth import simulate_multinomial

import pytest

pytestmark = pytest.mark.slow


def test_bf16_storage_assignment_agreement():
    sim = simulate_multinomial(N=80, G=60, C=3, seed=11, mean_total=800)
    f32 = clonealign(sim.Y, sim.L, max_iter=25, seed=0, verbose=False)
    f16 = clonealign(sim.Y, sim.L, max_iter=25, seed=0, verbose=False, y_storage="bfloat16")
    assert f32.clone == f16.clone
    np.testing.assert_allclose(
        f32.convergence_info.final_elbo, f16.convergence_info.final_elbo, rtol=1e-3
    )


def test_prepare_data_downcast_after_stats():
    """Derived statistics are computed at full precision BEFORE the downcast:
    totals/log-binomials must be exact even when Y storage is bf16."""
    rng = np.random.default_rng(0)
    Y = rng.integers(0, 2000, (10, 8)).astype(np.float64)  # counts > bf16-exact range
    L = np.ones((8, 2))
    d16 = mm.prepare_data(Y, L, dtype=jnp.float32, y_storage=jnp.bfloat16)
    d32 = mm.prepare_data(Y, L, dtype=jnp.float32)
    assert d16.Y.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(d16.s), np.asarray(d32.s))
    np.testing.assert_array_equal(np.asarray(d16.log_binom), np.asarray(d32.log_binom))
    np.testing.assert_array_equal(np.asarray(d16.YlogL), np.asarray(d32.YlogL))


def test_int16_storage_is_exact():
    """Integer storage is lossless (bf16 rounds counts > 256): same-key fits
    with int16 storage match plain f32 storage exactly."""
    from clonealign_tpu import clonealign
    from clonealign_tpu.synth import simulate_multinomial

    sim = simulate_multinomial(N=50, G=30, C=3, seed=1, mean_total=3000)
    assert sim.Y.max() > 256  # regime where bf16 would round
    f32 = clonealign(sim.Y, sim.L, max_iter=15, seed=0, verbose=False)
    i16 = clonealign(sim.Y, sim.L, max_iter=15, seed=0, verbose=False, y_storage="int16")
    np.testing.assert_allclose(
        i16.convergence_info.final_elbo, f32.convergence_info.final_elbo, rtol=2e-6
    )
    assert list(i16.clone) == list(f32.clone)


def test_integer_storage_overflow_and_fraction_raise():
    import pytest
    import jax.numpy as jnp
    from clonealign_tpu.models import multinomial as mm

    Y = np.zeros((4, 3))
    Y[0, 0] = 300.0
    L = np.ones((3, 2))
    with pytest.raises(ValueError, match="cannot hold"):
        mm.prepare_data(Y, L, y_storage=jnp.int8)
    mm.prepare_data(Y, L, y_storage=jnp.int16)  # fits
    Yf = Y.copy()
    Yf[1, 1] = 0.5
    with pytest.raises(ValueError, match="fractional"):
        mm.prepare_data(Yf, L, y_storage=jnp.int16)

    import scipy.sparse as sp

    with pytest.raises(ValueError, match="cannot hold"):
        mm.prepare_data(sp.csr_matrix(Y), L, y_storage=jnp.int8)
    d = mm.prepare_data(sp.csr_matrix(Y), L, y_storage=jnp.int16)
    assert d.Y.dtype == jnp.int16


def test_auto_y_storage_selects_narrowest_exact_dtype():
    """y_storage="auto" picks int8/int16 when counts fit, full precision
    otherwise — and, being lossless, matches the default fit exactly."""
    import jax.numpy as jnp
    import numpy as np
    from clonealign_tpu.api import _auto_y_storage

    assert _auto_y_storage(np.array([[0.0, 5.0], [127.0, 1.0]])) == jnp.int8
    assert _auto_y_storage(np.array([[0.0, 128.0]])) == jnp.int16
    assert _auto_y_storage(np.array([[0.0, 40000.0]])) is None
    assert _auto_y_storage(np.array([[0.5, 1.0]])) is None  # fractional
    assert _auto_y_storage(np.zeros((0, 3))) is None

    from clonealign_tpu.synth import simulate_multinomial

    sim = simulate_multinomial(N=50, G=30, C=3, seed=4, mean_total=400)
    auto = clonealign(sim.Y, sim.L, max_iter=15, seed=0, verbose=False, y_storage="auto")
    explicit = clonealign(sim.Y, sim.L, max_iter=15, seed=0, verbose=False, y_storage="int8")
    assert list(auto.clone) == list(explicit.clone)
    np.testing.assert_array_equal(
        np.asarray(auto.ml_params["clone_probs"]),
        np.asarray(explicit.ml_params["clone_probs"]),
    )


def test_chunked_prepare_matches_unchunked_exactly():
    """Above _CHUNK_ELEMENTS prepare_data streams row chunks; every output
    must be bit-identical to the single-pass path."""
    import jax.numpy as jnp
    import numpy as np
    import clonealign_tpu.models.multinomial as mm

    rng = np.random.default_rng(0)
    Y = rng.poisson(3.0, (100, 40)).astype(np.float64)
    Y[0] += 1
    L = rng.integers(1, 5, (40, 3)).astype(np.float64)
    ref = mm.prepare_data(Y, L, dtype=jnp.float32, y_storage=jnp.int8)
    orig = mm._CHUNK_ELEMENTS
    mm._CHUNK_ELEMENTS = 1000  # force ~25-row chunks
    try:
        ch = mm.prepare_data(Y, L, dtype=jnp.float32, y_storage=jnp.int8)
    finally:
        mm._CHUNK_ELEMENTS = orig
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(ch, f)
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
    # overflow still raises through the chunked path
    import pytest

    mm._CHUNK_ELEMENTS = 1000
    try:
        with pytest.raises(ValueError, match="cannot hold"):
            mm.prepare_data(Y * 100, L, y_storage=jnp.int8)
    finally:
        mm._CHUNK_ELEMENTS = orig


@pytest.mark.parametrize(
    "host_dt,storage",
    [
        (np.int16, jnp.int8),     # host downcast to the storage wire
        (np.int8, jnp.int16),     # host already narrower: ship as-is
        (np.int16, None),         # int host, float storage: host-dtype wire
        (np.float64, None),       # f64 host -> f32 wire (stats at f32 anyway)
        (np.float64, jnp.int8),   # float host, int storage: validated downcast
        (np.float32, jnp.int16),
        (np.float64, jnp.bfloat16),  # bf16 rounds on DEVICE from f32 wire
    ],
)
def test_chunked_wire_dtype_matrix(host_dt, storage):
    """The narrow-wire upload (round 4: chunks ship in the fewest exact
    bytes — 2x fewer at int16 host / int8 storage) must be bit-invisible: every ModelData field identical to the
    unchunked path for every (host dtype, y_storage) combination."""
    import clonealign_tpu.models.multinomial as mm

    rng = np.random.default_rng(7)
    Y = rng.poisson(4.0, (90, 30)).astype(host_dt)
    L = rng.integers(1, 5, (30, 3)).astype(np.float64)
    ref = mm.prepare_data(np.asarray(Y), L, dtype=jnp.float32, y_storage=storage)
    orig = mm._CHUNK_ELEMENTS
    mm._CHUNK_ELEMENTS = 600  # force ~20-row chunks
    try:
        ch = mm.prepare_data(np.asarray(Y), L, dtype=jnp.float32, y_storage=storage)
    finally:
        mm._CHUNK_ELEMENTS = orig
    assert ch.Y.dtype == ref.Y.dtype
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(ch, f)
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)


def test_chunked_wire_fractional_raises_before_upload():
    """Fractional 'counts' with integer storage must raise the standard
    message from the HOST pre-check (the downcast would wrap/truncate)."""
    import clonealign_tpu.models.multinomial as mm

    rng = np.random.default_rng(3)
    Y = rng.poisson(3.0, (60, 20)).astype(np.float64)
    Y[5, 7] = 2.5
    L = rng.integers(1, 4, (20, 2)).astype(np.float64)
    orig = mm._CHUNK_ELEMENTS
    mm._CHUNK_ELEMENTS = 400
    try:
        with pytest.raises(ValueError, match="fractional"):
            mm.prepare_data(Y, L, dtype=jnp.float32, y_storage=jnp.int8)
    finally:
        mm._CHUNK_ELEMENTS = orig


def test_negative_counts_raise_on_table_paths():
    """jnp.take CLIPS out-of-range indices, so a negative count would gather
    log(0!) and corrupt silently on the table paths (the lgamma path made it
    a visible inf) — prepare_data must raise instead, on both the in-core
    and the chunked integer-wire paths (api callers validate earlier, but
    sharded_fit calls prepare_data directly)."""
    import clonealign_tpu.models.multinomial as mm

    rng = np.random.default_rng(9)
    Y = rng.poisson(4.0, (60, 25)).astype(np.int16)
    Y[7, 3] = -2
    L = rng.integers(1, 5, (25, 3)).astype(np.float64)
    with pytest.raises(ValueError, match="non-negative"):
        mm.prepare_data(Y, L, dtype=jnp.float32)
    orig = mm._CHUNK_ELEMENTS
    mm._CHUNK_ELEMENTS = 400
    try:
        with pytest.raises(ValueError, match="non-negative"):
            mm.prepare_data(Y, L, dtype=jnp.float32, y_storage=jnp.int16)
    finally:
        mm._CHUNK_ELEMENTS = orig


def test_chunked_bf16_storage_streams_per_chunk():
    """bfloat16 storage ships f32 wire chunks but must NOT hold the full
    f32 matrix alongside the bf16 copy (the very-large-input memory
    contract): the chunked path streams and downcasts per chunk. Pin the
    resulting ModelData against the unchunked path."""
    import clonealign_tpu.models.multinomial as mm

    rng = np.random.default_rng(13)
    Y = rng.poisson(4.0, (90, 30)).astype(np.float64)
    L = rng.integers(1, 5, (30, 3)).astype(np.float64)
    ref = mm.prepare_data(Y, L, dtype=jnp.float32, y_storage=jnp.bfloat16)
    orig = mm._CHUNK_ELEMENTS
    mm._CHUNK_ELEMENTS = 600
    try:
        ch = mm.prepare_data(Y, L, dtype=jnp.float32, y_storage=jnp.bfloat16)
    finally:
        mm._CHUNK_ELEMENTS = orig
    assert ch.Y.dtype == jnp.bfloat16
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(ch, f)
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(
            np.asarray(a, np.float32), np.asarray(b, np.float32), err_msg=f
        )


def test_log_factorial_table_bit_identical_to_lgamma():
    """The table-gather log-binomial (round 4: sidesteps the compile of a
    2-D lgamma) must be BIT-identical to the lgamma
    formulation it replaces: the table is lax.lgamma on the same inputs."""
    import jax
    import clonealign_tpu.models.multinomial as mm

    for dt in (jnp.float32, jnp.float64):
        t = mm._log_factorial_table(127, dt)
        ks = jnp.arange(128, dtype=dt)
        ref = jax.lax.lgamma(ks + 1.0)
        np.testing.assert_array_equal(np.asarray(t), np.asarray(ref))
    # and through prepare_data: identical fields for int-wire vs f32-wire
    # inputs carrying the same values (table vs lgamma path)
    rng = np.random.default_rng(11)
    Y = rng.poisson(4.0, (60, 25))
    L = rng.integers(1, 5, (25, 3)).astype(np.float64)
    via_table = mm.prepare_data(Y.astype(np.int16), L, dtype=jnp.float32)
    via_lgamma = mm.prepare_data(Y.astype(np.float32), L, dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(via_table.log_binom), np.asarray(via_lgamma.log_binom),
        rtol=1e-6,
    )
    for f in ("s", "YlogL", "colsum_Y"):
        np.testing.assert_array_equal(
            np.asarray(getattr(via_table, f)), np.asarray(getattr(via_lgamma, f)),
            err_msg=f,
        )


def test_unchunked_wire_overflow_raises():
    """Integer storage overflow must raise the standard message from the
    HOST pre-check on the unchunked path too (values never wrap)."""
    import clonealign_tpu.models.multinomial as mm

    rng = np.random.default_rng(5)
    Y = rng.poisson(3.0, (40, 12)).astype(np.float64)
    Y[3, 4] = 300.0
    L = rng.integers(1, 4, (12, 2)).astype(np.float64)
    with pytest.raises(ValueError, match="cannot hold the largest"):
        mm.prepare_data(Y, L, dtype=jnp.float32, y_storage=jnp.int8)
    # and from an int host dtype wider than the storage (validated downcast)
    with pytest.raises(ValueError, match="cannot hold the largest"):
        mm.prepare_data(Y.astype(np.int16), L, dtype=jnp.float32,
                        y_storage=jnp.int8)


def test_blocked_init_and_z_match_unblocked():
    """The row-blocked PCA/mu-guess init and the gene-blocked Z contraction
    (large-N memory path) agree with the single-block implementations."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import clonealign_tpu.models.multinomial as mm
    from clonealign_tpu.synth import simulate_multinomial

    sim = simulate_multinomial(N=120, G=50, C=3, seed=2, mean_total=800)
    key = jax.random.PRNGKey(5)
    p_ref = mm.init_params(sim.Y, sim.L, key, K=1, dtype=jnp.float64)
    data = mm.prepare_data(sim.Y, sim.L, dtype=jnp.float64)
    mu_b = mm.sample_mu_base(p_ref, jax.random.PRNGKey(7), 1)
    Z_ref = mm._compute_Z(p_ref, data, mm.softplus(mu_b))

    orig_c, orig_z = mm._CHUNK_ELEMENTS, mm._Z_BLOCK_ELEMENTS
    mm._CHUNK_ELEMENTS, mm._Z_BLOCK_ELEMENTS = 1500, 2000
    try:
        p_blk = mm.init_params(sim.Y, sim.L, key, K=1, dtype=jnp.float64)
        Z_blk = mm._compute_Z(p_ref, data, mm.softplus(mu_b))
    finally:
        mm._CHUNK_ELEMENTS, mm._Z_BLOCK_ELEMENTS = orig_c, orig_z

    # qmu/mu-guess is a pure reordering of sums: near-exact at f64
    np.testing.assert_allclose(
        np.asarray(p_blk.qmu_loc), np.asarray(p_ref.qmu_loc), rtol=1e-12
    )
    # PCA scores: same randomized algorithm, same draws, blocked matmuls —
    # agreement to numerical precision (QR/SVD amplify roundoff slightly)
    np.testing.assert_allclose(
        np.asarray(jnp.abs(p_blk.psi)), np.asarray(jnp.abs(p_ref.psi)), atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(Z_blk), np.asarray(Z_ref), rtol=1e-12)


def test_size_factors_accumulate_in_float64():
    """ml_params['s'] must be float64-accumulated even for float32 dense
    inputs (a float32 running sum drifts at wide G)."""
    from clonealign_tpu import clonealign

    rng = np.random.default_rng(0)
    G = 4096
    Y = np.full((4, G), 0.1, np.float32)
    Y[:, 0] = rng.integers(1, 5, size=4)  # keep rows distinct/nonzero
    L = np.asarray(rng.integers(1, 4, size=(G, 2)), np.float64)
    fit = clonealign(Y, L, max_iter=2, verbose=False, allow_fractional=True)
    expect = Y.astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(fit.ml_params["s"], expect, rtol=1e-12)


def test_size_factors_device_shortcut_integer_counts():
    """For integer-typed device counts with row totals < 2^24, ml_params['s']
    comes from the prepared float32 device sums (bit-exact: partial sums of
    non-negative integers never exceed the total) — pin equality against
    the float64 host accumulation it replaces."""
    from clonealign_tpu import clonealign

    rng = np.random.default_rng(1)
    Y = rng.poisson(50.0, (6, 512)).astype(np.int16)
    L = np.asarray(rng.integers(1, 4, size=(512, 2)), np.float64)
    fit = clonealign(Y, L, max_iter=2, verbose=False)
    expect = Y.astype(np.float64).sum(axis=1)
    np.testing.assert_array_equal(fit.ml_params["s"], expect)
    assert fit.ml_params["s"].dtype == np.float64


def test_size_factors_guard_past_f32_exact_range():
    """Row totals past 2^24 must fall back to the float64 host accumulation
    (the float32 device sums round there) and stay exact."""
    from clonealign_tpu import clonealign

    rng = np.random.default_rng(2)
    G = 600
    Y = np.full((4, G), 32000, np.int16)  # row total ~1.92e7 > 2^24
    Y[:, :8] = rng.integers(1, 2000, size=(4, 8)).astype(np.int16)
    L = np.asarray(rng.integers(1, 4, size=(G, 2)), np.float64)
    fit = clonealign(Y, L, max_iter=2, verbose=False)
    expect = Y.astype(np.float64).sum(axis=1)
    assert float(expect.max()) > 2.0**24
    np.testing.assert_array_equal(fit.ml_params["s"], expect)


def test_auto_restart_batching_scales_with_compute_itemsize():
    """The vmap/map cutover halves its element budget for float64 compute
    (the boundary was measured at float32 intermediates)."""
    from clonealign_tpu.restarts import _auto_restart_batching

    n_elems, lanes = 500_000_000, 10  # measured-fits configuration at f32
    assert _auto_restart_batching(n_elems, lanes, 1, 4) == "vmap"
    assert _auto_restart_batching(n_elems, lanes, 1, 8) == "map"
    # int8 Y storage does not EXPAND the budget past the f32 measurement
    assert _auto_restart_batching(n_elems * 2, lanes, 1, 1) == "map"
    # per-device share: an 8-device mesh restores the vmap choice
    assert _auto_restart_batching(n_elems, lanes, 8, 8) == "vmap"


def test_precision_policy_pinned():
    """The policy measured on the H100 (models/multinomial.py, PERF.md): the
    A group at HIGHEST, the Z normalizer at DEFAULT (TF32 on Hopper meets
    every parity bar). Guards against silent drift unless an experiment
    overrides it through the environment."""
    import os

    from clonealign_tpu.models import multinomial as mm

    if "CLONEALIGN_A_PRECISION" not in os.environ:
        assert mm._A_PRECISION == "highest"
    if "CLONEALIGN_Z_PRECISION" not in os.environ:
        assert mm._Z_PRECISION == "default"
