"""Port parity: the batched solves (``ops/solve``) against the JAX
reference's CPU route, at small shapes, inputs from a numpy seed.

On the CPU both packages run the same factorizations — the floored column
Cholesky and the partially pivoted LU, written as F steps of batched work —
so results agree to float32 accumulation order.  Tolerances and why:
- the Gram: rtol 2e-6 of its largest entry (sums of T = 300 products taken
  in another order: the port's one GEMM with the symmetric Kronecker table
  against XLA's einsum);
- solves of well-conditioned systems: rtol 1e-5 (a few ulp per step of F);
- ridge solves from data: the Gram's rounding (~1e-7 relative) is
  amplified by the system's condition (hinge columns are nearly collinear):
  beta within atol 5e-3, the fitted path within 1e-4 of its scale;
- the floored and non-definite systems: the same factorization, compared
  relative to the solution's largest entry (rtol 1e-4: the floor makes the
  solution ~1e6 times the data, which magnifies rounding the same way);
- Yule-Walker and the MAD scale: rtol 1e-5 / atol 1e-6; the Huber IRLS
  weights within rtol 1e-4 (they are delta s / |r| of the residuals of the
  ridge solves above), its beta as the ridge solves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.ops import features as jf
from distributed_forecasting_tpu.ops import solve as js
from distributed_forecasting_tpu_torch.ops import solve as ts

torch.set_num_threads(1)

BETA_ATOL, FIT_RTOL = 5e-3, 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    S, T = 6, 300
    day = np.arange(16000, 16000 + T, dtype=np.int32)
    X, _ = jf.curve_design_matrix(jnp.asarray(day), 16000.0, float(16000 + T - 1),
                                  n_changepoints=8, yearly_order=4)
    X = np.asarray(X)
    w = (rng.random((S, T)) > 0.1).astype(np.float32)
    y = (np.sin(day / 9.0)[None, :] + 0.3 * rng.normal(size=(S, T))).astype(np.float32)
    y[2, 50] += 25.0  # an outlier for Huber
    # a ridge on every column keeps these systems well conditioned: the
    # model's own near-collinear case is held in test_torch_prophet.py
    lam = np.full(X.shape[1], 0.1, np.float32)
    return dict(X=X, w=w, y=y, lam=lam, rng=rng)


@pytest.mark.parametrize("weights", ["mask", "weighted", "all_zero_row"])
def test_masked_gram_matches_reference(problem, weights):
    X, w = problem["X"], problem["w"].copy()
    if weights == "weighted":
        w = w * np.linspace(0.2, 2.0, w.shape[1], dtype=np.float32)
    elif weights == "all_zero_row":
        w[3] = 0.0
    want = np.asarray(js.masked_gram(jnp.asarray(X), jnp.asarray(w)))
    got = ts.masked_gram(_t(X), _t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())
    np.testing.assert_array_equal(got, np.swapaxes(got, 1, 2))  # symmetric


def test_gram_work_counts_the_symmetric_half():
    ops, nbytes = ts.gram_work(500, 1826, 61)
    assert ops == 2 * 500 * 1826 * 61 * 62 // 2
    assert nbytes == 4 * (500 * 1826 + 1826 * 61 + 500 * 61 * 61)


def _spd(rng, S, F):
    M = rng.normal(size=(S, F, F)).astype(np.float32)
    return (M @ np.swapaxes(M, 1, 2) + F * np.eye(F, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("F", [3, 17, 61])
def test_floored_cholesky_matches_reference(problem, F):
    rng = problem["rng"]
    A = _spd(rng, 5, F)
    b = rng.normal(size=(5, F)).astype(np.float32)
    np.testing.assert_allclose(ts._cholesky_floored(_t(A)).numpy(),
                               np.asarray(js._cholesky_xla(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-6)
    want = np.asarray(js._solve_cholesky_xla(jnp.asarray(A), jnp.asarray(b)))
    got = ts._solve_cholesky_floored(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # on the CPU the public route is the floored factorization
    np.testing.assert_array_equal(ts.batched_cho_solve(_t(A), _t(b)).numpy(), got)


def test_floor_keeps_psd_singular_system_finite(problem):
    """A rank-deficient PSD Gram (two equal columns): the pivot floor
    engages and both packages return the same finite solution."""
    rng = problem["rng"]
    Z = rng.normal(size=(4, 40, 5)).astype(np.float32)
    Z[:, :, 4] = Z[:, :, 3]
    A = (np.swapaxes(Z, 1, 2) @ Z).astype(np.float32)
    b = rng.normal(size=(4, 5)).astype(np.float32)
    want = np.asarray(js._solve_cholesky_xla(jnp.asarray(A), jnp.asarray(b)))
    got = ts._solve_cholesky_floored(_t(A), _t(b)).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["random", "toeplitz_indefinite", "zero_pivot"])
def test_pivoted_lu_matches_reference(problem, kind):
    rng = problem["rng"]
    F = 6
    if kind == "random":
        A = rng.normal(size=(5, F, F)).astype(np.float32)
    elif kind == "toeplitz_indefinite":
        # autocorrelations that no stationary process has: not definite
        r = np.array([1.0, 0.95, -0.9, 0.8, 0.99, -0.7], np.float32)
        idx = np.abs(np.arange(F)[:, None] - np.arange(F)[None, :])
        A = np.stack([r[idx], r[idx] * 2.0 + np.eye(F, dtype=np.float32) * 0.01])
        assert (np.linalg.eigvalsh(A[0]) < 0).any()
    else:
        A = rng.normal(size=(3, F, F)).astype(np.float32)
        A[:, :, 0] = 0.0  # a zero column: the pivot floor engages
    b = rng.normal(size=A.shape[:2]).astype(np.float32)
    want = np.asarray(js._solve_lu_xla(jnp.asarray(A), jnp.asarray(b)))
    got = ts._solve_lu(_t(A), _t(b)).numpy()
    # a zero column leaves a zero on U's diagonal and both packages divide
    # by it in the back substitution: the row is non-finite in both (the
    # reference's masked update also spreads the inf to NaN over the row)
    rows_ok = np.isfinite(want).all(axis=1)
    np.testing.assert_array_equal(np.isfinite(got).all(axis=1), rows_ok)
    assert rows_ok.all() == (kind != "zero_pivot")
    if rows_ok.all():
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(ts.solve_dense(_t(A), _t(b)).numpy(), got)


def _assert_solutions_close(X, got, want):
    """beta within BETA_ATOL; the fitted paths X beta within FIT_RTOL of
    their scale."""
    np.testing.assert_allclose(got, want, rtol=0, atol=BETA_ATOL)
    fj = np.asarray(js.fitted_values(jnp.asarray(X), jnp.asarray(want)))
    ft = ts.fitted_values(_t(X), _t(got)).numpy()
    np.testing.assert_allclose(ft, fj, rtol=0, atol=FIT_RTOL * np.abs(fj).max())


@pytest.mark.parametrize("lam_shape", ["shared", "per_series"])
def test_ridge_solve_matches_reference(problem, lam_shape):
    X, w, y, lam = problem["X"], problem["w"], problem["y"], problem["lam"]
    if lam_shape == "per_series":
        lam = lam[None] * np.linspace(0.5, 2.0, w.shape[0], dtype=np.float32)[:, None]
    want = np.asarray(js.ridge_solve_batch(*map(jnp.asarray, (X, y, w, lam))))
    got = ts.ridge_solve_batch(*map(_t, (X, y, w, lam))).numpy()
    _assert_solutions_close(X, got, want)


def test_per_series_design_solve_matches_reference(problem):
    """The per-series (S, T, F + R) design of the regressor path."""
    X, w, y, lam = problem["X"], problem["w"], problem["y"], problem["lam"]
    rng = problem["rng"]
    S, T = w.shape
    Xs = np.concatenate([np.broadcast_to(X, (S,) + X.shape),
                         rng.normal(size=(S, T, 2)).astype(np.float32)], axis=2)
    lam2 = np.concatenate([lam, np.full(2, 0.01, np.float32)])
    want = np.asarray(js.ridge_solve_batch(*map(jnp.asarray, (Xs, y, w, lam2))))
    got = ts.ridge_solve_batch(*map(_t, (Xs, y, w, lam2))).numpy()
    _assert_solutions_close(Xs, got, want)
    beta = _t(want)
    np.testing.assert_allclose(
        ts.fitted_values(_t(Xs), beta).numpy(),
        np.asarray(js.fitted_values(jnp.asarray(Xs), jnp.asarray(want))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ts.weighted_residual_scale(_t(Xs), _t(y), _t(w), beta).numpy(),
        np.asarray(js.weighted_residual_scale(*map(jnp.asarray, (Xs, y, w, want)))),
        rtol=1e-5)


@pytest.mark.parametrize("per_lag_norm", [False, True])
@pytest.mark.parametrize("K", [1, 3])
def test_yule_walker_matches_reference(problem, per_lag_norm, K):
    y, w = problem["y"], problem["w"]
    kw = dict(per_lag_norm=per_lag_norm, jitter_rel=1e-6, jitter_abs=1e-12)
    cj, aj = js.yule_walker_masked(jnp.asarray(y), jnp.asarray(w), K, **kw)
    ct, at = ts.yule_walker_masked(_t(y), _t(w), K, **kw)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5, atol=1e-6)


def test_mad_scale_and_huber_irls_match_reference(problem):
    X, w, y, lam = problem["X"], problem["w"], problem["y"], problem["lam"]
    w = w.copy()
    w[5] = 0.0  # an all-masked row: scale 0, beta from the prior alone
    np.testing.assert_allclose(
        ts.masked_mad_scale(_t(y), _t(w)).numpy(),
        np.asarray(js.masked_mad_scale(jnp.asarray(y), jnp.asarray(w))),
        rtol=1e-6)
    bj, wj = js.huber_irls_solve(*map(jnp.asarray, (X, y, w, lam)), delta=1.345,
                                 iters=3)
    bt, wt = ts.huber_irls_solve(*map(_t, (X, y, w, lam)), delta=1.345, iters=3)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4, atol=1e-6)
    _assert_solutions_close(X, bt.numpy(), np.asarray(bj))
    assert float(wt[2, 50]) < 0.2  # the outlier is down-weighted
