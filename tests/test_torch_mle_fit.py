"""Port parity: the MLE fit kernel's plain twin (``models/arima.
mle_fit_reference``: the map's Jacobian columns, the filter's tangents along
them, the loss's gradient, Adam) and its wrapper ``ops/kalman.arima_mle_fit``
on the CPU, against the JAX reference.

Tolerances and why:
- The map's Jacobian columns (``_pacf_jacobian`` / ``_pacf_directions``)
  against ``jax.jacfwd`` of the reference's ``_pacf_to_coef``: 1e-6
  absolute.  Both carry tanh and the Durbin-Levinson recursion forward in
  float32; the derivative of tanh is written (1 - t)(1 + t) on both sides,
  and the recursion's products are the same, so only the order of a few
  adds differs.  The coefficients themselves are bitwise the port's
  ``_pacf_to_coef``.
- The fit (30 Adam steps, T 120) against the reference's ``fit_one``
  (optax's Adam on ``jax.value_and_grad`` of ``nll_one``) on the same
  rows: phi and theta within 1e-5 (the fit tests' ``FIT_COEF_TOL``), u
  within 1e-4.  Adam's update is the reference's, so only the gradient's
  rounding is left.
- Rows alone: a row's fit does not depend on the other rows (every
  operation is elementwise in the row), so a row with a non-finite
  gradient, an all-masked row and a fit of the rows one by one are held
  bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_forecasting_tpu.models import arima as ja
from distributed_forecasting_tpu_torch.models import arima as ta
from distributed_forecasting_tpu_torch.ops import kalman as tk
from distributed_forecasting_tpu_torch.ops import optim as topt

torch.set_num_threads(1)

MAP_TOL = 1e-6
FIT_COEF_TOL = 1e-5
FIT_U_TOL = 1e-4
STEPS = 30
T = 120
LR, PRIOR = 0.05, 1.0


def _rows(seed, S=5):
    """Centered, masked rows of an ARMA(2, 1) path: row 0 with 10% of cells
    masked, row 1 with one observation, row 2 all masked, rows 3-4 fully
    observed (row 4 scaled by 50).  Returns (zc, zmask) as numpy."""
    rng = np.random.default_rng(seed)
    burn = 50
    e = rng.normal(size=(S, T + burn))
    z = np.zeros((S, T + burn))
    for t in range(2, T + burn):
        z[:, t] = 0.5 * z[:, t - 1] - 0.2 * z[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1]
    z = z[:, burn:] * 2.0
    z[4] *= 50.0
    m = np.ones((S, T), np.float32)
    m[0] = rng.random(T) >= 0.1
    m[1] = 0
    m[1, 60] = 1
    m[2] = 0
    z = (z - z.mean(axis=1, keepdims=True)) * m
    return z.astype(np.float32), m


def _reference_u(z, m, p, q, steps):
    """The reference's MLE fit of each row (``distributed_forecasting_tpu/
    models/arima.py``'s ``nll_one`` and ``fit_one``: optax's Adam on
    ``jax.value_and_grad``, a non-finite gradient zeroed), returning u."""
    r = max(p, q + 1, 1)
    cfg = ja.ArimaConfig(p=p, q=q, method="mle")

    def nll_one(u, zs, ms):
        phi = ja._pacf_to_coef(u[:p]) if p else jnp.zeros((0,))
        theta = ja._pacf_to_coef(u[p:p + q]) if q else jnp.zeros((0,))
        ssq, ldet, n, *_ = ja._kalman_loglik(zs, ms, phi, theta, r)
        n = jnp.maximum(n, 1.0)
        prior = 0.5 * jnp.sum((u / cfg.prior_scale) ** 2)
        return (0.5 * n * jnp.log(jnp.maximum(ssq / n, ja._EPS))
                + 0.5 * ldet + prior)

    opt = optax.adam(LR)

    def fit_one(u, zs, ms):
        state = opt.init(u)
        grad_fn = jax.value_and_grad(nll_one)

        def step_fn(carry, _):
            u, state = carry
            _, g = grad_fn(u, zs, ms)
            g = jnp.where(jnp.isfinite(g), g, 0.0)
            updates, state = opt.update(g, state)
            return (optax.apply_updates(u, updates), state), None

        (u, _), _ = jax.lax.scan(step_fn, (u, state), None, length=steps)
        return u

    u0 = jnp.zeros((z.shape[0], p + q))
    return np.asarray(jax.vmap(fit_one)(u0, jnp.asarray(z), jnp.asarray(m)))


@pytest.mark.parametrize("p, q", [(2, 1), (1, 2), (3, 0), (0, 2)],
                         ids=["21", "12", "30", "02"])
def test_map_jacobian_columns_match_jax_jacfwd(p, q):
    r = max(p, q + 1, 1)
    rng = np.random.default_rng(p * 10 + q)
    u = (rng.normal(size=(6, p + q)) * 0.8).astype(np.float32)
    u[0, :1] = 2.5  # |PACF| 0.987: near the boundary
    ut = torch.from_numpy(u)
    phi, theta, dph, dRv = ta._pacf_directions(ut, p, q, r)
    # the coefficients are the port's map, bit for bit
    assert torch.equal(phi, ta._pacf_to_coef(ut[:, :p]))
    assert torch.equal(theta, ta._pacf_to_coef(ut[:, p:]))
    assert dph.shape == dRv.shape == (6, p + q, r)

    def coefs(uu):
        ph = ja._pacf_to_coef(uu[:p]) if p else jnp.zeros((0,))
        th = ja._pacf_to_coef(uu[p:]) if q else jnp.zeros((0,))
        return ph, th

    jph, jth = jax.vmap(jax.jacfwd(coefs))(jnp.asarray(u))  # (S, p|q, k)
    want_dph = np.zeros((6, p + q, r), np.float32)
    want_dph[:, :, :p] = np.swapaxes(np.asarray(jph), 1, 2)
    want_dRv = np.zeros((6, p + q, r), np.float32)
    want_dRv[:, :, 1:q + 1] = np.swapaxes(np.asarray(jth), 1, 2)
    np.testing.assert_allclose(dph.numpy(), want_dph, rtol=0, atol=MAP_TOL)
    np.testing.assert_allclose(dRv.numpy(), want_dRv, rtol=0, atol=MAP_TOL)
    # an AR coordinate moves no MA coefficient, and the reverse
    assert not dph[:, p:].any() and not dRv[:, :p].any()
    assert not dRv[..., 0].any()


@pytest.mark.parametrize("p, q", [(2, 1), (1, 0), (0, 2), (0, 1)],
                         ids=["21", "10", "02", "01"])
def test_fit_twin_matches_reference_fit_one(p, q):
    """k = 1 included ((1, 0), (0, 1)); the all-masked row stays at u = 0
    on both sides."""
    r = max(p, q + 1, 1)
    z, m = _rows(seed=p * 3 + q)
    got = tk.arima_mle_fit(torch.from_numpy(z), torch.from_numpy(m), p, q, r,
                           STEPS, LR, PRIOR)  # CPU: the twin
    want = _reference_u(z, m, p, q, STEPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FIT_U_TOL)
    for sl in (slice(0, p), slice(p, p + q)):
        np.testing.assert_allclose(
            ta._pacf_to_coef(got[:, sl]).numpy(),
            np.asarray(jax.vmap(ja._pacf_to_coef)(jnp.asarray(want[:, sl])))
            if sl.stop > sl.start else np.zeros((len(z), 0)),
            rtol=0, atol=FIT_COEF_TOL)
    assert not got[2].any()  # all masked: the prior alone, from 0
    assert float(got.abs().max()) > 1e-2


def test_non_finite_gradient_row_is_zeroed_and_rows_fit_alone():
    """A row whose sums overflow (|z| ~ 1e30: ssq is inf, its gradient NaN)
    takes zero gradients and stays at u = 0, as in the reference; the other
    rows are bit for bit their fits alone."""
    z, m = _rows(seed=7)
    z[0] = np.where(m[0] > 0, 1e30, 0.0)
    zt, mt = torch.from_numpy(z), torch.from_numpy(m)
    got = ta.mle_fit_reference(zt, mt, 2, 1, 2, 10, LR, PRIOR)
    assert not got[0].any()
    assert not _reference_u(z[:1], m[:1], 2, 1, 10).any()
    for i in (1, 3, 4):
        alone = ta.mle_fit_reference(zt[i:i + 1], mt[i:i + 1], 2, 1, 2, 10,
                                     LR, PRIOR)
        assert torch.equal(got[i:i + 1], alone), i


def test_fit_path_and_steps():
    """``path`` lists u after each step (its last is the fit); no step, or
    no coordinate, is u = 0 with no twin run."""
    z, m = (torch.from_numpy(a) for a in _rows(seed=2))
    path = ta.mle_fit_reference(z, m, 1, 1, 2, 4, LR, PRIOR, path=True)
    assert len(path) == 4
    assert torch.equal(path[-1], ta.mle_fit_reference(z, m, 1, 1, 2, 4, LR,
                                                      PRIOR))
    assert not torch.equal(path[0], path[1])
    assert not tk.arima_mle_fit(z, m, 1, 1, 2, 0, LR, PRIOR).any()
    assert tk.arima_mle_fit(z, m, 0, 0, 1, 5, LR, PRIOR).shape == (5, 0)


def test_bias_table_is_adams_scalars():
    """The kernel's (steps, 2) table holds what ``ops/optim.adam`` divides
    by at each step: an Adam run on the CPU reproduces its updates from the
    table bit for bit."""
    steps = 7
    table = tk.adam_bias_table(steps)
    assert table.dtype == torch.float32 and table.shape == (steps, 2)
    g = torch.tensor([0.3, -1.7, 2e-3, 5.0])
    opt = topt.adam(LR)
    state = opt.init({"u": torch.zeros(4)})
    mu = nu = torch.zeros(4)
    for c in range(steps):
        updates, state = opt.update({"u": g * (c + 1)}, state)
        gc = g * (c + 1)
        mu = tk.ADAM_B1 * mu + (1.0 - tk.ADAM_B1) * gc
        nu = tk.ADAM_B2 * nu + (1.0 - tk.ADAM_B2) * (gc * gc)
        bc1, bc2 = (float(x) for x in table[c])
        want = -LR * (mu / bc1) / (torch.sqrt(nu / bc2) + tk.ADAM_EPS)
        assert torch.equal(updates["u"], want), c
        assert (bc1, bc2) == topt.bias_corrections(c + 1, tk.ADAM_B1,
                                                   tk.ADAM_B2)


def test_wrapper_checks_and_work():
    z, m = (torch.from_numpy(a) for a in _rows(seed=1))
    with pytest.raises(ValueError, match="r=1"):
        tk.arima_mle_fit(z, m, 2, 1, 1, 5, LR, PRIOR)
    with pytest.raises(ValueError, match="steps"):
        tk.arima_mle_fit(z, m, 2, 1, 2, -1, LR, PRIOR)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.arima_mle_fit(z.to("meta"), m.to("meta"), 2, 1, 2, 5, LR, PRIOR)
    before = tk.arima_mle_fit.launches
    tk.arima_mle_fit(z, m, 2, 1, 2, 2, LR, PRIOR)
    assert tk.arima_mle_fit.launches == before  # the twin never counts
    one, _ = tk.arima_loglik_grad_work(500, 1826, 2, 3)
    ops, nbytes = tk.mle_fit_work(500, 1826, 2, 2, 1, 200)
    assert 200 * one < ops < 201 * one
    assert nbytes == 4 * (2 * 500 * 1826 + 400 + 1500)
