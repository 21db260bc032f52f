"""Port parity: arima ``method='mle'``, the likelihood-gradient kernel's plain
twin (``models/arima.arima_loglik_grad_reference``, the forward-mode
tangents of the sequential Kalman filter), the loss's gradient in u as the
fit kernel forms it, and the MLE fit (the fit kernel's twin
``models/arima.mle_fit_reference`` on the CPU) through ``fit``, the CV pass
and ``order: auto``, against the JAX reference on the CPU.

Tolerances and why:
- Jacobians (d ssq, d ldet by phi and theta): within 5e-5 of each row's
  scale (its largest entry, floored at 1), against ``torch.autograd``
  through ``_kalman_loglik_impl`` in float64 and against ``jax.jacrev`` /
  ``jax.grad`` of the reference in float32.  The twin's forward mode and
  the references' reverse mode add the same terms in other orders, so
  they differ by float32 rounding: measured 1e-5 of scale at most over
  these cases (a coefficient at |PACF| 0.96 included).
- The loss's gradient in u: within 5e-5 of each row's scale, as the
  Jacobians (the same terms in other orders).
- The MLE fit (30 Adam steps): phi, theta within 1e-5; sigma2, the fitted
  path, its variance and the forecast band within 1e-4 of the row's scale.
  Adam's update is the reference's, so only the gradient's rounding is
  left.
- The primal ssq, ldet and n are bitwise the sequential filter's: the
  twin runs the same operations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.engine import cv as jcv
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.engine import order as jorder
from distributed_forecasting_tpu.models import arima as ja
from distributed_forecasting_tpu_torch.engine import cv as tcv
from distributed_forecasting_tpu_torch.engine import fit as tfit
from distributed_forecasting_tpu_torch.engine import order as torder
from distributed_forecasting_tpu_torch.models import arima as ta
from distributed_forecasting_tpu_torch.ops import kalman as tk

torch.set_num_threads(1)

JAC_TOL = 5e-5
FIT_COEF_TOL = 1e-5
FIT_REL = 1e-4
STEPS = 30
T = 120
ORDERS = {"211": (2, 1), "100": (1, 0), "012": (0, 2), "r9": (9, 0)}


def _rows(p, q, seed):
    """Four rows of an ARMA(2, 1) path, centered and masked: row 0 with 10%
    of cells masked, row 1 with one observation, row 2 all masked, row 3
    with its first coefficient's PACF at tanh(2) = 0.96 (near the
    stationarity boundary).  Returns (zc, zmask, u)."""
    rng = np.random.default_rng(seed)
    S, burn = 4, 50
    e = rng.normal(size=(S, T + burn))
    z = np.zeros((S, T + burn))
    for t in range(2, T + burn):
        z[:, t] = 0.5 * z[:, t - 1] - 0.2 * z[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1]
    z = z[:, burn:] * 2.0
    m = (rng.random((S, T)) >= 0.1).astype(np.float32)
    m[1] = 0
    m[1, 60] = 1
    m[2] = 0
    z = (z - z.mean(axis=1, keepdims=True)) * m
    u = rng.normal(size=(S, p + q)) * 0.4
    u[3] = 0.2
    if p + q:
        u[3, 0] = 2.0
    return z.astype(np.float32), m, u.astype(np.float32)


def _coefficients(u, p):
    ut = torch.from_numpy(u)
    return ta._pacf_to_coef(ut[:, :p]), ta._pacf_to_coef(ut[:, p:])


def _assert_rows_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(axis=1), 1.0)
    err = np.abs(got - want).max(axis=1) / scale
    assert (err <= JAC_TOL).all(), (what, err)


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_twin_jacobian_matches_autograd_and_jax(order, seed):
    p, q = ORDERS[order]
    r = max(p, q + 1, 1)
    z, m, u = _rows(p, q, seed)
    phi, theta = _coefficients(u, p)
    zt, mt = torch.from_numpy(z), torch.from_numpy(m)
    out = tk.arima_loglik_grad(zt, mt, phi, theta, r)  # CPU: the twin

    # the primal is the sequential filter's, bitwise
    ssq, ldet, n, *_ = ta._kalman_loglik_impl(zt, mt, phi, theta, r)
    assert torch.equal(out.ssq, ssq) and torch.equal(out.ldet, ldet)
    assert torch.equal(out.n, n)
    assert out.dssq.shape == out.dldet.shape == (4, p + q)
    assert torch.isfinite(out.dssq).all() and torch.isfinite(out.dldet).all()
    # the all-masked row has no likelihood and a zero gradient
    assert not out.dssq[2].any() and not out.dldet[2].any()

    # torch.autograd through the plain filter, in float64
    ph = phi.double().requires_grad_(True)
    th = theta.double().requires_grad_(True)
    f64 = ta._kalman_loglik_impl(zt.double(), mt.double(), ph, th, r)
    for i, got in ((0, out.dssq), (1, out.dldet)):
        grads = torch.autograd.grad(f64[i].sum(), [ph, th], retain_graph=True,
                                    allow_unused=True)
        want = torch.cat([g if g is not None else torch.zeros_like(x)
                          for g, x in zip(grads, (ph, th))], dim=1)
        _assert_rows_close(got.numpy(), want.numpy(), ("autograd", i))

    # jax.jacrev of the reference's filter, in float32
    def pieces(ph_, th_, zs, ms):
        return jnp.stack(ja._kalman_loglik(zs, ms, ph_, th_, r)[:2])

    jac = jax.vmap(jax.jacrev(pieces, argnums=(0, 1)))(
        jnp.asarray(phi.numpy()), jnp.asarray(theta.numpy()), jnp.asarray(z),
        jnp.asarray(m))
    want = np.concatenate([np.asarray(jac[0]), np.asarray(jac[1])], axis=2)
    _assert_rows_close(out.dssq.numpy(), want[:, 0], "jax dssq")
    _assert_rows_close(out.dldet.numpy(), want[:, 1], "jax dldet")


@pytest.mark.parametrize("order", ["211", "012"])
def test_nll_gradient_matches_jax_grad_of_reference(order):
    """The whole loss's gradient in u as the fit forms it: the map's
    Jacobian columns as the filter's directions
    (``_pacf_directions``), the twin's tangents along them and the
    hand-written gradient (``_mle_grad``), against ``jax.grad`` of the
    reference's ``nll_one``; the loss from the twin's pieces against its
    value."""
    p, q = ORDERS[order]
    r = max(p, q + 1, 1)
    z, m, u = _rows(p, q, seed=3)
    cfg = ja.ArimaConfig(p=p, q=q, method="mle")

    def nll_one(uu, zs, ms):  # the reference's, arima.py:409-416
        phi = ja._pacf_to_coef(uu[:p]) if p else jnp.zeros((0,))
        theta = ja._pacf_to_coef(uu[p:p + q]) if q else jnp.zeros((0,))
        ssq, ldet, n, *_ = ja._kalman_loglik(zs, ms, phi, theta, r)
        n = jnp.maximum(n, 1.0)
        prior = 0.5 * jnp.sum((uu / cfg.prior_scale) ** 2)
        return (0.5 * n * jnp.log(jnp.maximum(ssq / n, ja._EPS))
                + 0.5 * ldet + prior)

    want_val, want = jax.vmap(jax.value_and_grad(nll_one))(
        jnp.asarray(u), jnp.asarray(z), jnp.asarray(m))
    ut = torch.from_numpy(u)
    phi, theta, dph, dRv = ta._pacf_directions(ut, p, q, r)
    ssq, ldet, n, dssq, dldet = ta.arima_loglik_grad_reference(
        torch.from_numpy(z), torch.from_numpy(m), phi, theta, r, dph, dRv)
    got = ta._mle_grad(ut, ssq, n, dssq, dldet, cfg.prior_scale)
    nn = torch.clamp_min(n, 1.0)
    val = (0.5 * nn * torch.log(torch.clamp_min(ssq / nn, ta._EPS))
           + 0.5 * ldet + 0.5 * torch.sum((ut / cfg.prior_scale) ** 2, 1))
    np.testing.assert_allclose(val.numpy(), np.asarray(want_val), rtol=1e-6)
    _assert_rows_close(got.numpy(), np.asarray(want), "nll grad")


def _series(S=6, seed=0):
    """ARMA-ish unit sales with a trend, 5% of cells missing."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    e = np.zeros((S, T))
    for i in range(1, T):
        e[:, i] = 0.6 * e[:, i - 1] + rng.normal(0, 3, S)
    y = (60 + rng.uniform(-0.02, 0.05, (S, 1)) * t
         + rng.uniform(2, 8, (S, 1)) * np.sin(2 * np.pi * t / 7)[None] + e)
    mask = (rng.random((S, T)) >= 0.05).astype(np.float32)
    return ((y * mask).astype(np.float32), mask,
            np.arange(16_000, 16_000 + T, dtype=np.int32))


def _close_rows(got, want, what, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    if got.size == 0:
        return
    flat_g, flat_w = got.reshape(len(got), -1), want.reshape(len(want), -1)
    scale = np.maximum(np.abs(flat_w).max(axis=1), 1.0)
    err = np.abs(flat_g - flat_w).max(axis=1) / scale
    assert (err <= rel).all(), (what, err)


@pytest.mark.parametrize("cfg", [dict(p=2, d=1, q=1), dict(p=1, d=0, q=2),
                                 dict(p=1, d=0, q=0)],
                         ids=["211", "102", "100"])
def test_mle_fit_matches_reference(cfg):
    y, mask, day = _series()
    conf = dict(cfg, method="mle", fit_steps=STEPS)
    jp = ja.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day),
                ja.ArimaConfig(**conf))
    tp = ta.fit(torch.from_numpy(y), torch.from_numpy(mask),
                torch.from_numpy(day), ta.ArimaConfig(**conf))
    for f in ("phi", "theta"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=0,
                                   atol=FIT_COEF_TOL, err_msg=f)
    # the fit moved away from u = 0 (the starting point)
    assert np.abs(tp.phi.numpy()).max() > 1e-2
    for f in ("sigma2", "fitted", "fitted_var", "a_last", "level_end"):
        want = np.asarray(getattr(jp, f))
        _close_rows(getattr(tp, f).numpy().reshape(len(want), -1),
                    want.reshape(len(want), -1), f, FIT_REL)
    day_all = np.arange(16_000, 16_000 + T + 30, dtype=np.int32)
    jband = ja.forecast(jp, jnp.asarray(day_all), None, ja.ArimaConfig(**conf))
    tband = ta.forecast(tp, torch.from_numpy(day_all), None,
                        ta.ArimaConfig(**conf))
    for name, got, want in zip(("yhat", "lo", "hi"), tband, jband):
        _close_rows(got.numpy(), np.asarray(want), name, FIT_REL)


def test_mle_fit_forecast_matches_reference():
    """Through ``engine.fit_forecast`` on a tensorized frame."""
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=2, n_days=T,
                                          seed=5, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    jb, tb = jdata.tensorize(df), tdata.tensorize(df, device="cpu")
    conf = dict(method="mle", fit_steps=STEPS)
    _, jres = jfit.fit_forecast(jb, model="arima", horizon=14,
                                config=ja.ArimaConfig(**conf))
    _, tres = tfit.fit_forecast(tb, model="arima", horizon=14,
                                config=ta.ArimaConfig(**conf))
    assert tres.ok.all()
    for f in ("yhat", "lo", "hi"):
        _close_rows(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                    f, FIT_REL)


CV = dict(initial=60, period=20, horizon=20)


@pytest.fixture(scope="module")
def batches():
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=2, n_days=T,
                                          seed=4, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    return jdata.tensorize(df), tdata.tensorize(df, device="cpu")


def test_mle_cv_matches_reference(batches):
    """The CV pass stacks its cutoffs as rows: one Adam over every row is
    the reference's vmapped per-(cutoff, series) Adam."""
    jb, tb = batches
    conf = dict(method="mle", fit_steps=STEPS)
    want = jcv.cross_validate(jb, model="arima", config=ja.ArimaConfig(**conf),
                              cv=jcv.CVConfig(**CV))
    got = tcv.cross_validate(tb, model="arima", config=ta.ArimaConfig(**conf),
                             cv=tcv.CVConfig(**CV))
    assert got["_n_cutoffs"] == want["_n_cutoffs"] == 3
    for k in ("mse", "smape", "mae", "coverage"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=FIT_REL, err_msg=k)


def test_order_auto_with_mle_base_conf_matches_reference(batches):
    """``select_arima_order(base_conf={"method": "mle"})`` over a 3-order
    ladder: the same winner where the best two are further apart than
    2e-3 relative, every score within the CV tolerance."""
    jb, tb = batches
    orders = ((1, 0, 0), (1, 1, 1), (0, 1, 1))
    base = {"method": "mle", "fit_steps": STEPS}
    got, got_rows = torder.select_arima_order(
        tb, orders=orders, cv=tcv.CVConfig(**CV), base_conf=base)
    want, want_rows = jorder.select_arima_order(
        jb, orders=orders, cv=jcv.CVConfig(**CV), base_conf=base)
    got_s = {tuple(o): s for o, s, _ in got_rows}
    want_s = {tuple(o): s for o, s, _ in want_rows}
    assert sorted(got_s) == sorted(want_s) == sorted(orders)
    np.testing.assert_allclose([got_s[o] for o in orders],
                               [want_s[o] for o in orders], rtol=FIT_REL)
    best2 = np.sort(list(want_s.values()))[:2]
    if best2[1] - best2[0] > 2e-3 * abs(best2[0]):
        assert got == want


def test_seasonal_terms_refuse_mle_with_the_references_message():
    y, mask, day = _series(S=2)
    conf = dict(p=1, d=1, q=1, P=1, m=7, method="mle")
    with pytest.raises(ValueError) as want:
        ja.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day),
               ja.ArimaConfig(**conf))
    with pytest.raises(ValueError) as got:
        ta.fit(torch.from_numpy(y), torch.from_numpy(mask),
               torch.from_numpy(day), ta.ArimaConfig(**conf))
    assert str(got.value) == str(want.value)
    assert "method='hr'" in str(got.value)


def test_kernel_wrapper_checks_and_work():
    """The wrapper's CPU route is the twin; a non-CPU, non-CUDA device and
    an r below max(p, q + 1) raise; the work count grows with the
    tangents."""
    z, m, u = _rows(2, 1, seed=0)
    phi, theta = _coefficients(u, 2)
    zt, mt = torch.from_numpy(z), torch.from_numpy(m)
    with pytest.raises(ValueError, match="r=1"):
        tk.arima_loglik_grad(zt, mt, phi, theta, 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.arima_loglik_grad(zt.to("meta"), mt.to("meta"), phi.to("meta"),
                             theta.to("meta"), 2)
    ops0, bytes0 = tk.arima_loglik_grad_work(500, 1826, 2, 0)
    ops3, bytes3 = tk.arima_loglik_grad_work(500, 1826, 2, 3)
    assert ops3 > 3 * ops0 and bytes3 > bytes0 >= 8 * 500 * 1826
    # no coefficient: the primal alone, an empty Jacobian
    out = tk.arima_loglik_grad(zt, mt, phi[:, :0], theta[:, :0], 1)
    assert out.dssq.shape == (4, 0)
    assert torch.equal(out.ssq, ta._kalman_loglik_impl(
        zt, mt, phi[:, :0], theta[:, :0], 1)[0])
    before = tk.arima_loglik_grad.launches
    tk.arima_loglik_grad(zt, mt, phi, theta, 2)
    assert tk.arima_loglik_grad.launches == before  # the twin never counts


def test_mle_with_nothing_to_fit_and_fit_steps_zero():
    """p = q = 0 leaves nothing to optimize (white noise about the mean);
    fit_steps = 0 keeps u = 0: phi = theta = 0, as in the reference."""
    y, mask, day = _series(S=3)
    for conf in (dict(p=0, d=1, q=0), dict(p=1, d=0, q=1, fit_steps=0)):
        conf = dict(conf, method="mle")
        jp = ja.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day),
                    ja.ArimaConfig(**conf))
        tp = ta.fit(torch.from_numpy(y), torch.from_numpy(mask),
                    torch.from_numpy(day), ta.ArimaConfig(**conf))
        assert not tp.phi.any() and not tp.theta.any()
        _close_rows(tp.fitted.numpy(), np.asarray(jp.fitted), "fitted",
                    FIT_REL)
        np.testing.assert_allclose(tp.sigma2.numpy(), np.asarray(jp.sigma2),
                                   rtol=FIT_REL)


def test_hr_only_paths_keep_their_refusal():
    y, mask, _ = (torch.from_numpy(a) for a in _series(S=2))
    with pytest.raises(ValueError, match="method='hr'"):
        ta.window_stats(y, mask, ta.ArimaConfig(method="mle"))
    assert dataclasses.asdict(ta.ArimaConfig()) == dataclasses.asdict(
        ja.ArimaConfig())
