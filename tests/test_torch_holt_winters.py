"""Port parity: Holt-Winters fit, forecast and quantiles against the JAX
reference, and weights carried across with ``convert``.

Discrete outputs must be equal: every series picks the same grid candidate
(its index).  The port's grid values are the float64 points rounded once to
float32; the reference's float32 linspace lands one ulp off in a few
entries, so the winning values agree to one ulp (rtol 1.2e-7).

Float outputs agree within 1e-5 of the data's scale (max |y|): XLA fuses
the filter's multiply-adds and rounds ``pow`` differently, and the filter
carries those roundings forward over T float32 steps.  The data are whole
numbers, as unit sales are, so the initial-state sums are exact in both
frameworks (see test_torch_hw_score.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.models import base as jbase
from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu_torch import convert
from distributed_forecasting_tpu_torch.models import base as tbase
from distributed_forecasting_tpu_torch.models import holt_winters as thw

torch.set_num_threads(1)

ULP = 1.2e-7
FIELDS = ("level", "trend", "season", "sigma", "fitted")


def _workload(S, T, m=7, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    level = rng.uniform(20, 80, size=(S, 1)) + rng.uniform(-0.03, 0.03, (S, 1)) * t
    season = rng.uniform(2, 10, size=(S, 1)) * np.sin(2 * np.pi * t / m)[None]
    y = np.round(level + season + rng.normal(0, 2, size=(S, T))).astype(np.float32)
    mask = (rng.random((S, T)) > 0.1).astype(np.float32)
    mask[1, :30] = 0.0  # a late starter
    day = np.arange(16_000, 16_000 + T, dtype=np.int32)
    return y * mask, mask, day


def _fit_both(y, mask, day, **cfg):
    jp = jhw.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day),
                 jhw.HoltWintersConfig(**cfg))
    tp = thw.fit(torch.from_numpy(y), torch.from_numpy(mask),
                 torch.from_numpy(day), thw.HoltWintersConfig(**cfg))
    return jp, tp


def _winner_index(params, grid):
    """Grid index of every series' winning (alpha, beta, gamma, phi)."""
    won = np.stack([np.asarray(getattr(params, k), np.float64)
                    for k in ("alpha", "beta", "gamma", "phi")], axis=1)
    cand = np.stack([np.asarray(g, np.float64) for g in grid], axis=1)
    d = np.abs(won[:, None, :] - cand[None, :, :]).max(axis=2)
    assert (d.min(axis=1) <= ULP).all()
    return d.argmin(axis=1)


def _assert_params_close(jp, tp, scale):
    for f in FIELDS:
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale, err_msg=f)
    for f in ("day0", "t_fit_end"):
        assert float(getattr(jp, f)) == float(getattr(tp, f))


@pytest.mark.parametrize("filt", ["scan", "pallas", "auto"])
@pytest.mark.parametrize("damped", [False, True])
def test_fit_matches_reference(filt, damped):
    # T <= 120 where the reference's Pallas interpreter runs
    T = 120 if filt == "pallas" else (160 if damped else 300)
    y, mask, day = _workload(S=6, T=T, seed=int(damped))
    cfg = dict(filter=filt, damped=damped)
    jp, tp = _fit_both(y, mask, day, **cfg)
    j_idx = _winner_index(jp, jhw._candidate_grid(jhw.HoltWintersConfig(**cfg)))
    t_idx = _winner_index(tp, thw._candidate_grid(thw.HoltWintersConfig(**cfg)))
    np.testing.assert_array_equal(t_idx, j_idx)
    for k in ("alpha", "beta", "gamma", "phi"):
        np.testing.assert_allclose(getattr(tp, k).numpy(),
                                   np.asarray(getattr(jp, k)), rtol=ULP)
    _assert_params_close(jp, tp, np.abs(y).max())


def test_grid_values_agree_with_reference_to_one_ulp():
    for cfg in (thw.HoltWintersConfig(), thw.HoltWintersConfig(damped=True),
                thw.HoltWintersConfig(n_alpha=9, n_beta=5, n_gamma=7)):
        jcfg = jhw.HoltWintersConfig(**dataclasses.asdict(cfg))
        for t, j in zip(thw._candidate_grid(cfg), jhw._candidate_grid(jcfg)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=ULP)


def test_scan_and_kernel_route_fits_are_identical_on_cpu():
    y, mask, day = _workload(S=5, T=120, seed=4)
    t = [torch.from_numpy(a) for a in (y, mask, day)]
    p_scan = thw.fit(*t, thw.HoltWintersConfig(filter="scan"))
    p_pal = thw.fit(*t, thw.HoltWintersConfig(filter="pallas"))
    for f in dataclasses.fields(p_scan):
        assert torch.equal(getattr(p_scan, f.name), getattr(p_pal, f.name))


def test_multiplicative_fit_matches_reference_and_kernel_route_raises():
    y, mask, day = _workload(S=4, T=120, seed=2)
    cfg = dict(seasonality_mode="multiplicative")
    jp, tp = _fit_both(y, mask, day, **cfg)
    np.testing.assert_array_equal(tp.alpha.numpy(), np.asarray(jp.alpha))
    _assert_params_close(jp, tp, np.abs(y).max())
    with pytest.raises(ValueError, match="additive"):
        thw.fit(*(torch.from_numpy(a) for a in (y, mask, day)),
                thw.HoltWintersConfig(filter="pallas", **cfg))


def test_pscan_and_unknown_filters_raise():
    """filter='pscan' is additive only (the multiplicative update is not
    affine in the state), as in the reference."""
    y, mask, day = (torch.from_numpy(a) for a in _workload(S=2, T=40))
    with pytest.raises(ValueError, match="additive"):
        thw.fit(y, mask, day, thw.HoltWintersConfig(
            filter="pscan", seasonality_mode="multiplicative"))
    with pytest.raises(ValueError, match="unknown filter"):
        thw.fit(y, mask, day, thw.HoltWintersConfig(filter="kernel"))


def _forecast_inputs(params_day_end, horizon=45):
    day_all = np.arange(16_000, params_day_end + 1 + horizon, dtype=np.int32)
    return day_all


@pytest.mark.parametrize("damped", [False, True])
def test_forecast_and_quantiles_match_reference(damped):
    y, mask, day = _workload(S=6, T=200, seed=7)
    cfg = dict(damped=damped, interval_width=0.9)
    jp, tp = _fit_both(y, mask, day, **cfg)
    jcfg, tcfg = jhw.HoltWintersConfig(**cfg), thw.HoltWintersConfig(**cfg)
    day_all = _forecast_inputs(int(day[-1]))
    # intervals from the fit end, and from an earlier (CV-like) cutoff
    for t_end in (float(day[-1]), float(day[150])):
        want = jhw.forecast(jp, jnp.asarray(day_all), jnp.float32(t_end), jcfg)
        got = thw.forecast(tp, torch.from_numpy(day_all), t_end, tcfg)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5 * np.abs(y).max())
    qs = (0.05, 0.5, 0.975)
    want_q = jbase.gaussian_quantiles(jhw.forecast)(
        jp, jnp.asarray(day_all), jnp.float32(day[-1]), jcfg, quantiles=qs)
    got_q = tbase.gaussian_quantiles(thw.forecast)(
        tp, torch.from_numpy(day_all), float(day[-1]), tcfg, quantiles=qs)
    assert tuple(got_q.shape) == (6, 3, day_all.shape[0])
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-5,
                               atol=1e-5 * np.abs(y).max())


def test_forecast_takes_one_cutoff_per_series():
    y, mask, day = _workload(S=4, T=150, seed=9)
    tp = thw.fit(*(torch.from_numpy(a) for a in (y, mask, day)),
                 thw.HoltWintersConfig())
    cfg = thw.HoltWintersConfig()
    d = torch.from_numpy(day)
    ends = torch.tensor([float(day[-1]), float(day[90]), float(day[-1]),
                         float(day[90])])
    yh, lo, hi = thw.forecast(tp, d, ends, cfg)
    for t_end, rows in ((float(day[-1]), [0, 2]), (float(day[90]), [1, 3])):
        y1, lo1, hi1 = thw.forecast(tp, d, t_end, cfg)
        for a, b in ((yh, y1), (lo, lo1), (hi, hi1)):
            assert torch.equal(a[rows], b[rows])


def test_reference_params_converted_forecast_like_reference():
    y, mask, day = _workload(S=5, T=180, seed=11)
    cfg = dict(damped=True)
    jp = jhw.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day),
                 jhw.HoltWintersConfig(**cfg))
    fields = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)}
    tp = convert.hw_params_from_numpy(fields, device="cpu")
    day_all = _forecast_inputs(int(day[-1]), horizon=60)
    want = jhw.forecast(jp, jnp.asarray(day_all), jnp.float32(day[-1]),
                        jhw.HoltWintersConfig(**cfg))
    got = thw.forecast(tp, torch.from_numpy(day_all), float(day[-1]),
                       thw.HoltWintersConfig(**cfg))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * np.abs(y).max())
    back = convert.hw_params_to_numpy(tp)
    assert back.keys() == fields.keys()
    for k in fields:
        np.testing.assert_array_equal(back[k], fields[k])
    # artifacts from before the damped trend carry no phi: phi = 1
    legacy = {k: v for k, v in fields.items() if k != "phi"}
    assert torch.equal(convert.hw_params_from_numpy(legacy, "cpu").phi,
                       torch.ones(5))
