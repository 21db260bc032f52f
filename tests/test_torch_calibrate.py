"""Port parity: split-conformal calibration (``engine/calibrate``) and the
``cross_validate(calibrate=True)`` route, against the JAX reference.

The conformal scale is an order statistic of scores r = |y - yhat| /
(hi - yhat).  Its rank k = ceil((n + 1) * width) - 1 is a discrete output
and must equal the reference's, which computes it in float32 (width 0.95
is 0.949999988 there): the rank tests build scores whose sorted values are
distinct integers, so the reference's scale names its rank.  On the same
paths both packages compute the same float32 scores, so the scales agree
to one rounding of the division (rtol 2^-23).  Through ``cross_validate``
each package scores its own paths, and an order statistic moves by at most
the largest change in the scores it is taken from: the tolerance of each
series' scale is the largest score difference of that series (of every
series, where the pooled quantile stands in).  The calibrated coverage may
differ by one point per series: the point at rank k lies on the calibrated
band's edge by construction, and rounding decides its side.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
import distributed_forecasting_tpu_torch.data as tdata
from distributed_forecasting_tpu.engine import calibrate as jcal
from distributed_forecasting_tpu.engine import cv as jcv
from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu.models import prophet_glm as jpg
from distributed_forecasting_tpu_torch.engine import calibrate as tcal
from distributed_forecasting_tpu_torch.engine import cv as tcv
from distributed_forecasting_tpu_torch.models import holt_winters as thw
from distributed_forecasting_tpu_torch.models import prophet_glm as tpg

torch.set_num_threads(1)

F32_ULP = 2.0 ** -23


def _both(y, yhat, hi, em, width=0.95, min_points=30):
    want = np.asarray(jcal.conformal_scale_from_paths(
        y, yhat, hi, em, interval_width=width, min_points=min_points))
    got = tcal.conformal_scale_from_paths(
        *(torch.from_numpy(a) for a in (y, yhat, hi, em)),
        interval_width=width, min_points=min_points).numpy()
    return got, want


def _ranked_paths(counts, C=2, T=600, offset=10_000.0):
    """(C, S, T) paths whose scores are distinct integers: series s has
    ``counts[s]`` observed points scoring s*offset + 1 .. s*offset + n, in a
    seeded order; yhat = 0 and hi = 1, so r = y exactly."""
    rng = np.random.default_rng(len(counts))
    S = len(counts)
    y = np.zeros((S, T), np.float32)
    yhat = np.zeros((C, S, T), np.float32)
    hi = np.ones((C, S, T), np.float32)
    em = np.zeros((C, S, T), np.float32)
    for s, n in enumerate(counts):
        assert n <= T
        cells = rng.permutation(T)[:n]
        em[rng.integers(0, C), s, cells] = 1.0
        y[s, cells] = s * offset + 1.0 + rng.permutation(n)
    return y, yhat, hi, em


@pytest.mark.parametrize("width", [0.95, 0.9, 0.8, 0.99])
def test_own_ranks_equal_reference_near_integer_products(width):
    """Series with n + 1 = 20, 40, 100, 1,000 points and their neighbours:
    (n + 1) * width lands on or next to an integer, where float32 decides
    the ceiling.  Each series' scale is its own order statistic."""
    counts = [18, 19, 20, 38, 39, 40, 98, 99, 100, 599, 600, 598]
    y, yhat, hi, em = _ranked_paths(counts)
    got, want = _both(y, yhat, hi, em, width=width, min_points=1)
    offsets = 10_000.0 * np.arange(len(counts))
    k_want = want - offsets - 1
    assert np.array_equal(k_want, np.round(k_want))  # names its rank
    np.testing.assert_array_equal(got - offsets - 1, k_want)
    n = torch.tensor(counts, dtype=torch.float32)
    k = tcal._conformal_rank(n, torch.full((), width, dtype=torch.float32))
    np.testing.assert_array_equal(k.numpy(), k_want.astype(np.int64))


@pytest.mark.parametrize("n_tot", [19, 39, 99, 999, 1000])
def test_pooled_rank_equals_reference(n_tot):
    """Every series below min_points: all take the pooled order statistic
    over n_tot scores (n_tot + 1 = 20, 40, 100, 1,000, 1,001)."""
    parts = [n_tot // 3, n_tot // 3, n_tot - 2 * (n_tot // 3)]
    y, yhat, hi, em = _ranked_paths(parts, T=400)
    got, want = _both(y, yhat, hi, em, min_points=10_000)
    assert np.unique(want).size == 1
    np.testing.assert_array_equal(got, want)


def _random_paths(seed, C=3, S=12, T=90):
    """Seeded CV paths with the awkward series: 0 fully masked (n = 0),
    1 a degenerate band (hi == yhat everywhere), 2 thin (5 points, pooled),
    3 a degenerate band on one cutoff only, the rest 30-60% observed."""
    rng = np.random.default_rng(seed)
    y = np.round(rng.gamma(4.0, 5.0, (S, T))).astype(np.float32)
    yhat = (y[None] + rng.normal(0.0, 4.0, (C, S, T))).astype(np.float32)
    hi = (yhat + np.abs(rng.normal(6.0, 2.0, (C, S, T)))).astype(np.float32)
    em = (rng.random((C, S, T)) < rng.uniform(0.3, 0.6, (1, S, 1))).astype(
        np.float32)
    em[:, 0] = 0.0
    hi[:, 1] = yhat[:, 1]
    em[:, 2] = 0.0
    em[0, 2, rng.permutation(T)[:5]] = 1.0
    hi[1, 3] = yhat[1, 3]
    return y, yhat, hi, em


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("min_points", [30, 1])
def test_scale_from_paths_matches_reference(seed, min_points):
    y, yhat, hi, em = _random_paths(seed)
    got, want = _both(y, yhat, hi, em, min_points=min_points)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=F32_ULP, atol=0)
    if min_points == 1:
        # n = 0 (masked, or every band degenerate): the pooled quantile
        assert got[0] == got[1]
    # series 2 has 5 points: pooled under min_points 30
    assert (got[2] == got[0]) == (min_points == 30)


def test_no_calibration_data_is_the_identity():
    y, yhat, hi, em = _random_paths(0)
    got, want = _both(y, yhat, hi, np.zeros_like(em))
    np.testing.assert_array_equal(got, np.ones_like(got))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("floor", [None, 0.0])
def test_apply_interval_scale_matches_reference(floor):
    rng = np.random.default_rng(5)
    yhat = rng.normal(1.0, 1.0, (4, 20)).astype(np.float32)
    lo = yhat - np.abs(rng.normal(2.0, 1.0, yhat.shape)).astype(np.float32)
    hi = yhat + np.abs(rng.normal(2.0, 1.0, yhat.shape)).astype(np.float32)
    s = np.array([0.5, 1.0, 1.5, 3.0], np.float32)
    want = jcal.apply_interval_scale(yhat, lo, hi, s, floor=floor)
    got = tcal.apply_interval_scale(
        *(torch.from_numpy(a) for a in (yhat, lo, hi, s)), floor=floor)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- cross_validate(calibrate=True) -----------------------------------------

CV = dict(initial=200, period=60, horizon=30)


@pytest.fixture(scope="module")
def batches():
    """16 series x 400 days with 5% gaps; the last series keeps every 40th
    row (thin: pooled), as in test_torch_engine.py."""
    df = tdata.synthetic_store_item_sales(n_stores=2, n_items=8, n_days=400,
                                          seed=4, missing_rate=0.05)
    df["sales"] = df["sales"].round()
    sparse = (df["store"] == 2) & (df["item"] == 8)
    df = df[~sparse | (df.index % 40 == 0)].reset_index(drop=True)
    return jdata.tensorize(df), tdata.tensorize(df, device="cpu")


def _configs(model):
    if model == "holt_winters":
        # the reference scans (its Pallas interpreter is slow at T = 400);
        # the port's 'pallas' route runs the kernel's twin on the CPU
        return (jhw.HoltWintersConfig(filter="scan"),
                thw.HoltWintersConfig(filter="pallas"))
    # no yearly terms: at the 200-day cutoff the yearly wave is nearly
    # collinear with the trend (test_torch_engine.py)
    return (jpg.CurveModelConfig(yearly_order=0),
            tpg.CurveModelConfig(yearly_order=0))


def _scores(y, yhat, hi, em):
    """The reference's conformity scores, in numpy: inf off the set."""
    half = hi - yhat
    obs = (em > 0) & (half > 1e-6 * (np.abs(yhat) + 1e-9))
    r = np.abs(y[None] - yhat) / np.maximum(half, 1e-9)
    return np.where(obs, r, np.inf), obs


@pytest.mark.parametrize("model", ["holt_winters", "prophet"])
def test_cross_validate_calibrate_matches_reference(batches, model):
    jb, tb = batches
    jc, tc = _configs(model)
    want = jcv.cross_validate(jb, model=model, config=jc,
                              cv=jcv.CVConfig(**CV), calibrate=True)
    got = tcv.cross_validate(tb, model, config=tc, cv=tcv.CVConfig(**CV),
                             calibrate=True)
    assert set(got) == set(want)
    # the metric means are the calibrate=False route's
    plain = tcv.cross_validate(tb, model, config=tc, cv=tcv.CVConfig(**CV))
    for k in plain:
        if k != "_n_cutoffs":
            torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0,
                                       equal_nan=True)

    # the tolerance from each package's own paths
    cuts = tuple(jcv.cutoff_indices(jb.n_time, jcv.CVConfig(**CV)))
    jyhat, _, jhi, jem, _ = jcv._cv_paths_impl(
        jb.y, jb.mask, jb.day, jax.random.PRNGKey(0), model=model, config=jc, cuts=cuts,
        horizon=CV["horizon"])
    tyhat, _, thi, tem, _ = tcv._cv_paths(tb, model, tc, list(cuts),
                                          CV["horizon"])
    y = tb.y.numpy()
    r_w, obs_w = _scores(y, np.asarray(jyhat), np.asarray(jhi), np.asarray(jem))
    r_g, obs_g = _scores(y, tyhat.numpy(), thi.numpy(), tem.numpy())
    np.testing.assert_array_equal(obs_g, obs_w)  # the same calibration sets
    diff = np.abs(np.where(obs_w, r_g, 0.0) - np.where(obs_w, r_w, 0.0))
    per_series = diff.max(axis=(0, 2))
    n = obs_w.sum(axis=(0, 2))
    tol = np.where(n >= 30, per_series, diff.max())
    s_got, s_want = got["_interval_scale"].numpy(), np.asarray(
        want["_interval_scale"])
    assert (n < 30).any() and (n >= 30).any()
    np.testing.assert_array_less(np.abs(s_got - s_want),
                                 tol + F32_ULP * np.abs(s_want))

    # calibrated coverage: at most the point on the band's edge flips
    C = len(cuts)
    n_cut = np.asarray(jem).sum(axis=2).min(axis=0)          # (S,)
    flip = 1.0 / (C * np.maximum(n_cut, 1)) + 1e-6
    c_got = got["_coverage_calibrated"].numpy()
    c_want = np.asarray(want["_coverage_calibrated"])
    np.testing.assert_array_less(np.abs(c_got - c_want), flip)


def test_conformal_interval_scale_matches_cross_validate(batches):
    _, tb = batches
    _, tc = _configs("holt_winters")
    cv = tcv.CVConfig(**CV)
    out = tcv.cross_validate(tb, "holt_winters", config=tc, cv=cv,
                             calibrate=True)
    alone = tcal.conformal_interval_scale(tb, "holt_winters", tc, cv)
    torch.testing.assert_close(alone, out["_interval_scale"], rtol=0, atol=0)


def test_calibrated_bands_follow_the_scale(batches):
    """The calibrated coverage is the coverage of the bands scaled by the
    returned scale, computed independently here."""
    _, tb = batches
    _, tc = _configs("prophet")
    cv = tcv.CVConfig(**CV)
    out = tcv.cross_validate(tb, "prophet", config=tc, cv=cv, calibrate=True)
    cuts = tcv.cutoff_indices(tb.n_time, cv)
    yhat, lo, hi, em, _ = tcv._cv_paths(tb, "prophet", tc, cuts, cv.horizon)
    s = out["_interval_scale"][None, :, None]
    lo_c, hi_c = yhat - s * (yhat - lo), yhat + s * (hi - yhat)
    y = tb.y[None]
    inside = ((y >= lo_c) & (y <= hi_c)).float() * em
    cov = (inside.sum(2) / em.sum(2).clamp_min(1.0)).mean(0)
    torch.testing.assert_close(out["_coverage_calibrated"], cov)


def test_thin_series_take_the_pooled_scale(batches):
    _, tb = batches
    _, tc = _configs("prophet")
    out = tcv.cross_validate(tb, "prophet", config=tc,
                             cv=tcv.CVConfig(**CV), calibrate=True)
    s = out["_interval_scale"]
    assert torch.isfinite(s).all() and (s > 0).all()
    # the sparse last series has under 30 scored CV points
    cv_pts = tcv.cv_windows(tb.mask, tb.day, tcv.cutoff_indices(
        tb.n_time, tcv.CVConfig(**CV)), CV["horizon"])[1].sum((0, 2))
    assert cv_pts[-1] < 30 <= cv_pts[:-1].min()
    assert s[-1] != s[0]


def test_ported_families_set_no_band_floor():
    from distributed_forecasting_tpu.models.base import get_model as jget
    from distributed_forecasting_tpu_torch.models import get_model

    for model in ("prophet", "curve", "prophet_ar", "holt_winters"):
        assert get_model(model).band_floor is None
        assert jget(model).band_floor is None
    cfg = tpg.CurveModelConfig(interval_width=0.8)
    assert tcal.config_interval_width(cfg) == jcal.config_interval_width(
        dataclasses.replace(jpg.CurveModelConfig(), interval_width=0.8))
