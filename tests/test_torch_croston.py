"""Port parity: the croston family (Croston, SBA and TSB) against the JAX
reference — fit, forecast, quantiles, the serving artifact and weights
carried across with ``convert``.

Inputs are intermittent whole-number demand (most days zero) made with
numpy from a seed, with masked days, a series with no demand at all and a
fully masked series.  The recurrence's per-step arithmetic is the
reference's, operation for operation; the initial size mean and the
squared-error sum reduce in a different order (XLA's reduction tree, and
the port sums the squared errors after the loop where the reference
accumulates them in its scan), so values agree within rtol 1e-5 / atol
1e-6 of the data's scale — a few float32 roundings carried over T steps.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.models import croston as jcr
from distributed_forecasting_tpu_torch import convert
from distributed_forecasting_tpu_torch.models import croston as tcr
from distributed_forecasting_tpu_torch.models import get_model

torch.set_num_threads(1)

VARIANTS = ["croston", "sba", "tsb"]
RTOL = 1e-5


def _demand(S=12, T=300, seed=0):
    rng = np.random.default_rng(seed)
    rate = rng.uniform(0.05, 0.6, size=(S, 1))
    size = rng.uniform(1, 12, size=(S, 1))
    y = np.where(rng.random((S, T)) < rate,
                 np.round(rng.exponential(size, (S, T))) + 1, 0.0)
    mask = (rng.random((S, T)) > 0.08).astype(np.float32)
    y[2] = 0.0                      # no demand at all
    mask[3] = 0.0                   # nothing observed
    mask[4, 250:] = 0.0             # a masked tail
    y[5, 200:] = 0.0                # a dead tail (TSB decays, SBA freezes)
    day = np.arange(17_000, 17_000 + T, dtype=np.int32)
    return (y * mask).astype(np.float32), mask, day


def _fit_both(y, mask, day, **cfg):
    jp = jcr.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day),
                 jcr.CrostonConfig(**cfg))
    tp = tcr.fit(torch.from_numpy(y), torch.from_numpy(mask),
                 torch.from_numpy(day), tcr.CrostonConfig(**cfg))
    return jp, tp


def _close(got, want, scale, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * scale,
                               err_msg=what)


@pytest.mark.parametrize("variant", VARIANTS)
def test_fit_matches_reference(variant):
    y, mask, day = _demand()
    jp, tp = _fit_both(y, mask, day, variant=variant, alpha=0.15, beta=0.2)
    scale = float(np.abs(y).max())
    for f in ("z_level", "p_level", "sigma", "fitted"):
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.shape == b.shape, f
        assert np.isfinite(b).all(), f
        _close(b, a, scale, f)
    for f in ("day0", "t_fit_end"):
        assert float(getattr(jp, f)) == float(getattr(tp, f))


@pytest.mark.parametrize("variant", VARIANTS)
def test_forecast_and_quantiles_match_reference(variant):
    y, mask, day = _demand(seed=1)
    cfg = dict(variant=variant, interval_width=0.8)
    jp, tp = _fit_both(y, mask, day, **cfg)
    day_all = np.arange(int(day[0]), int(day[-1]) + 31, dtype=np.int32)
    t_end = np.float32(day[-1])
    want = jcr.forecast(jp, jnp.asarray(day_all), t_end,
                        jcr.CrostonConfig(**cfg))
    got = tcr.forecast(tp, torch.from_numpy(day_all), float(t_end),
                       tcr.CrostonConfig(**cfg))
    scale = float(np.abs(y).max())
    for name, a, b in zip(("yhat", "lo", "hi"), want, got):
        _close(b.numpy(), np.asarray(a), scale, name)
    yhat, lo, hi = (x.numpy() for x in got)
    assert (lo >= 0).all() and (lo <= yhat).all() and (yhat <= hi).all()
    # past the fit grid the rate is frozen
    assert np.all(yhat[:, -30:] == yhat[:, -1:])

    q = (0.05, 0.5, 0.95)
    jq = get_model_ref("croston").forecast_quantiles(
        jp, jnp.asarray(day_all), t_end, jcr.CrostonConfig(**cfg), q)
    tq = get_model("croston").forecast_quantiles(
        tp, torch.from_numpy(day_all), float(t_end), tcr.CrostonConfig(**cfg),
        q)
    _close(tq.numpy(), np.asarray(jq), scale, "quantiles")
    assert (tq >= 0).all()  # the floor clamps every level
    assert get_model("croston").band_floor == 0.0


def get_model_ref(name):
    from distributed_forecasting_tpu.models.base import get_model as jget

    return jget(name)


def test_masked_and_all_zero_series():
    y, mask, day = _demand(seed=2)
    for variant in VARIANTS:
        _, tp = _fit_both(y, mask, day, variant=variant)
        # no demand: the size level is 0 and so is the rate and its sigma
        assert float(tp.z_level[2]) == 0.0
        assert float(tp.fitted[2].abs().max()) == 0.0
        # nothing observed: the state never moves from its initial values
        assert float(tp.sigma[3]) == 0.0
        # a masked step carries the state: the path is flat over the tail
        assert torch.all(tp.fitted[4, 251:] == tp.fitted[4, 251])
    _, sba = _fit_both(y, mask, day, variant="sba")
    _, tsb = _fit_both(y, mask, day, variant="tsb")
    # over a dead tail TSB's rate decays; SBA's is frozen at the last demand
    assert float(tsb.fitted[5, -1]) < float(tsb.fitted[5, 200])
    assert float(sba.fitted[5, -1]) == float(sba.fitted[5, 201])


def test_unknown_variant_raises():
    y, mask, day = _demand(T=20)
    with pytest.raises(ValueError, match="unknown CrostonConfig.variant"):
        tcr.fit(torch.from_numpy(y), torch.from_numpy(mask),
                torch.from_numpy(day), tcr.CrostonConfig(variant="ses"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_weights_cross_with_convert(variant):
    y, mask, day = _demand(seed=3)
    jp, tp = _fit_both(y, mask, day, variant=variant)
    fields = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)}
    back = convert.croston_params_from_numpy(fields, device="cpu")
    for k, v in fields.items():
        np.testing.assert_array_equal(getattr(back, k).numpy(), v)
    out = convert.croston_params_to_numpy(tp)
    assert set(out) == set(fields)
    assert convert.params_type_name(tp) == (
        "distributed_forecasting_tpu.models.croston:CrostonParams")


def test_artifact_loads_in_either_package(tmp_path):
    from distributed_forecasting_tpu.serving.predictor import (
        BatchForecaster as JForecaster,
    )
    import pandas as pd

    from distributed_forecasting_tpu_torch.data import (
        synthetic_store_item_sales,
        tensorize,
    )
    from distributed_forecasting_tpu_torch.engine import fit_forecast
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    df = synthetic_store_item_sales(n_stores=1, n_items=3, n_days=200, seed=1)
    df["sales"] = np.where(np.arange(len(df)) % 3 == 0, df["sales"].round(),
                           0.0)
    batch = tensorize(df, device="cpu")
    cfg = tcr.CrostonConfig(variant="tsb")
    params, _ = fit_forecast(batch, "croston", config=cfg, horizon=14)
    scale = np.array([1.5, 0.5, 2.0], np.float32)
    BatchForecaster.from_fit(batch, params, "croston", cfg,
                             interval_scale=scale).save(str(tmp_path))
    request = pd.DataFrame({"store": [1, 1], "item": [3, 1]})
    got = BatchForecaster.load(str(tmp_path), device="cpu").predict(
        request, horizon=14)
    want = JForecaster.load(str(tmp_path)).predict(request, horizon=14)
    pd.testing.assert_frame_equal(got[["ds", "store", "item"]],
                                  want[["ds", "store", "item"]])
    for col in ("yhat", "yhat_upper", "yhat_lower"):
        np.testing.assert_allclose(got[col], want[col], rtol=RTOL, atol=1e-6,
                                   err_msg=col)
    # the widened band is floored at zero again
    assert (got["yhat_lower"] >= 0).all()
