"""Port parity: the anomaly scorer (``serving/anomaly.py``).

Three artifacts are written by the reference from one synthetic catalog fit
on all but its last 20 days: the curve model (with a conformal band scale),
Holt-Winters, and a mixed-family composite (the ``model: auto`` artifact
layout, ``ensemble.json``) whose arima member owns half the series.  Each is
loaded by both packages and scores the same actuals: the last 40 days (20
in the fit, 20 after it), with spikes planted at 50 standard deviations of
their series, an unknown series, a NaN actual and a point past
``max_horizon``.

- Keys, ``ds``, ``y``, request order and the counts are equal.
- ``yhat`` and the bands agree within each family's predict tolerance across
  the packages: rtol 1e-5 and 1e-5 of the data's scale for the curve model
  and Holt-Winters (``tests/test_torch_predictor.py``: only the forecast's
  float32 rounding differs), 1e-3 of the data's scale for arima rows (an
  artifact served by the other package, ``tests/test_torch_arima.py``).
- ``anomaly_score = |y - yhat| z / (hi - yhat)``: a band error of ``e`` moves
  it by at most ``e (z + 2 score) / (hi - yhat)`` to first order; scores
  agree within twice that plus the 1e-6 of its rounding.  Flags are equal
  wherever the score is further than that from the threshold, and every
  planted point is flagged.
- The threshold is the band's z in float32: the port's ``ndtri`` is
  correctly rounded and XLA's is one ulp off at some widths, so the two are
  held within two float32 ulps; everything else renders byte-equal.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.models import arima as jar
from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu.models import prophet_glm as jpg
from distributed_forecasting_tpu.monitoring import store as jstore
from distributed_forecasting_tpu.serving import anomaly as janom
from distributed_forecasting_tpu.serving import ensemble as jens
from distributed_forecasting_tpu.serving import predictor as jpred
from distributed_forecasting_tpu.serving.server import (
    load_forecaster as jload,
)
from distributed_forecasting_tpu_torch.monitoring import store as tstore
from distributed_forecasting_tpu_torch.serving import anomaly as tanom
from distributed_forecasting_tpu_torch.serving import predictor as tpred
from distributed_forecasting_tpu_torch.serving.loader import (
    load_forecaster as tload,
)

torch.set_num_threads(1)

HELD_OUT = 20
FAMILIES = ("prophet", "holt_winters", "auto")
# (rtol, fraction of the data's scale) of a predict across the packages
TOL = {"prophet": (1e-5, 1e-5), "holt_winters": (1e-5, 1e-5),
       "arima": (0.0, 1e-3)}


@pytest.fixture(scope="module")
def catalog():
    df = jdata.synthetic_store_item_sales(n_stores=2, n_items=3, n_days=420,
                                          seed=11, missing_rate=0.02)
    df["sales"] = df["sales"].round()
    return df


@pytest.fixture(scope="module")
def artifacts(catalog, tmp_path_factory):
    last = catalog["date"].max()
    train = catalog[catalog["date"] <= last - pd.Timedelta(days=HELD_OUT)]
    jb = jdata.tensorize(train)
    out = {}
    cfg = jpg.CurveModelConfig()
    params, _ = jfit.fit_forecast(jb, model="prophet", config=cfg,
                                  horizon=30, autoprep=False)
    scale = np.linspace(0.8, 1.3, jb.n_series).astype(np.float32)
    members = {"prophet": jpred.BatchForecaster.from_fit(
        jb, params, "prophet", cfg, interval_scale=scale)}
    for name, cfg in (("holt_winters", jhw.HoltWintersConfig()),
                      ("arima", jar.ArimaConfig(p=1, d=1, q=1))):
        params, _ = jfit.fit_forecast(jb, model=name, config=cfg, horizon=30,
                                      autoprep=False)
        members[name] = jpred.BatchForecaster.from_fit(jb, params, name, cfg)
    for name in ("prophet", "holt_winters"):
        path = str(tmp_path_factory.mktemp(f"anomaly_{name}"))
        members[name].save(path)
        out[name] = path
    path = str(tmp_path_factory.mktemp("anomaly_auto"))
    # arima wins series 0, 2, 4 (sorted member order: arima, holt_winters)
    jens.MultiModelForecaster(
        {"arima": members["arima"], "holt_winters": members["holt_winters"]},
        np.array([0, 1, 0, 1, 0, 1])).save(path)
    out["auto"] = path
    return out


def _scorers(path, conf=None):
    config = {"enabled": True, **(conf or {})}
    return (tanom.AnomalyScorer(tload(path, device="cpu"),
                                tanom.AnomalyConfig.from_conf(config)),
            janom.AnomalyScorer(jload(path),
                                janom.AnomalyConfig.from_conf(config)))


def _points(catalog):
    """The last 40 days of every series, shuffled, with planted spikes, an
    unknown series, a NaN actual and a point 2,000 days out."""
    last = catalog["date"].max()
    pts = catalog[catalog["date"] > last - pd.Timedelta(days=2 * HELD_OUT)]
    pts = pts.rename(columns={"date": "ds", "sales": "y"}).reset_index(
        drop=True)
    sd = catalog.groupby(["store", "item"])["sales"].std()
    rng = np.random.default_rng(3)
    spikes = rng.choice(len(pts), 12, replace=False)
    for i in spikes:
        k = (pts.at[i, "store"], pts.at[i, "item"])
        pts.at[i, "y"] += 50.0 * sd[k] * (1 if i % 2 else -1)
    pts["planted"] = False
    pts.loc[spikes, "planted"] = True
    extra = pd.DataFrame({
        "store": [9, 1, 2], "item": [9, 1, 2],
        "ds": [last, last - pd.Timedelta(days=3),
               last + pd.Timedelta(days=2000)],
        "y": [1.0, np.nan, 5.0], "planted": False})
    pts = pd.concat([pts, extra], ignore_index=True)
    pts = pts.sample(frac=1.0, random_state=5).reset_index(drop=True)
    pts["ds"] = pts["ds"].dt.strftime("%Y-%m-%d")
    return pts


def _family_of(fc, store, item):
    if not hasattr(fc, "assignment"):
        return fc.family
    i = next(j for j, k in enumerate(fc.keys.tolist())
             if tuple(k) == (store, item))
    return fc.models[fc.assignment[i]]


def _assert_threshold_close(got, want):
    assert abs(got - want) <= 2 * np.spacing(np.float32(want)), (got, want)


def _compare(got, want, scorer, scale, threshold):
    """Results of one request in both packages: -> points whose flag may
    differ (their score lies within the tolerance of the threshold)."""
    fc, z = scorer.forecaster, scorer._z_w
    assert [k for k in got if k != "threshold"] == [
        k for k in want if k != "threshold"]
    for k in ("n_scored", "n_skipped"):
        assert got[k] == want[k], k
    assert len(got["results"]) == len(want["results"]) == got["n_scored"]
    ambiguous = 0
    for g, w in zip(got["results"], want["results"]):
        assert list(g) == list(w)
        for k in ("store", "item", "ds", "y"):
            assert g[k] == w[k], k
        rtol, frac = TOL[_family_of(fc, w["store"], w["item"])]
        err = {}
        for k in ("yhat", "yhat_lower", "yhat_upper"):
            err[k] = abs(g[k] - w[k])
            assert err[k] <= rtol * abs(w[k]) + frac * scale, (k, g, w)
        band = w["yhat_upper"] - w["yhat"]
        e = rtol * abs(w["yhat_upper"]) + frac * scale
        tol = 2.0 * e * (z + 2.0 * w["anomaly_score"]) / band + 1e-6
        assert abs(g["anomaly_score"] - w["anomaly_score"]) <= tol, (g, w)
        if abs(w["anomaly_score"] - threshold) > tol:
            assert g["is_anomaly"] == w["is_anomaly"], (g, w)
        else:
            ambiguous += 1
    assert abs(got["n_flagged"] - want["n_flagged"]) <= ambiguous
    return ambiguous


@pytest.mark.parametrize("family", FAMILIES)
def test_scores_match_the_reference(artifacts, catalog, family):
    port, ref = _scorers(artifacts[family], {"max_horizon": 60})
    pts = _points(catalog)
    got = port.score(pts.drop(columns=["planted"]))
    want = ref.score(pts.drop(columns=["planted"]))
    _assert_threshold_close(got["threshold"], want["threshold"])
    scale = float(np.abs(catalog["sales"]).max())
    _compare(got, want, port, scale, want["threshold"])
    # request order kept: the results are the scored points in input order
    scored = pts[pts["store"].between(1, 2) & pts["y"].notna()
                 & (pd.to_datetime(pts["ds"]) <= catalog["date"].max())]
    assert [(r["store"], r["item"], r["ds"]) for r in got["results"]] == list(
        scored[["store", "item", "ds"]].itertuples(index=False, name=None))
    assert got["n_skipped"] == 3
    flagged = {(r["store"], r["item"], r["ds"]) for r in got["results"]
               if r["is_anomaly"]}
    planted = set(pts[pts["planted"]][["store", "item", "ds"]].itertuples(
        index=False, name=None))
    assert planted <= flagged
    # the port's scores are the formula on its own bands, rounded as the
    # reference rounds
    z = port._z_w
    for r in got["results"]:
        sigma = max((r["yhat_upper"] - r["yhat"]) / z, 1e-9)
        assert r["anomaly_score"] == round(abs(r["y"] - r["yhat"]) / sigma, 6)
        assert r["is_anomaly"] == (abs(r["y"] - r["yhat"]) / sigma
                                   > got["threshold"])


def test_metrics_render_like_the_reference(artifacts, catalog):
    port, ref = _scorers(artifacts["holt_winters"])
    pts = _points(catalog).drop(columns=["planted"])
    for s in (port, ref):
        s.score(pts)
        s.score(pts.head(5), threshold=3.0)
    got, want = port.render_metrics(), ref.render_metrics()
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines) == 8 * 3
    for g, w in zip(g_lines, w_lines):
        if g.startswith("dftpu_anomaly_threshold "):
            _assert_threshold_close(float(g.split()[1]), float(w.split()[1]))
        else:
            assert g == w
    g_snap, w_snap = port.snapshot(), ref.snapshot()
    for k in ("threshold", "band_z"):
        _assert_threshold_close(g_snap.pop(k), w_snap.pop(k))
    assert g_snap == w_snap == {"stream_scoring": True}


def test_threshold_override_and_configured_threshold(artifacts, catalog):
    pts = _points(catalog).drop(columns=["planted"])
    port, ref = _scorers(artifacts["prophet"], {"threshold": 4.5})
    assert port.threshold == ref.threshold == 4.5
    for thr in (None, 2.0, 8.0):
        got = port.score(pts, threshold=thr)
        want = ref.score(pts, threshold=thr)
        assert got["threshold"] == want["threshold"] == (thr or 4.5)
        _compare(got, want, port, float(catalog["sales"].abs().max()),
                 got["threshold"])


@pytest.mark.parametrize("case", ["unknown_skip", "unknown_raise",
                                  "beyond_horizon", "nan_only",
                                  "missing_column", "no_ds", "ord_column"])
def test_skips_and_refusals_match_the_reference(artifacts, catalog, case):
    port, ref = _scorers(artifacts["prophet"], {"max_horizon": 5})
    last = catalog["date"].max()
    frame = pd.DataFrame({
        "store": [1, 9, 2], "item": [2, 9, 3],
        "ds": [str((last - pd.Timedelta(days=1)).date())] * 2
        + [str((last + pd.Timedelta(days=30)).date())],
        "y": [3.0, 4.0, 5.0]})
    on_missing = "skip"
    if case == "unknown_raise":
        on_missing = "raise"
    elif case == "beyond_horizon":
        frame = frame.iloc[[2]]
    elif case == "nan_only":
        frame = frame.assign(y=np.nan)
    elif case == "missing_column":
        frame = frame.drop(columns=["item"])
    elif case == "no_ds":
        frame = frame.drop(columns=["ds"])
    elif case == "ord_column":
        frame = frame.drop(columns=["ds"]).assign(
            _ord=(last - pd.Timestamp("1970-01-01")).days - 2)
    outcomes = []
    for s in (port, ref):
        try:
            outcomes.append(("ok", s.score(frame, on_missing=on_missing)))
        except Exception as e:  # noqa: BLE001 — the error is the outcome
            outcomes.append((type(e).__name__, str(e)))
    (g_kind, got), (w_kind, want) = outcomes
    assert g_kind == w_kind
    if g_kind != "ok":
        assert got == want
        assert g_kind == {"unknown_raise": "UnknownSeriesError"}.get(
            case, "ValueError")
        return
    _assert_threshold_close(got.pop("threshold"), want.pop("threshold"))
    if case in ("beyond_horizon", "nan_only"):
        assert got == want and got["n_scored"] == 0
    else:
        _compare(dict(got, threshold=0), dict(want, threshold=0), port,
                 float(catalog["sales"].abs().max()), 1e9)
    assert (port.skipped_total.value == ref.skipped_total.value
            == got["n_skipped"])


def _stream_rows(store):
    return [{k: v for k, v in p.items() if k != "ts"} for p in store.query()]


def test_score_ingest_and_the_stream_store(artifacts, catalog, tmp_path):
    path = artifacts["holt_winters"]
    port = tanom.build_anomaly_runtime(
        {"enabled": True}, tload(path, device="cpu"),
        default_store_dir=str(tmp_path / "port"))
    ref = janom.build_anomaly_runtime(
        {"enabled": True}, jload(path),
        default_store_dir=str(tmp_path / "ref"))
    pts = _points(catalog)
    pts = pts[pts["store"] < 9].dropna()
    epoch = pd.Timestamp("1970-01-01")
    rows = [{"k": [int(r.store), int(r.item)],
             "d": int((pd.Timestamp(r.ds) - epoch).days), "y": float(r.y)}
            for r in pts.itertuples()]
    got, want = port.score_ingest(rows), ref.score_ingest(rows)
    _assert_threshold_close(got.pop("threshold"), want.pop("threshold"))
    assert got == want and got["flagged"] >= 12 and got["skipped"] == 1
    assert port.stream_points.value == ref.stream_points.value == got["scored"]
    assert port.points_total.value == 0
    port.score(pts.drop(columns=["planted"]).head(40))
    ref.score(pts.drop(columns=["planted"]).head(40))
    g_rows, w_rows = _stream_rows(port.store), _stream_rows(ref.store)
    assert [(r["name"], r["labels"]) for r in g_rows] == [
        (r["name"], r["labels"]) for r in w_rows]
    assert {r["labels"]["source"] for r in g_rows} == {"ingest", "endpoint"}
    np.testing.assert_allclose([r["value"] for r in g_rows],
                               [r["value"] for r in w_rows], rtol=1e-3)
    # the stream's segments are read by the other package's store
    assert (_stream_rows(jstore.TimeSeriesStore(str(tmp_path / "port")))
            == g_rows)
    assert port.snapshot()["stream_store"]["segments"] == 1


def test_build_anomaly_runtime_gates(artifacts, tmp_path):
    fc = tload(artifacts["holt_winters"], device="cpu")
    assert tanom.build_anomaly_runtime(None, fc) is None
    assert tanom.build_anomaly_runtime({"enabled": False}, fc) is None
    s = tanom.build_anomaly_runtime({"enabled": True}, fc)
    assert s.store is None and s.threshold == s._z_w
    s = tanom.build_anomaly_runtime(
        {"enabled": True, "stream_store_dir": str(tmp_path / "own"),
         "threshold": 3, "stream_scoring": False}, fc,
        default_store_dir=str(tmp_path / "default"))
    assert s.store.directory == str(tmp_path / "own")
    assert isinstance(s.store, tstore.TimeSeriesStore)
    assert s.threshold == 3.0 and s.config.stream_scoring is False
    for bad in ({"enabled": True, "treshold": 1}, {"threshold": -1},
                {"max_horizon": 0}, {"max_points_per_request": 0},
                {"max_horizon": "x"}):
        with pytest.raises(ValueError) as got:
            tanom.build_anomaly_runtime(bad, fc)
        with pytest.raises(ValueError) as want:
            janom.build_anomaly_runtime(bad, jload(artifacts["holt_winters"]))
        assert str(got.value) == str(want.value)
    conf = {"enabled": True, "threshold": None, "max_horizon": 30.0}
    got, want = (tanom.AnomalyConfig.from_conf(conf),
                 janom.AnomalyConfig.from_conf(conf))
    assert [(f, getattr(got, f)) for f in got.__dataclass_fields__] == [
        (f, getattr(want, f)) for f in want.__dataclass_fields__]


def test_bound_execute_carries_the_predict(artifacts, catalog):
    """Once bound, the scorer predicts through the server's ``execute``
    (the coalescer's entry), with the reference's arguments."""
    port, _ = _scorers(artifacts["auto"])
    pts = _points(catalog).drop(columns=["planted"])
    solo = port.score(pts)
    calls = []

    def execute(frame, **kw):
        calls.append(kw)
        return port.forecaster.predict(frame, horizon=kw["horizon"],
                                       include_history=kw["include_history"],
                                       on_missing=kw["on_missing"])

    port.bind_execute(execute)
    assert json.dumps(port.score(pts)) == json.dumps(solo)
    assert calls == [{"horizon": 365, "include_history": True,
                      "quantiles": None, "on_missing": "skip", "xreg": None}]
    assert isinstance(port.forecaster.forecasters["arima"],
                      tpred.BatchForecaster)
