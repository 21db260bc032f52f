"""Port parity: ``POST /observe``'s quality scoring (``monitoring/quality.py``,
``ops/metrics.quality_terms``).

- ``quality_terms`` on the same numpy inputs (NaN actuals, masked points,
  gaps in the period ordinals) equals the JAX function's terms exactly: every
  term is one or two float32 operations that XLA cannot contract.
- One artifact written by the reference is loaded by both packages; the same
  observation batches go through both monitors.  Counts, keys, nominal
  coverage and the worst-series rows agree exactly; WAPE, RMSSE and coverage
  within rtol 1e-5 (the served paths differ by the forecast's float32
  rounding, ``tests/test_torch_predictor.py``).
- The port's accumulators equal a float64 numpy computation over the port's
  own served bands bit for bit.
- ``build_quality_runtime``: strict keys and the reference's messages; with
  the store and the SLO evaluator on, the same parts are wired as in the
  reference, the monitor's store rows equal the reference's (but for their
  wall-clock stamps), and ``render_metrics`` carries the reference's
  ``dftpu_slo_*`` families.
- The ``dftpu_data_quality_*`` gauges: after the same ``quality_report``,
  the port's exposition is byte-equal to the reference's.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
from distributed_forecasting_tpu.engine import fit as jfit
from distributed_forecasting_tpu.models import holt_winters as jhw
from distributed_forecasting_tpu.data import quality as jdq
from distributed_forecasting_tpu.monitoring import quality as jq
from distributed_forecasting_tpu.ops import metrics as jmetrics
from distributed_forecasting_tpu.serving import predictor as jpred
from distributed_forecasting_tpu_torch.data import quality as tdq
from distributed_forecasting_tpu_torch.monitoring import quality as tq
from distributed_forecasting_tpu_torch.ops import metrics as tmetrics
from distributed_forecasting_tpu_torch.serving import predictor as tpred

torch.set_num_threads(1)

FIELDS = ("abs_err", "abs_y", "sq_err", "inside", "n", "naive_sq", "naive_n")


def _term_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    y = rng.gamma(2.0, 20.0, shape).astype(np.float32)
    y[rng.random(shape) < 0.05] = np.nan
    yhat = (y + rng.normal(0, 5, shape)).astype(np.float32)
    yhat[rng.random(shape) < 0.02] = np.inf
    half = rng.uniform(1, 15, shape).astype(np.float32)
    lo, hi = (yhat - half).astype(np.float32), (yhat + half).astype(np.float32)
    step = np.cumsum(rng.integers(1, 3, shape), axis=-1).astype(np.int32)
    mask = rng.random(shape) > 0.2
    return y, yhat, lo, hi, step, mask


@pytest.mark.parametrize("seed,shape", [(0, (1, 2)), (1, (4, 16)),
                                        (2, (8, 64)), (3, (2, 3, 33))])
def test_quality_terms_equal_the_reference(seed, shape):
    args = _term_inputs(seed, shape)
    want = jmetrics.quality_terms(*(jnp.asarray(a) for a in args))
    got = tmetrics.quality_terms(*(torch.from_numpy(a) for a in args))
    assert set(got) == set(want) == set(FIELDS)
    for f in FIELDS:
        assert got[f].dtype == torch.float32, f
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]),
                                      err_msg=f)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    df = jdata.synthetic_store_item_sales(n_stores=2, n_items=5, n_days=300,
                                          seed=21, missing_rate=0.03)
    df["sales"] = df["sales"].round()
    jb = jdata.tensorize(df)
    cfg = jhw.HoltWintersConfig(interval_width=0.9)
    params, _ = jfit.fit_forecast(jb, model="holt_winters", config=cfg,
                                  horizon=30, autoprep=False)
    scale = np.linspace(0.7, 1.5, jb.n_series).astype(np.float32)
    fc = jpred.BatchForecaster.from_fit(jb, params, "holt_winters", cfg,
                                        interval_scale=scale)
    path = str(tmp_path_factory.mktemp("quality_artifact"))
    fc.save(path)
    return df, path


def _observations(df, seed):
    """The last 28 days of actuals for 7 series, 5 days past the fit end
    (predictions only), one unknown series and one date past max_horizon."""
    rng = np.random.default_rng(seed)
    last = df["date"].max()
    obs = df[df["date"] > last - pd.Timedelta(days=28)]
    keys = obs[["store", "item"]].drop_duplicates().sample(7, random_state=seed)
    obs = obs.merge(keys)
    future = keys.assign(date=last + pd.Timedelta(days=3),
                         sales=rng.uniform(10, 60, len(keys)))
    extra = pd.DataFrame({"store": [9, 1], "item": [9, 1],
                          "date": [last, last + pd.Timedelta(days=900)],
                          "sales": [1.0, 2.0]})
    out = pd.concat([obs, future, extra], ignore_index=True)
    out = out.rename(columns={"date": "ds", "sales": "y"})
    out["ds"] = out["ds"].dt.strftime("%Y-%m-%d")
    return out.sample(frac=1.0, random_state=seed)


def _monitors(path):
    jfc = jpred.BatchForecaster.load(path)
    tfc = tpred.BatchForecaster.load(path, device="cpu")
    conf = {"enabled": True, "max_horizon": 90}
    return (jq.QualityMonitor(jfc, jq.QualityConfig.from_conf(conf)),
            tq.QualityMonitor(tfc, tq.QualityConfig.from_conf(conf)))


def _assert_summaries_match(got, want):
    assert list(got) == list(want)
    for k in ("family", "n_series", "series_observed", "observations",
              "nominal_coverage"):
        assert got[k] == want[k], k
    for m, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][m], v, rtol=1e-5, err_msg=m)
    if "worst_series" in want:
        by_key = lambda rows: {(r["store"], r["item"]): r for r in rows}  # noqa: E731
        g, w = by_key(got["worst_series"]), by_key(want["worst_series"])
        assert set(g) == set(w)
        for k, row in w.items():
            assert list(g[k]) == list(row) and g[k]["n"] == row["n"]
            for m in ("wape", "rmsse", "coverage"):
                np.testing.assert_allclose(g[k][m], row[m], rtol=1e-5,
                                           atol=1e-6)


def test_observe_and_snapshot_match_the_reference(artifact):
    df, path = artifact
    jmon, tmon = _monitors(path)
    for seed in (0, 1, 2):  # rolling: the accumulators carry across calls
        obs = _observations(df, seed)
        _assert_summaries_match(tmon.observe(obs), jmon.observe(obs))
    _assert_summaries_match(tmon.snapshot(), jmon.snapshot())
    _assert_summaries_match(tmon.snapshot(series=False),
                            jmon.snapshot(series=False))
    np.testing.assert_allclose(tmon.coverage(), jmon.coverage(), rtol=1e-6)
    for c in ("observe_requests", "observations_total",
              "observations_skipped", "series_observed"):
        assert getattr(tmon, c).value == getattr(jmon, c).value, c


def test_observe_raises_on_missing_series_like_the_reference(artifact):
    df, path = artifact
    for mon in _monitors(path):
        obs = _observations(df, 0)
        with pytest.raises(KeyError, match="training set"):
            mon.observe(obs, on_missing="raise")
        with pytest.raises(ValueError, match=r"missing column\(s\) \['y'\]"):
            mon.observe(obs.drop(columns=["y"]))


def test_observe_with_nothing_in_the_grid_counts_skips(artifact):
    df, path = artifact
    far = pd.DataFrame({"store": [1], "item": [1], "ds": ["2031-01-01"],
                        "y": [3.0]})
    for mon in _monitors(path):
        out = mon.observe(far)
        assert out["observations"] == 0 and "worst_series" not in out
        assert mon.observations_skipped.value == 1


def _numpy_accumulators(fc, obs, max_horizon=90):
    """WAPE / RMSSE / coverage sums in float64 over the served bands: the
    terms in float32 as the monitor forms them, each sum in float64."""
    obs = obs.copy()
    obs["ds"] = pd.to_datetime(obs["ds"])
    obs = obs[(obs["ds"] - pd.Timestamp("1970-01-01")).dt.days
              <= fc.day1 + max_horizon]
    known = {tuple(k) for k in fc.keys.tolist()}
    obs = obs[[k in known for k in zip(obs["store"], obs["item"])]]
    pred = fc.predict(obs[["store", "item"]].drop_duplicates(),
                      horizon=max_horizon, include_history=True)
    m = obs.merge(pred, on=["store", "item", "ds"])
    m = m.sort_values(["store", "item", "ds"])
    y, yhat = m["y"].to_numpy(np.float32), m["yhat"].to_numpy(np.float32)
    lo = m["yhat_lower"].to_numpy(np.float32)
    hi = m["yhat_upper"].to_numpy(np.float32)
    ok = np.isfinite(y) & np.isfinite(yhat)
    err = np.where(ok, y - yhat, np.float32(0))
    acc = {"abs_err": np.abs(err), "abs_y": np.abs(np.where(ok, y, 0)),
           "sq_err": err * err,
           "inside": (ok & (y >= lo) & (y <= hi)).astype(np.float32),
           "n": ok.astype(np.float32)}
    # one-step naive differences within a series over consecutive days
    same = ((m["store"].to_numpy()[1:] == m["store"].to_numpy()[:-1])
            & (m["item"].to_numpy()[1:] == m["item"].to_numpy()[:-1]))
    step = (m["ds"] - pd.Timestamp("1970-01-01")).dt.days.to_numpy()
    adj = same & ok[1:] & ok[:-1] & (np.diff(step) == 1)
    d = np.where(adj, y[1:] - y[:-1], np.float32(0))
    acc["naive_sq"], acc["naive_n"] = d * d, adj.astype(np.float32)
    return {k: float(np.sum(v.astype(np.float64))) for k, v in acc.items()}


def test_port_accumulators_equal_a_float64_numpy_computation(artifact):
    df, path = artifact
    _, tmon = _monitors(path)
    obs = _observations(df, 4)
    summary = tmon.observe(obs)
    want = _numpy_accumulators(tmon.forecaster, obs)
    got = {f: float(tmon._acc[f].sum()) for f in FIELDS}
    for f in FIELDS:
        assert got[f] == pytest.approx(want[f], rel=1e-12, abs=0), f
    assert summary["metrics"]["wape"] == pytest.approx(
        want["abs_err"] / want["abs_y"], rel=1e-12)
    assert summary["metrics"]["coverage"] == pytest.approx(
        want["inside"] / want["n"], rel=1e-12)
    assert summary["metrics"]["rmsse"] == pytest.approx(np.sqrt(
        (want["sq_err"] / want["n"]) / (want["naive_sq"] / want["naive_n"])),
        rel=1e-12)


def test_quality_registry_renders_like_the_reference(artifact):
    _, path = artifact
    jmon, tmon = _monitors(path)
    assert tmon.registry.render_prometheus() == jmon.registry.render_prometheus()
    obs = _observations(artifact[0], 5)
    jmon.observe(obs)
    tmon.observe(obs)
    strip = lambda text: [line.rsplit(" ", 1)[0] if not line.startswith("#")  # noqa: E731
                          else line for line in text.splitlines()]
    assert (strip(tmon.registry.render_prometheus())
            == strip(jmon.registry.render_prometheus()))


@pytest.mark.parametrize("conf", [None, {}, {"enabled": True},
                                  {"enabled": 1, "max_horizon": "30",
                                   "nominal_coverage": 0.8},
                                  {"nominal_coverage": None}])
def test_quality_config_from_conf_matches_the_reference(conf):
    got = tq.QualityConfig.from_conf(conf)
    want = jq.QualityConfig.from_conf(conf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("bad", [{"max_horizn": 3}, {"max_horizon": 0},
                                 {"nominal_coverage": 1.0}])
def test_quality_config_refuses_like_the_reference(bad):
    with pytest.raises(ValueError) as got:
        tq.QualityConfig.from_conf(bad)
    with pytest.raises(ValueError) as want:
        jq.QualityConfig.from_conf(bad)
    assert str(got.value) == str(want.value)


def test_build_quality_runtime(artifact):
    _, path = artifact
    fc = tpred.BatchForecaster.load(path, device="cpu")
    assert tq.build_quality_runtime(None, fc) is None
    assert tq.build_quality_runtime({"quality": {"enabled": False},
                                     "cost": {"enabled": True}}, fc) is None
    rt = tq.build_quality_runtime(
        {"quality": {"enabled": True}, "quality_store": {"enabled": False},
         "slo": {"enabled": False}, "tracking_root": "/x",
         "cost": {"enabled": True}}, fc)
    assert isinstance(rt.monitor, tq.QualityMonitor)
    assert (rt.store, rt.scrape, rt.slo) == (None, None, None)
    assert rt.monitor.nominal_coverage == pytest.approx(0.9)
    assert "dftpu_quality_nominal_coverage 0.9" in rt.render_metrics()
    assert set(rt.snapshot()) == {"quality"}
    with pytest.raises(ValueError) as got:
        tq.build_quality_runtime({"qualty": {}}, fc)
    with pytest.raises(ValueError) as want:
        jq.build_quality_runtime({"qualty": {}}, fc)
    assert str(got.value) == str(want.value)
    # the store and the SLO evaluator come together, as in the reference
    for conf, default in (
            ({"quality": {"enabled": True}, "slo": {"enabled": True}}, "/x"),
            ({"quality_store": {"enabled": True}}, None)):
        with pytest.raises(ValueError) as got:
            tq.build_quality_runtime(conf, fc, default_store_dir=default)
        with pytest.raises(ValueError) as want:
            jq.build_quality_runtime(conf, jpred.BatchForecaster.load(path),
                                     default_store_dir=default)
        assert str(got.value) == str(want.value)


SLO = {"enabled": True, "evaluation_interval_s": 3600,
       "rules": [{"name": "p95", "kind": "latency_quantile",
                  "objective": 0.5},
                 {"name": "cov", "kind": "coverage", "tolerance": 0.05},
                 {"name": "stale", "kind": "staleness", "objective": 60}]}


def _runtimes(path, tmp_path):
    conf = {"quality": {"enabled": True, "max_horizon": 90},
            "quality_store": {"enabled": True, "scrape_interval_s": 3600},
            "slo": SLO, "cost": {"enabled": True}}
    tracking = str(tmp_path / "tracking")
    os.makedirs(os.path.join(tracking, "experiments"))
    return (
        tq.build_quality_runtime(
            conf, tpred.BatchForecaster.load(path, device="cpu"),
            tracking_root=tracking,
            default_store_dir=str(tmp_path / "port")),
        jq.build_quality_runtime(
            conf, jpred.BatchForecaster.load(path), tracking_root=tracking,
            default_store_dir=str(tmp_path / "ref")))


def test_store_scrape_and_slo_are_wired_like_the_reference(artifact,
                                                           tmp_path):
    df, path = artifact
    port, ref = _runtimes(path, tmp_path)
    for rt, d in ((port, "port"), (ref, "ref")):
        assert rt.store.directory == str(tmp_path / d)
        assert rt.slo.store is rt.store and rt.monitor.store is rt.store
        assert rt.scrape is not None
    assert set(port.snapshot()) == set(ref.snapshot()) == {
        "quality", "slo", "store"}
    assert port.snapshot()["slo"] == ref.snapshot()["slo"]
    obs = _observations(df, 1)
    port.observe(obs)
    ref.observe(obs)
    rows = {k: [(p["name"], p["labels"]) for p in rt.store.query()]
            for k, rt in (("port", port), ("ref", ref))}
    assert rows["port"] == rows["ref"] and len(rows["port"]) > 4
    got = [p["value"] for p in port.store.query()]
    want = [p["value"] for p in ref.store.query()]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    now = 1_700_000_000.0
    states = [rt.slo.evaluate_once(now=now) for rt in (port, ref)]
    # no latency histogram bound and no tracking run yet: only the coverage
    # rule is measurable
    assert ([(r["name"], r["bad"] is None) for r in states[0]["rules"]]
            == [("p95", True), ("cov", False), ("stale", True)])
    assert ([r["bad"] for r in states[0]["rules"]]
            == [r["bad"] for r in states[1]["rules"]])
    strip = lambda text: [line.rsplit(" ", 1)[0] if not line.startswith("#")  # noqa: E731
                          else line for line in text.splitlines()]
    assert strip(port.render_metrics()) == strip(ref.render_metrics())
    assert "dftpu_slo_evaluations_total 1" in port.render_metrics()
    # one scrape at an injected time writes the same series; the cost
    # registry rides the scrape in both (monitoring.cost is on by default):
    # its unlabeled families (saturation, watermarks) are the same rows,
    # its labeled ones hold whatever entries each process has charged
    for rt in (port, ref):
        rt.scrape.scrape_once(now=now)
    rows = [[(p["name"], p["labels"]) for p in rt.store.query(since=now)
             if not p["name"].startswith("dftpu_cost_")]
            for rt in (port, ref)]
    assert rows[0] == rows[1]
    assert ("dftpu_slo_evaluations_total", {}) in rows[0]
    cost_rows = [sorted(p["name"] for p in rt.store.query(since=now)
                        if p["name"].startswith("dftpu_cost_")
                        and not p["labels"])
                 for rt in (port, ref)]
    assert cost_rows[0] == cost_rows[1]
    assert "dftpu_cost_watermark_host_rss_bytes" in cost_rows[0]


def test_runtime_start_and_stop_join_both_loops(artifact, tmp_path):
    _, path = artifact
    port, _ = _runtimes(path, tmp_path)
    port.start()
    threads = (port.scrape._thread, port.slo._thread)
    assert all(t.is_alive() for t in threads)
    port.stop()
    assert not any(t.is_alive() for t in threads)
    assert port.scrape._thread is None and port.slo._thread is None
    assert port.store.query(name="dftpu_quality_nominal_coverage")


@pytest.mark.parametrize("feed", ["clean", "dirty", "empty"])
def test_data_quality_gauges_render_like_the_reference(feed):
    df = jdata.synthetic_store_item_sales(n_stores=2, n_items=2, n_days=90,
                                          seed=8)
    if feed == "dirty":
        df = pd.concat([df, df.head(3)], ignore_index=True)
        df.loc[[4, 9], "sales"] = [-2.0, np.nan]
    elif feed == "empty":
        df = df.head(0)
    before = (tdq.data_quality_snapshot()["dftpu_data_quality_reports_total"],
              jdq.data_quality_snapshot()["dftpu_data_quality_reports_total"])
    got, want = tdq.quality_report(df), jdq.quality_report(df)
    assert got.to_dict() == want.to_dict()
    g_text = tdq.render_data_quality_metrics()
    w_text = jdq.render_data_quality_metrics()
    assert g_text and w_text
    # the reports counter is process-wide: compare the rest byte for byte
    # and the counter by its delta (tests share the module's registry)
    count = "dftpu_data_quality_reports_total "
    assert ([x for x in g_text.splitlines() if not x.startswith(count)]
            == [x for x in w_text.splitlines() if not x.startswith(count)])
    g_snap, w_snap = tdq.data_quality_snapshot(), jdq.data_quality_snapshot()
    assert g_snap.pop("dftpu_data_quality_reports_total") == before[0] + 1
    assert w_snap.pop("dftpu_data_quality_reports_total") == before[1] + 1
    assert g_snap == w_snap
    assert g_snap["dftpu_data_quality_issues"] == len(got.issues)
