"""Port parity: model monitoring against the JAX reference — the profile
table (``run_monitor``), the anomaly scan, PSI/KS drift between table
versions, latest-window degradation, and the ``monitor`` task's summary,
including its drift skip on a table's first version.

The monitor is host pandas and numpy code in float64 on both sides, so
every table is compared exactly (``assert_frame_equal``) on the same
forecast table, but for one column.  The one number from the array library
is the band's z, the float32 inverse normal CDF of ``0.5 + width / 2``:
torch's ``ndtri`` is correctly rounded there, XLA's Cephes polynomial is one
float32 ulp off it at some widths (0.8, 0.95 and 0.99 among the common
ones; a port of its polynomial in float32 matches it no better, because
XLA contracts it into FMAs and has its own ``log``).  So z is held within
one ulp, the anomaly scan's ``anomaly_score`` (|y - yhat| z / half-band)
within rtol 2.4e-7 (two ulps), and ``is_anomaly`` equal wherever the score
is farther than that from the threshold (every row of these tables, which
the test checks).

Inputs: a forecast table in the training pipeline's schema, 2 stores x 3
items x 120 days of history (with masked days and a zero actual) plus 14
future days without actuals, made with numpy from a seed, and a second
version of it whose last weeks drift and degrade for some series.
"""

import numpy as np
import pandas as pd
import pytest
import torch
from jax.scipy.special import ndtri as jndtri

from distributed_forecasting_tpu.data.catalog import DatasetCatalog as JCatalog
from distributed_forecasting_tpu.monitoring import monitor as jmon
from distributed_forecasting_tpu.tasks.monitor import (
    MonitorTask as JMonitorTask,
)
from distributed_forecasting_tpu_torch.data.catalog import DatasetCatalog
from distributed_forecasting_tpu_torch.models.base import _ndtri
from distributed_forecasting_tpu_torch.monitoring import monitor as tmon
from distributed_forecasting_tpu_torch.tasks import MonitorTask, TASK_TYPES

torch.set_num_threads(1)

TABLE = "hackathon.sales.finegrain_forecasts"


def _forecast_table(seed=0, shift=0.0, degrade=()):
    rng = np.random.default_rng(seed)
    days = pd.date_range("2017-01-02", periods=134, freq="D")
    rows = []
    for store in (1, 2):
        for item in (1, 2, 3):
            level = rng.uniform(5, 40)
            y = level * (1 + 0.2 * np.sin(np.arange(134) * 2 * np.pi / 7))
            y = np.round(y + rng.normal(0, 2, 134) + shift)
            yhat = level * (1 + 0.2 * np.sin(np.arange(134) * 2 * np.pi / 7))
            yhat = yhat + rng.normal(0, 0.5, 134)
            if (store, item) in degrade:
                yhat[-28:] *= 1.8  # the latest weeks' forecasts break
            half = rng.uniform(2, 6) * (1 + np.arange(134) / 200)
            y[120:] = np.nan            # the horizon has no actuals
            y[rng.random(134) < 0.05] = np.nan
            y[7] = 0.0                  # a zero actual (mape skips it)
            rows.append(pd.DataFrame({
                "ds": days, "store": store, "item": item, "y": y,
                "yhat": yhat, "yhat_upper": yhat + half,
                "yhat_lower": np.maximum(yhat - half, 0.0),
                "training_date": pd.Timestamp("2017-05-16")}))
    return pd.concat(rows, ignore_index=True)


@pytest.fixture()
def catalogs(tmp_path):
    """The same two versions of the forecast table in a store of each
    package."""
    port = DatasetCatalog(str(tmp_path / "port"))
    ref = JCatalog(str(tmp_path / "ref"))
    first = _forecast_table(seed=0)
    second = _forecast_table(seed=0, shift=6.0, degrade={(2, 3)})
    for cat in (port, ref):
        cat.save_table(TABLE, first)
    return port, ref, second


Z_RTOL = 2.0 ** -22  # two float32 ulps of relative distance


@pytest.mark.parametrize("width", [0.5, 0.8, 0.9, 0.95, 0.99])
def test_band_z_within_one_ulp_of_the_references(width):
    got = _ndtri(0.5 + width / 2.0, "cpu")
    want = torch.tensor(float(jndtri(0.5 + width / 2.0)))
    assert got.dtype == torch.float32
    assert float(torch.abs(got - want)) <= float(
        torch.nextafter(want, torch.tensor(np.inf)) - want)


def _scores_close(got, want, threshold):
    """anomaly_score within Z_RTOL; is_anomaly equal, no score so near the
    threshold that a one-ulp z could flip it; the rest exactly equal."""
    np.testing.assert_allclose(got["anomaly_score"], want["anomaly_score"],
                               rtol=Z_RTOL, atol=0)
    near = np.abs(want["anomaly_score"] - threshold) <= Z_RTOL * threshold
    assert not near.any()
    rest = [c for c in want.columns if c != "anomaly_score"]
    pd.testing.assert_frame_equal(got[rest], want[rest])


CONFIGS = {
    "default": {},
    "monthly": {"granularities": ("1 day", "1 week", "1 month"),
                "slicing_cols": ("item",)},
}


@pytest.mark.parametrize("conf", list(CONFIGS), ids=list(CONFIGS))
def test_profile_table_equals_reference(catalogs, conf):
    port, ref, _ = catalogs
    got = tmon.run_monitor(port, tmon.MonitorConfig(
        name="m", table=TABLE, **CONFIGS[conf]))
    want = jmon.run_monitor(ref, jmon.MonitorConfig(
        name="m", table=TABLE, **CONFIGS[conf]))
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(
        port.read_table(f"{TABLE}_profile_metrics"),
        ref.read_table(f"{TABLE}_profile_metrics"))
    assert {"mape", "smape", "bias", "rmse", "coverage"} <= set(got.columns)


@pytest.mark.parametrize("width, threshold", [(0.95, None), (0.8, None),
                                              (0.95, 1.5)])
def test_anomaly_scan_equals_reference(catalogs, width, threshold):
    port, ref, _ = catalogs
    got = tmon.detect_anomalies(port, TABLE, interval_width=width,
                                score_threshold=threshold)
    want = jmon.detect_anomalies(ref, TABLE, interval_width=width,
                                 score_threshold=threshold)
    thr = threshold or float(jndtri(0.5 + width / 2.0))
    _scores_close(got, want, thr)
    assert 0 < int(got["is_anomaly"].sum()) < len(got)
    _scores_close(port.read_table(f"{TABLE}_anomalies"),
                  ref.read_table(f"{TABLE}_anomalies"), thr)


def test_drift_report_equals_reference(catalogs):
    port, ref, second = catalogs
    with pytest.raises(ValueError, match="drift needs a baseline"):
        tmon.drift_report(port, TABLE)
    for cat in (port, ref):
        cat.save_table(TABLE, second)
    kw = dict(slicing_cols=("store", "item"))
    got = tmon.drift_report(port, TABLE, **kw)
    want = jmon.drift_report(ref, TABLE, **kw)
    # the version ids are each store's own write stamps
    versions = ["baseline_version", "current_version"]
    pd.testing.assert_frame_equal(got.drop(columns=versions),
                                  want.drop(columns=versions))
    assert got["baseline_version"].iloc[0] == port.table_versions(TABLE)[0]
    assert got["drifted"].any() and not got["drifted"].all()
    # an explicit baseline, and a segment on one side only
    third = second[second["store"] == 1]
    for cat in (port, ref):
        cat.save_table(TABLE, third)
    got = tmon.drift_report(port, TABLE, baseline_version=port.table_versions(
        TABLE)[0], **kw)
    want = jmon.drift_report(ref, TABLE, baseline_version=ref.table_versions(
        TABLE)[0], **kw)
    pd.testing.assert_frame_equal(got.drop(columns=versions),
                                  want.drop(columns=versions))
    gone = got[(got["slice_key"] == "store") & (got["slice_value"] == "2")]
    assert set(gone["status"]) == {"vanished"} and gone["drifted"].all()


@pytest.mark.parametrize("metric", ["mape", "smape", "rmse", "bias",
                                    "coverage"])
def test_degradation_report_equals_reference(catalogs, metric):
    port, ref, second = catalogs
    for cat in (port, ref):
        cat.save_table(TABLE, second)
    cfg = dict(name="m", table=TABLE)
    got = tmon.degradation_report(port, tmon.MonitorConfig(**cfg),
                                  metric=metric)
    want = jmon.degradation_report(ref, jmon.MonitorConfig(**cfg),
                                   metric=metric)
    pd.testing.assert_frame_equal(got, want)
    assert (got["n_windows"] >= 6).any()
    if metric == "mape":
        broken = got[(got.slice_key == "item") & (got.slice_value == "3")]
        assert bool(broken["degraded"].iloc[0])
    pd.testing.assert_frame_equal(port.read_table(f"{TABLE}_degradation"),
                                  ref.read_table(f"{TABLE}_degradation"))


def test_monitor_registry_round_trip(tmp_path):
    reg = tmon.MonitorRegistry(str(tmp_path))
    cfg = tmon.MonitorConfig(name="a", table=TABLE, slicing_cols=("item",))
    reg.create_monitor(cfg)
    with pytest.raises(FileExistsError):
        reg.create_monitor(cfg, exist_ok=False)
    assert reg.get_monitor("a") == cfg
    # the reference reads what the port wrote
    assert jmon.MonitorRegistry(str(tmp_path)).get_monitor("a").to_dict() == (
        cfg.to_dict())
    assert reg.list_monitors() == ["a"]
    reg.delete_monitor("a")
    with pytest.raises(KeyError):
        reg.get_monitor("a")


MONITOR_CONF = {"name": "finegrain", "table": TABLE, "anomalies": True,
                "drift": True, "degradation": True}


def _task(root, package, **extra):
    conf = {"env": {"root": root}, "monitor": {**MONITOR_CONF, **extra}}
    if package == "ref":
        return JMonitorTask(init_conf=conf)
    return MonitorTask(init_conf=conf, device="cpu")


def test_monitor_task_summary_equals_reference(tmp_path):
    """First version: profile, anomalies and degradation, the drift scan
    skipped; after a second version the drift scan runs.  The summaries and
    every table equal the reference's."""
    roots = {k: str(tmp_path / k) for k in ("port", "ref")}
    tables = (_forecast_table(seed=1),
              _forecast_table(seed=1, shift=4.0, degrade={(1, 2)}))
    for version, table in enumerate(tables):
        out = {}
        for package, root in roots.items():
            cat = (DatasetCatalog if package == "port" else JCatalog)(
                f"{root}/warehouse")
            cat.save_table(TABLE, table)
            out[package] = (_task(root, package).launch(), cat)
        (got, gcat), (want, wcat) = out["port"], out["ref"]
        assert got == want
        assert ("n_drifted" in got) == (version == 1)
        assert {"monitor", "rows", "daily_mape_mean", "n_anomalies",
                "n_degraded"} <= set(got)
        for suffix in ("profile_metrics", "degradation"):
            pd.testing.assert_frame_equal(
                gcat.read_table(f"{TABLE}_{suffix}"),
                wcat.read_table(f"{TABLE}_{suffix}"))
        _scores_close(gcat.read_table(f"{TABLE}_anomalies"),
                      wcat.read_table(f"{TABLE}_anomalies"),
                      float(jndtri(0.975)))
    with pytest.raises(ValueError, match="degradation_granularity"):
        _task(roots["port"], "port",
              degradation_granularity="1 month").launch()
    assert TASK_TYPES["monitor"] is MonitorTask
