"""Port parity: the streaming ingest path (``serving/ingest.py``,
``engine/state_store.py``, ``serving/refit.py``, ``engine/executor.py``,
``POST /ingest``).

The reference's ``tests/unit/test_ingest.py`` cases, on the port (all but
the fleet's max-merge of the shared-WAL gauges, ROADMAP Queue 1: P12, and
the trace report's streaming rollup, P11), then the port against the
reference on the CPU:

- host results exactly: the WAL's segment bytes for the same submits (and
  each package replays the other's directory to the same routed counts),
  the accepted / late / rejected / unknown / out-of-range counts, the
  ``/ingest`` ack JSON and its error answers (400 for a bad body or too
  many points — the reference answers 400 there, not 413 — and 503
  without a runtime), the ``dftpu_ingest_*`` names, types and help texts
  on ``/metrics``, and the ``IngestConfig`` / ``RefitConfig`` errors for an
  unknown key and a bad value (type and message);
- states after streaming, after a forced refit with its replay, and
  across two followers of one WAL: both packages start from the
  reference's fit (``convert.py``), and the theta states agree within
  2.4e-6 of each row's scale (the fuzzed bound of ROADMAP Queue 3); the
  refit's own fit picks the same alpha in both;
- within the port, bitwise: growth across a time bucket equals a pinned
  Holt-Winters fit of the extended series, two followers converge to the
  same bits, predict with ``time_bucket`` 32 is byte-equal to
  ``time_bucket`` 1 for Holt-Winters, theta and croston, and the refit's
  install equals fit-then-update.
"""

import dataclasses
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.engine  # noqa: F401 — before ops.update (import cycle)
from distributed_forecasting_tpu import data as jdata
from distributed_forecasting_tpu.models import base as jbase
from distributed_forecasting_tpu.serving import BatchForecaster as JForecaster
from distributed_forecasting_tpu.serving import ingest as jingest
from distributed_forecasting_tpu.serving import refit as jrefit
from distributed_forecasting_tpu.serving import server as jserver
from distributed_forecasting_tpu_torch import convert
from distributed_forecasting_tpu_torch.data import tensorize
from distributed_forecasting_tpu_torch.engine.executor import (
    PipelineConfig,
    TrainingExecutor,
)
from distributed_forecasting_tpu_torch.engine.state_store import (
    SeriesStateStore,
    time_cap,
)
from distributed_forecasting_tpu_torch.models.base import get_model
from distributed_forecasting_tpu_torch.monitoring.monitor import IngestMetrics
from distributed_forecasting_tpu_torch.serving import server as tserver
from distributed_forecasting_tpu_torch.serving.ingest import (
    IngestConfig,
    WriteAheadLog,
    build_ingest_runtime,
)
from distributed_forecasting_tpu_torch.serving.predictor import (
    BatchForecaster,
)
from distributed_forecasting_tpu_torch.serving.refit import (
    RefitConfig,
    RefitScheduler,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCALE_TOL = 2.4e-6  # theta state vs the reference, of each row's scale
INTERVAL = {"enabled": True, "apply_mode": "interval", "time_bucket": 16}


# ---------------------------------------------------------------------------
# one theta fit by the reference; every test gets fresh forecasters over it
# (a state store installs live state into its forecaster)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def theta_fit():
    df = jdata.synthetic_store_item_sales(n_stores=2, n_items=2, n_days=120,
                                          seed=13)
    jbatch = jdata.tensorize(df)
    cfg = jbase.get_model("theta").config_cls()
    params = jbase.get_model("theta").fit(jbatch.y, jbatch.mask, jbatch.day,
                                          cfg)
    return df, jbatch, params, cfg


def _fresh_fc(theta_fit):
    """The port's forecaster over the reference's theta fit, on the CPU."""
    df, _, jparams, _ = theta_fit
    batch = tensorize(df, device="cpu")
    fns = get_model("theta")
    params = convert.params_from_numpy(
        type(fns.fit(batch.y[:1], batch.mask[:1], batch.day,
                     fns.config_cls())),
        {f.name: np.asarray(getattr(jparams, f.name))
         for f in dataclasses.fields(jparams)}, "cpu")
    return BatchForecaster.from_fit(batch, params, "theta",
                                    fns.config_cls())


def _ref_fc(theta_fit):
    _, jbatch, jparams, cfg = theta_fit
    return JForecaster.from_fit(jbatch, jparams, "theta", cfg)


def _history(theta_fit):
    _, jbatch, _, _ = theta_fit
    return np.asarray(jbatch.y), np.asarray(jbatch.mask)


def _store(fc, **kw):
    return SeriesStateStore(fc, device="cpu", **kw)


def _build(conf, fc, **kw):
    return build_ingest_runtime(conf, fc, device="cpu", **kw)


def _assert_theta_close(port_params, ref_params):
    scale = np.maximum(np.abs(np.asarray(ref_params.level)), 1.0)
    for name in ("level", "intercept", "slope"):
        got = getattr(port_params, name).numpy()
        want = np.asarray(getattr(ref_params, name))
        assert np.all(np.abs(got - want) <= SCALE_TOL * scale), name
    np.testing.assert_allclose(port_params.sigma.numpy(),
                               np.asarray(ref_params.sigma), rtol=1e-5)
    np.testing.assert_array_equal(port_params.alpha.numpy(),
                                  np.asarray(ref_params.alpha))
    assert float(port_params.t_fit_end) == float(ref_params.t_fit_end)


# ---------------------------------------------------------------------------
# conf parsing
# ---------------------------------------------------------------------------

def test_ingest_config_strict_parse():
    cfg = IngestConfig.from_conf({
        "enabled": True, "apply_mode": "interval", "time_bucket": 64,
        "refit": {"enabled": True, "max_applied_points": 10},
    })
    assert cfg.enabled and cfg.apply_mode == "interval"
    assert cfg.time_bucket == 64
    assert cfg.refit == {"enabled": True, "max_applied_points": 10}
    assert not IngestConfig.from_conf({"enabled": None}).enabled
    for bad in ({"aply_mode": "sync"}, {"apply_mode": "eventually"},
                {"apply_interval_ms": 0}, {"time_bucket": 0},
                {"max_points_per_request": 0}, {"max_pending_days": 0}):
        with pytest.raises(ValueError, match="serving.ingest.*aply_mode"
                           if "aply_mode" in bad else list(bad)[0]):
            IngestConfig.from_conf(bad)


def test_refit_config_strict_parse():
    cfg = RefitConfig.from_conf({"enabled": True, "max_applied_points": 7})
    assert cfg.enabled and cfg.max_applied_points == 7
    with pytest.raises(ValueError, match="serving.ingest.refit"):
        RefitConfig.from_conf({"max_stalenes_s": 10})
    with pytest.raises(ValueError, match="max_staleness_s"):
        RefitConfig.from_conf({"max_staleness_s": 0})


@pytest.mark.parametrize("cls, conf", [
    ("IngestConfig", {"aply_mode": "sync"}),
    ("IngestConfig", {"apply_mode": "eventually"}),
    ("IngestConfig", {"max_segment_bytes": 10}),
    ("IngestConfig", {"time_bucket": "x"}),
    ("RefitConfig", {"max_stalenes_s": 10}),
    ("RefitConfig", {"check_interval_s": -1}),
    ("RefitConfig", {"max_applied_points": 0}),
], ids=["ingest-key", "ingest-mode", "ingest-segment", "ingest-type",
        "refit-key", "refit-interval", "refit-points"])
def test_config_errors_match_the_reference(cls, conf):
    """An unknown key and a bad value raise the reference's exception with
    the reference's message, word for word."""
    port = {"IngestConfig": IngestConfig, "RefitConfig": RefitConfig}[cls]
    ref = {"IngestConfig": jingest.IngestConfig,
           "RefitConfig": jrefit.RefitConfig}[cls]
    with pytest.raises(Exception) as want:
        ref.from_conf(conf)
    with pytest.raises(want.type) as got:
        port.from_conf(conf)
    assert str(got.value) == str(want.value)


def test_shipped_conf_block_parses():
    import yaml

    with open(REPO / "conf" / "tasks" / "serve_config.yml") as fh:
        conf = yaml.safe_load(fh)
    block = conf["serving"]["ingest"]
    cfg = IngestConfig.from_conf(block)
    assert not cfg.enabled  # shipped off
    assert not RefitConfig.from_conf(block["refit"]).enabled
    assert cfg == IngestConfig(**dataclasses.asdict(
        jingest.IngestConfig.from_conf(block)))


def test_build_runtime_gating(tmp_path, theta_fit):
    assert build_ingest_runtime(None, None) is None
    assert build_ingest_runtime({"enabled": False}, None) is None
    with pytest.raises(ValueError, match="wal_dir"):
        _build({"enabled": True}, _fresh_fc(theta_fit))
    with pytest.raises(ValueError, match="history"):
        _build({"enabled": True, "wal_dir": str(tmp_path / "w"),
                "refit": {"enabled": True}}, _fresh_fc(theta_fit))
    # the store's device must be the forecaster's
    with pytest.raises(ValueError, match="device"):
        SeriesStateStore(_fresh_fc(theta_fit), device="meta")


# ---------------------------------------------------------------------------
# the WAL
# ---------------------------------------------------------------------------

def test_wal_roll_and_follower_cursor(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"), max_segment_bytes=256)
    recs = [{"k": [1, i], "d": 100 + i, "y": float(i)} for i in range(20)]
    for r in recs:
        wal.append([r])
    stats = wal.stats()
    assert stats["segments"] > 1 and stats["bytes"] > 256
    got, cursor = wal.read_new()
    assert got == recs
    again, cursor = wal.read_new(cursor)
    assert again == []
    wal.append([{"k": [1, 99], "d": 200, "y": 1.5}])
    tail, cursor = wal.read_new(cursor)
    assert tail == [{"k": [1, 99], "d": 200, "y": 1.5}]
    wal2 = WriteAheadLog(str(tmp_path / "wal"), max_segment_bytes=256)
    wal2.append([{"k": [2, 1], "d": 201, "y": 2.0}])
    assert wal2.stats()["segments"] == stats["segments"]


def test_wal_torn_line_and_garbage(tmp_path):
    from distributed_forecasting_tpu_torch.monitoring.store import (
        segment_path,
    )

    wal = WriteAheadLog(str(tmp_path / "wal"))
    wal.append([{"k": [1, 1], "d": 100, "y": 1.0}])
    seg = segment_path(wal.directory, 0)
    with open(seg, "a") as fh:
        fh.write('{"k":[1,2],"d":10')
    got, cursor = wal.read_new()
    assert got == [{"k": [1, 1], "d": 100, "y": 1.0}]
    with open(seg, "a") as fh:
        fh.write('1,"y":2.0}\n')
    got, cursor = wal.read_new(cursor)
    assert got == [{"k": [1, 2], "d": 101, "y": 2.0}]
    with open(seg, "a") as fh:
        fh.write("not json at all\n")
    wal.append([{"k": [1, 3], "d": 102, "y": 3.0}])
    got, cursor = wal.read_new(cursor)
    assert got == [{"k": [1, 3], "d": 102, "y": 3.0}]
    # a new writer over a torn tail seals it first: its own line survives
    with open(seg, "a") as fh:
        fh.write('{"k":[1,4],"d":10')
    WriteAheadLog(wal.directory).append([{"k": [1, 5], "d": 104, "y": 5.0}])
    got, _ = wal.read_new(cursor)
    assert got == [{"k": [1, 5], "d": 104, "y": 5.0}]


def test_wal_append_failure_keeps_cursor_on_durable_bytes(tmp_path,
                                                          monkeypatch):
    """ENOSPC simulated by an ``os.write`` that raises: the segment cursor
    stays on the bytes that reached the file."""
    wal = WriteAheadLog(str(tmp_path / "wal"), max_segment_bytes=4096)
    wal.append([{"k": [1, 1], "d": 100, "y": 1.0}])
    seg = os.path.join(wal.directory, os.listdir(wal.directory)[0])
    before = wal._seg_bytes
    assert before == os.path.getsize(seg)
    real_write = os.write

    def enospc(fd, b):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(os, "write", enospc)
    with pytest.raises(OSError):
        wal.append([{"k": [1, 2], "d": 101, "y": 2.0}])
    assert wal._seg_bytes == before
    monkeypatch.setattr(os, "write", real_write)
    wal.append([{"k": [1, 3], "d": 102, "y": 3.0}])
    got, _ = wal.read_new()
    assert [r["d"] for r in got] == [100, 102]
    assert wal._seg_bytes == os.path.getsize(seg)


def test_wal_bytes_equal_the_references(tmp_path, theta_fit):
    """The same submits (every record shape, some malformed, a roll) write
    the same segment files byte for byte, and each package replays the
    other's directory to the same routed counts."""
    fc, jfc = _fresh_fc(theta_fit), _ref_fc(theta_fit)
    conf = {**INTERVAL, "max_segment_bytes": 1024}
    rt = _build({**conf, "wal_dir": str(tmp_path / "port")}, fc)
    jrt = jingest.build_ingest_runtime(
        {**conf, "wal_dir": str(tmp_path / "ref")}, jfc)
    day1 = int(fc.day1)
    key = dict(zip(fc.key_names, map(int, fc.keys[1])))
    batches = []
    for i in range(12):
        batches.append([
            {"k": [int(v) for v in row], "d": day1 + 1 + i % 3,
             "y": 10.0 + i * 0.1 + j}
            for j, row in enumerate(fc.keys.tolist())])
    batches.append([{**key, "d": day1 + 2, "y": 1.0 / 3.0},
                    {"keys": key, "ds": "2013-05-02", "y": 7},
                    {**key, "d": day1, "y": 2.5},       # late
                    {"store": 9, "item": 9, "d": day1, "y": 1.0},
                    {**key, "d": day1 + 10**6, "y": 1.0}])
    for b in batches:
        assert rt.submit(b) == jrt.submit(b)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) > 1
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    # cross replay: each package follows the other's directory
    fc2, jfc2 = _fresh_fc(theta_fit), _ref_fc(theta_fit)
    follow = _build({**INTERVAL, "wal_dir": str(tmp_path / "ref")}, fc2)
    jfollow = jingest.build_ingest_runtime(
        {**INTERVAL, "wal_dir": str(tmp_path / "port")}, jfc2)
    got, want = follow.poll_apply(), jfollow.poll_apply()
    assert got == want == rt.poll_apply() == jrt.poll_apply()
    assert got["late"] == 1 and got["days"] == 3


# ---------------------------------------------------------------------------
# the state store
# ---------------------------------------------------------------------------

def test_state_store_requires_streaming_family():
    fake = types.SimpleNamespace(model="prophet")
    with pytest.raises(ValueError, match="holt_winters, theta, and croston"):
        SeriesStateStore(fake)


def test_state_store_routes_late_and_rejected(theta_fit):
    fc = _fresh_fc(theta_fit)
    y, mask = _history(theta_fit)
    store = _store(fc, time_bucket=16, history_y=y, history_mask=mask)
    day1 = store.day_cur
    points = [(0, day1 + 1, 5.0), (1, day1, 6.0), (0, store.day0 - 10, 7.0),
              (0, day1 + 10**6, 8.0)]
    routed = store.ingest(points)
    assert routed == {"accepted": 1, "late": 1, "rejected": 2}
    jstore = jingest.SeriesStateStore(
        _ref_fc(theta_fit), time_bucket=16, history_y=y, history_mask=mask)
    assert jstore.ingest(points) == routed
    st = store.stats()
    assert st["pending_points"] == 1 and st["late_points"] == 1
    assert store._y[1, day1 - store.day0] == 6.0
    assert store._mask[1, day1 - store.day0] == 1.0
    store.ingest([(0, day1 + 1, 9.0)])
    assert store.stats()["pending_points"] == 1
    assert store.apply_pending() == {"days": 1, "points": 1}
    assert store.day_cur == day1 + 1 and fc.day1 == day1 + 1
    assert store.apply_pending() == {"days": 0, "points": 0}


def test_gap_days_are_masked_columns(theta_fit):
    fc = _fresh_fc(theta_fit)
    store = _store(fc, time_bucket=16)
    day1 = store.day_cur
    store.ingest([(2, day1 + 3, 42.0)])
    assert store.apply_pending() == {"days": 3, "points": 1}
    assert store.day_cur == day1 + 3 and fc.day1 == day1 + 3


def test_far_future_points_capped_by_horizon(theta_fit):
    fc = _fresh_fc(theta_fit)
    store = _store(fc, time_bucket=16, max_pending_days=30)
    day1 = store.day_cur
    assert store.ingest([(0, day1 + 31, 1.0)]) == {
        "accepted": 0, "late": 0, "rejected": 1}
    assert store.stats()["pending_points"] == 0
    assert store.ingest([(0, day1 + 30, 1.0)])["accepted"] == 1
    with store._lock:
        store._pending.clear()
        store._pending[day1 + 10**6] = {0: 9.0}
    assert store.apply_pending() == {"days": 0, "points": 0}
    assert store.day_cur == day1
    store.ingest([(0, day1 + 1, 5.0)])
    with store._lock:
        store._pending[day1 + 10**6] = {0: 9.0}
    assert store.apply_pending() == {"days": 1, "points": 1}
    assert store.day_cur == day1 + 1


def test_bucket_boundary_growth_bitwise_vs_refit():
    """Streaming across a time-bucket boundary grows the fitted and history
    buffers and stays bitwise a pinned-grid fit of the extended series."""
    df = jdata.synthetic_store_item_sales(n_stores=1, n_items=3, n_days=70,
                                          seed=7)
    batch = tensorize(df, device="cpu")
    fns = get_model("holt_winters")
    cfg = fns.config_cls(n_alpha=1, n_beta=1, n_gamma=1, damped=False,
                         filter="scan")
    params = fns.fit(batch.y, batch.mask, batch.day, cfg)
    fc = BatchForecaster.from_fit(batch, params, "holt_winters", cfg)
    bucket, t0 = 8, batch.n_time
    store = _store(fc, time_bucket=bucket, history_y=batch.y.numpy(),
                   history_mask=batch.mask.numpy())
    cap0 = time_cap(t0, bucket)
    assert store._params.fitted.shape[1] == cap0
    k = (cap0 - t0) + 3
    day1 = store.day_cur
    S = batch.y.shape[0]
    rng = np.random.default_rng(8)
    y_new = (50 + rng.normal(0, 2, (S, k))).astype(np.float32)
    store.ingest([(s, day1 + 1 + j, float(y_new[s, j]))
                  for s in range(S) for j in range(k)])
    assert store.apply_pending()["days"] == k
    cap1 = time_cap(t0 + k, bucket)
    assert cap1 > cap0
    assert store._params.fitted.shape[1] == cap1
    assert store._y.shape[1] == cap1
    day_ext = torch.cat([batch.day, torch.arange(
        day1 + 1, day1 + 1 + k, dtype=batch.day.dtype)])
    y_ext = torch.cat([batch.y, torch.from_numpy(y_new)], 1)
    m_ext = torch.cat([batch.mask, torch.ones(S, k)], 1)
    ref = fns.fit(y_ext, m_ext, day_ext, cfg)
    got = store._params
    for name in ("level", "trend", "season"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert torch.equal(got.fitted[:, :t0 + k], ref.fitted)
    assert not torch.any(got.fitted[:, t0 + k:])
    req = pd.DataFrame(fc.keys[:1], columns=list(fc.key_names))
    pred = fc.predict(req, horizon=5)
    epoch = pd.Timestamp("1970-01-01")
    assert pred.ds.min() == epoch + pd.Timedelta(days=int(fc.day1) + 1)
    assert np.isfinite(pred.yhat).all()


def test_predict_time_bucket_byte_equal():
    """``time_bucket`` 32 pads the grid and trims the padded rows: every
    body is byte-equal to the exact grid's, for each streamed family, with
    and without history, for predict and predict_quantiles."""
    df = jdata.synthetic_store_item_sales(n_stores=2, n_items=3, n_days=90,
                                          seed=3)
    batch = tensorize(df, device="cpu")
    req = pd.DataFrame(batch.keys[[4, 1]], columns=list(batch.key_names))
    for model in ("holt_winters", "theta", "croston"):
        fns = get_model(model)
        cfg = fns.config_cls()
        params = fns.fit(batch.y, batch.mask, batch.day, cfg)
        exact = BatchForecaster.from_fit(batch, params, model, cfg)
        padded = BatchForecaster.from_fit(batch, params, model, cfg)
        padded.time_bucket = 32
        for hist in (False, True):
            a = exact.predict(req, horizon=20, include_history=hist)
            b = padded.predict(req, horizon=20, include_history=hist)
            assert tserver._encode_predictions(a, batch.key_names) == \
                tserver._encode_predictions(b, batch.key_names), model
        a = exact.predict_quantiles(req, horizon=9)
        b = padded.predict_quantiles(req, horizon=9)
        pd.testing.assert_frame_equal(a, b, check_exact=True)


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

def test_runtime_parses_every_record_shape(tmp_path, theta_fit):
    fc = _fresh_fc(theta_fit)
    rt = _build({**INTERVAL, "wal_dir": str(tmp_path / "wal")}, fc)
    day = int(fc.day1) + 1
    ds = (pd.Timestamp("1970-01-01")
          + pd.Timedelta(days=day)).strftime("%Y-%m-%d")
    key = dict(zip(fc.key_names, map(int, fc.keys[0])))
    good = [{**key, "d": day, "y": 1.0}, {"keys": key, "d": day, "y": 2.0},
            {"k": [int(v) for v in fc.keys[0]], "d": day, "y": 3.0},
            {**key, "ds": ds, "y": 4.0}]
    assert rt.submit(good) == {"written": 4, "unknown_series": 0,
                               "malformed": 0, "out_of_range": 0}
    bad = rt.submit([
        {"store": 999, "item": 999, "d": day, "y": 1.0},
        {**key, "d": day},
        {**key, "d": day, "y": float("nan")},
        {"k": [1], "d": day, "y": 1.0},
        {"y": 1.0},
        {**key, "d": day + 10**6, "y": 1.0},
        {**key, "ds": "2200-01-01", "y": 1.0},
        {**key, "d": -10**6, "y": 1.0},
    ])
    assert bad == {"written": 0, "unknown_series": 1, "malformed": 4,
                   "out_of_range": 3}
    replayed, _ = rt.wal.read_new()
    assert len(replayed) == 4
    assert all(abs(r["d"] - day) <= 1 for r in replayed)
    with pytest.raises(ValueError, match="max_points_per_request"):
        rt.submit([good[0]] * 10001)


def test_sync_submit_freshens_forecast(tmp_path, theta_fit):
    fc = _fresh_fc(theta_fit)
    rt = _build({"enabled": True, "wal_dir": str(tmp_path / "wal"),
                 "apply_mode": "sync", "time_bucket": 16}, fc)
    req = pd.DataFrame(fc.keys[:1], columns=list(fc.key_names))
    before = fc.predict(req, horizon=7)
    day1 = int(fc.day1)
    gen = fc.state_generation()
    key = dict(zip(fc.key_names, map(int, fc.keys[0])))
    out = rt.submit([{**key, "d": day1 + 1, "y": 500.0}])
    assert out == {"written": 1, "unknown_series": 0, "malformed": 0,
                   "out_of_range": 0,
                   "applied": {"accepted": 1, "late": 0, "rejected": 0,
                               "days": 1, "points": 1}}
    after = fc.predict(req, horizon=7)
    assert int(fc.day1) == day1 + 1 and fc.state_generation() == gen + 1
    assert after.ds.min() > before.ds.min()
    assert not np.allclose(before.yhat.to_numpy()[1:],
                           after.yhat.to_numpy()[:-1])
    snap = rt.snapshot()
    assert snap["apply_mode"] == "sync"
    assert snap["store"]["day_cur"] == day1 + 1
    text = rt.render_metrics()
    assert "dftpu_ingest_points_total 1" in text
    assert f"dftpu_ingest_applied_day {day1 + 1}\n" in text


def test_streamed_state_matches_the_reference(tmp_path, theta_fit):
    """Day-by-day posts then a burst with a gap, through both packages'
    sync runtimes from the reference's fit: the same acks, the same
    frontier, theta states within 2.4e-6 of scale."""
    fc, jfc = _fresh_fc(theta_fit), _ref_fc(theta_fit)
    conf = {"enabled": True, "apply_mode": "sync", "time_bucket": 16}
    rt = _build({**conf, "wal_dir": str(tmp_path / "p")}, fc)
    jrt = jingest.build_ingest_runtime({**conf, "wal_dir": str(tmp_path / "r")},
                                       jfc)
    rng = np.random.default_rng(21)
    day1 = int(fc.day1)
    keys = [[int(v) for v in row] for row in fc.keys.tolist()]
    days = list(range(day1 + 1, day1 + 6)) + [day1 + 9]
    for i, d in enumerate(days):
        pts = [{"k": k, "d": d + j, "y": float(rng.gamma(5.0, 10.0))}
               for k in keys for j in range(1 + 3 * (i == len(days) - 1))]
        assert rt.submit(pts) == jrt.submit(pts)
    assert int(fc.day1) == int(jfc.day1) == day1 + 12
    _assert_theta_close(rt.store._params, jrt.store._params)


def test_two_followers_converge_through_shared_wal(tmp_path, theta_fit):
    wal_dir = str(tmp_path / "shared_wal")
    fc_a, fc_b = _fresh_fc(theta_fit), _fresh_fc(theta_fit)
    conf = {**INTERVAL, "wal_dir": wal_dir}
    rt_a, rt_b = _build(conf, fc_a), _build(conf, fc_b)
    day1 = int(fc_a.day1)
    points = [{"k": [int(v) for v in row], "d": day1 + 1 + (i % 2),
               "y": 100.0 + i} for i, row in enumerate(fc_a.keys.tolist())]
    out = rt_a.submit(points)
    assert out["written"] == len(points) and "applied" not in out
    assert int(fc_a.day1) == day1
    assert rt_a.poll_apply()["days"] == rt_b.poll_apply()["days"] == 2
    assert int(fc_a.day1) == int(fc_b.day1) == day1 + 2
    for f in dataclasses.fields(fc_a.params):
        assert torch.equal(getattr(fc_a.params, f.name),
                           getattr(fc_b.params, f.name)), f.name
    req = pd.DataFrame(fc_a.keys, columns=list(fc_a.key_names))
    np.testing.assert_array_equal(fc_a.predict(req, horizon=7).yhat,
                                  fc_b.predict(req, horizon=7).yhat)
    # a reference follower of the same directory lands on the same state
    jfc = _ref_fc(theta_fit)
    jrt = jingest.build_ingest_runtime(conf, jfc)
    assert jrt.poll_apply()["days"] == 2
    _assert_theta_close(fc_a.params, jfc.params)


def test_interval_follower_thread_applies(tmp_path, theta_fit):
    fc = _fresh_fc(theta_fit)
    rt = _build({**INTERVAL, "wal_dir": str(tmp_path / "w"),
                 "apply_interval_ms": 10}, fc)
    rt.start()
    try:
        day1 = int(fc.day1)
        rt.submit([{"k": [int(v) for v in fc.keys[0]], "d": day1 + 1,
                    "y": 3.0}])
        deadline = time.monotonic() + 30
        while int(fc.day1) != day1 + 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert int(fc.day1) == day1 + 1
    finally:
        rt.stop()
    assert rt._thread is None


def test_stream_scoring_runs_before_the_apply(tmp_path, theta_fit):
    """With an anomaly scorer bound, a batch is scored against the bands
    as they stood before it applied (a point must not vouch for itself),
    and a scoring failure does not fail the ingest."""
    fc = _fresh_fc(theta_fit)
    rt = _build({"enabled": True, "wal_dir": str(tmp_path / "w"),
                 "apply_mode": "sync"}, fc)
    seen = []

    class Scorer:
        def score_ingest(self, rows):
            seen.append((rows, int(fc.day1)))
            return {"scored": len(rows)}

    rt.anomaly = Scorer()
    day1 = int(fc.day1)
    rows = [{"k": [int(v) for v in fc.keys[0]], "d": day1 + 1, "y": 9.0}]
    out = rt.submit(rows)
    assert out["anomalies"] == {"scored": 1}
    assert seen == [(rows, day1)] and int(fc.day1) == day1 + 1

    class Broken:
        def score_ingest(self, rows):
            raise RuntimeError("scorer down")

    rt.anomaly = Broken()
    out = rt.submit([{**rows[0], "d": day1 + 2}])
    assert "anomalies" not in out and out["applied"]["points"] == 1


# ---------------------------------------------------------------------------
# the executor's submit path and the refit scheduler
# ---------------------------------------------------------------------------

def test_executor_keeps_completion_order_and_surfaces_errors():
    done = []
    gate = threading.Event()
    ex = TrainingExecutor(PipelineConfig(max_in_flight=3))

    def complete(i):
        if i == 0:
            gate.wait(10)  # the first completion is the slowest
        done.append(i)
        return i * 10

    handles = [ex.submit(f"e{i}", lambda i=i: i, lambda p: p, complete)
               for i in range(3)]
    gate.set()
    assert [h.result(timeout=30) for h in handles] == [0, 10, 20]
    assert done == [0, 1, 2]

    def boom(state):
        raise KeyError("complete failed")

    bad = ex.submit("bad", lambda: 0, lambda p: p, boom)
    with pytest.raises(KeyError):
        bad.result(timeout=30)
    with pytest.raises(KeyError):
        ex.flush()
    with pytest.raises(KeyError):
        ex.submit("after", lambda: 0, lambda p: p, lambda s: s)
    with pytest.raises(KeyError):
        ex.close()
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit("closed", lambda: 0, lambda p: p, lambda s: s)
    # serial mode: every stage inline, the error raised to the caller
    serial = TrainingExecutor(PipelineConfig(async_tracking=False))
    assert serial.submit("s", lambda: 2, lambda p: p + 1,
                         lambda s: s * 2).result(timeout=0) == 6
    with pytest.raises(KeyError):
        serial.submit("s2", lambda: 0, lambda p: p, boom)
    with pytest.raises(KeyError):
        serial.close()


def _apply_one(store, y=77.0):
    day1 = store.day_cur
    store.ingest([(0, day1 + 1, y)])
    store.apply_pending()


def test_refit_triggers(theta_fit):
    fc = _fresh_fc(theta_fit)
    y, mask = _history(theta_fit)
    store = _store(fc, time_bucket=16, history_y=y, history_mask=mask)
    sched = RefitScheduler(store, RefitConfig(
        enabled=True, max_applied_points=1, max_staleness_s=1e9,
        check_interval_s=60, drift_coverage_tol=0))
    try:
        assert sched.due() == ""
        _apply_one(store)
        assert sched.due() == "backlog"
    finally:
        sched.stop()
    sched = RefitScheduler(store, RefitConfig(
        enabled=True, max_applied_points=10**9, max_staleness_s=1e-6,
        check_interval_s=60, drift_coverage_tol=0))
    try:
        assert sched.due() == "staleness"
    finally:
        sched.stop()
    drifted = types.SimpleNamespace(monitor=types.SimpleNamespace(
        coverage=lambda: 0.5, nominal_coverage=0.95))
    fresh = types.SimpleNamespace(monitor=types.SimpleNamespace(
        coverage=lambda: float("nan"), nominal_coverage=0.95))
    cfg = RefitConfig(enabled=True, max_applied_points=10**9,
                      max_staleness_s=1e9, check_interval_s=60,
                      drift_coverage_tol=0.15)
    for quality, want in ((drifted, "coverage_drift"), (fresh, "")):
        sched = RefitScheduler(store, cfg, quality=quality)
        try:
            assert sched.due() == want
        finally:
            sched.stop()


def test_forced_refit_swaps_and_resets_backlog(theta_fit):
    fc = _fresh_fc(theta_fit)
    y, mask = _history(theta_fit)
    store = _store(fc, time_bucket=16, history_y=y, history_mask=mask)
    _apply_one(store, y=300.0)
    day_after = int(fc.day1)
    assert store.stats()["applied_since_refit"] == 1
    sched = RefitScheduler(store, RefitConfig(
        enabled=True, max_applied_points=10**9, max_staleness_s=1e9,
        check_interval_s=60))
    try:
        assert sched.maybe_refit(force=True) == "forced"
        sched.wait(timeout=300)
        snap = sched.snapshot()
        assert snap["refits_done"] == 1 and snap["last_trigger"] == "forced"
        assert sched.wait(timeout=1) is None
        assert sched._reap() is None
        assert sched.snapshot()["refits_done"] == 1
    finally:
        sched.stop()
    assert store.stats()["applied_since_refit"] == 0
    assert store.day_cur == day_after
    assert store._y[0, day_after - store.day0] == 300.0
    req = pd.DataFrame(fc.keys[:1], columns=list(fc.key_names))
    assert np.isfinite(fc.predict(req, horizon=5).yhat).all()


def test_refit_with_replay_matches_the_reference(theta_fit):
    """A refit whose fit ran while 4 more days applied: the install replays
    them, so the state is fit-then-update bitwise within the port and the
    reference's within the scale tolerance."""
    y, mask = _history(theta_fit)
    fc, jfc = _fresh_fc(theta_fit), _ref_fc(theta_fit)
    store = _store(fc, time_bucket=16, history_y=y, history_mask=mask)
    jstore = jingest.SeriesStateStore(jfc, time_bucket=16, history_y=y,
                                      history_mask=mask)
    rng = np.random.default_rng(5)
    S = store.n_series

    def stream(days):
        for _ in range(days):
            d = store.day_cur + 1
            pts = [(s, d, float(rng.gamma(5.0, 10.0))) for s in range(S)]
            for st in (store, jstore):
                st.ingest(pts)
                st.apply_pending()

    stream(3)
    stages = [st.refit_stages() for st in (store, jstore)]
    prepared = [prep() for prep, _, _ in stages]
    stream(4)  # applied while the fit runs
    for (prep, dispatch, complete), p in zip(stages, prepared):
        complete(dispatch(p))
    assert int(fc.day1) == int(jfc.day1) == store.day0 + y.shape[1] + 6
    _assert_theta_close(store._params, jstore._params)
    # within the port: the install equals the fit of the snapshot, then
    # the update of the replayed columns
    fns = get_model("theta")
    t_snap = prepared[0]["day_snap"] - store.day0 + 1
    yt = torch.from_numpy(store._y[:, :t_snap].copy())
    mt = torch.from_numpy(store._mask[:, :t_snap].copy())
    p0 = fns.fit(yt, mt, torch.arange(store.day0, store.day0 + t_snap,
                                      dtype=torch.int32), store.config)
    aux = fns.init_update_aux(p0, y=yt, mask=mt)
    p1, _, _ = fns.update_state(
        p0, aux, torch.from_numpy(store._y[:, t_snap:t_snap + 4].copy()),
        torch.from_numpy(store._mask[:, t_snap:t_snap + 4].copy()),
        np.ones(4), np.arange(prepared[0]["day_snap"] + 1,
                              prepared[0]["day_snap"] + 5), fns.config_cls())
    for name in ("level", "sigma", "alpha", "intercept", "slope", "seas"):
        assert torch.equal(getattr(store._params, name),
                           getattr(p1, name)), name


def test_refit_without_history_raises(theta_fit):
    store = _store(_fresh_fc(theta_fit), time_bucket=16)
    assert not store.can_refit
    with pytest.raises(ValueError, match="history"):
        store.refit_stages()


# ---------------------------------------------------------------------------
# the HTTP surface
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ingest_servers(tmp_path_factory, theta_fit):
    """The port's server and the reference's, each with a sync ingest
    runtime over the reference's fit."""
    conf = {"enabled": True, "apply_mode": "sync", "time_bucket": 16}
    fc, jfc = _fresh_fc(theta_fit), _ref_fc(theta_fit)
    port = tserver.start_server(fc, model_version="9", ingest=_build(
        {**conf, "wal_dir": str(tmp_path_factory.mktemp("p"))}, fc))
    ref = jserver.start_server(jfc, model_version="9",
                               ingest=jingest.build_ingest_runtime(
        {**conf, "wal_dir": str(tmp_path_factory.mktemp("r"))}, jfc))
    yield port, ref, fc
    port.shutdown()
    ref.shutdown()


def _raw(srv, path, payload=None):
    url = f"http://127.0.0.1:{srv.server_address[1]}{path}"
    data = None
    if payload is not None:
        data = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_post_ingest_freshens_invocations(ingest_servers):
    srv, ref, fc = ingest_servers
    key = dict(zip(fc.key_names, map(int, fc.keys[0])))
    day1 = int(fc.day1)
    _, before = _raw(srv, "/invocations", {"inputs": [key], "horizon": 7})
    body = {"points": [{**key, "d": day1 + 1, "y": 450.0}]}
    code, out = _raw(srv, "/ingest", body)
    assert (code, out) == _raw(ref, "/ingest", body)
    out = json.loads(out)
    assert code == 200 and out["written"] == 1
    assert out["applied"]["days"] == 1 and out["applied"]["points"] == 1
    _, after = _raw(srv, "/invocations", {"inputs": [key], "horizon": 7})
    ds_b = pd.to_datetime(pd.DataFrame(json.loads(before)["predictions"]).ds)
    ds_a = pd.to_datetime(pd.DataFrame(json.loads(after)["predictions"]).ds)
    assert ds_a.min() == ds_b.min() + pd.Timedelta(days=1)
    # /debug/* stays dark: tracing and its debug endpoints are P11
    assert _raw(srv, "/debug/ingest")[0] == 404


def test_ingest_metrics_on_metrics_endpoint(ingest_servers):
    srv, ref, _ = ingest_servers
    text = _raw(srv, "/metrics")[1].decode()
    assert "# TYPE dftpu_ingest_points_total counter" in text
    assert "dftpu_ingest_applied_day" in text
    assert "dftpu_ingest_wal_bytes" in text

    def families(t):
        return [ln for ln in t.splitlines()
                if ln.startswith(("# HELP dftpu_ingest", "# TYPE dftpu_ingest",
                                  "# HELP dftpu_refit", "# TYPE dftpu_refit"))]

    assert families(text) == families(_raw(ref, "/metrics")[1].decode())
    assert families(IngestMetrics().registry.render_prometheus()) == \
        families(text)


def test_ingest_http_errors(ingest_servers):
    srv, ref, fc = ingest_servers
    day = int(fc.day1) + 1
    key = dict(zip(fc.key_names, map(int, fc.keys[0])))
    for bad in ({}, {"points": []}, {"points": "nope"}, ["not a dict"],
                b"{oops", {"points": [{**key, "d": day, "y": 1.0}] * 10001}):
        got, want = _raw(srv, "/ingest", bad), _raw(ref, "/ingest", bad)
        assert got == want and got[0] == 400, bad
    unknown = {"points": [{"store": 999, "item": 999, "d": day, "y": 1.0}]}
    code, out = _raw(srv, "/ingest", unknown)
    assert (code, out) == _raw(ref, "/ingest", unknown)
    assert json.loads(out) == {"written": 0, "unknown_series": 1,
                               "malformed": 0, "out_of_range": 0}


def test_ingest_503_when_not_configured(theta_fit):
    srv = tserver.start_server(_fresh_fc(theta_fit), model_version="9")
    ref = jserver.start_server(_ref_fc(theta_fit), model_version="9")
    try:
        got = _raw(srv, "/ingest", {"points": [{"y": 1.0}]})
        assert got == _raw(ref, "/ingest", {"points": [{"y": 1.0}]})
        assert got[0] == 503
        assert "serving.ingest" in json.loads(got[1])["error"]
        assert _raw(srv, "/debug/ingest")[0] == 404
    finally:
        srv.shutdown()
        ref.shutdown()


def test_observe_feeds_ingest(tmp_path, theta_fit):
    from distributed_forecasting_tpu_torch.monitoring.quality import (
        build_quality_runtime,
    )

    fc = _fresh_fc(theta_fit)
    quality = build_quality_runtime({"quality": {"enabled": True}}, fc)
    ingest = _build({"enabled": True, "wal_dir": str(tmp_path / "wal"),
                     "apply_mode": "sync", "time_bucket": 16,
                     "observe_feeds_ingest": True}, fc)
    srv = tserver.start_server(fc, model_version="9", quality=quality,
                               ingest=ingest)
    try:
        day1 = int(fc.day1)
        ds = (pd.Timestamp("1970-01-01")
              + pd.Timedelta(days=day1 + 1)).strftime("%Y-%m-%d")
        obs = [{**dict(zip(fc.key_names, map(int, row))), "ds": ds,
                "y": 60.0} for row in fc.keys]
        code, summary = _raw(srv, "/observe", {"observations": obs})
        summary = json.loads(summary)
        assert code == 200
        assert summary["ingest"]["written"] == len(obs)
        assert summary["ingest"]["applied"]["points"] == len(obs)
        assert int(fc.day1) == day1 + 1
    finally:
        srv.shutdown()
