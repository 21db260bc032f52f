"""The port's materialized forecast cache (``serving/forecast_cache.py``)
against the reference's, case by case as the reference's
``tests/unit/test_forecast_cache.py`` holds its own.

The reference fits each family on the same seeded sales (2 stores x 2
items), writes the artifact, and both packages load it, so both caches
serve the same parameters:

* cached frames match the reference's cached frames: keys and ``ds``
  equal, values within the tolerance of the family's predict parity test
  (:data:`TOL`: rtol, and atol as a fraction of the data's largest
  magnitude); each cached read is byte-equal (``to_csv``) to the port's
  own dispatch, at every request-size bucket of 4 series;
* counters (hits, misses by reason, invalidations, rebuilds, evictions),
  entry bytes and the eviction order equal the reference's at each step
  of one script;
* no stale read after an ingest apply, a full refit or a windowed tail
  refit; an overtaken rebuild is discarded;
* persisted frames have the reference's file names and meta keys; they
  are adopted at boot, discarded when torn or from other state, and a
  ``cache.persist`` failure keeps memory serving;
* composites and Monte-Carlo forecasters serve uncached; the fleet
  max-merges the entry age; the server's bodies with the cache on are
  byte-equal to the same server's with it off.

Pinned differences: the state fingerprint starts with a tag naming the
port, so a frame the reference persisted (its own rounding) is not adopted
by the port, and the other way round; a forecaster with Monte-Carlo
intervals is served uncached by the port and cached by the reference.
"""

import dataclasses
import http.client
import json
import os
import shutil
import threading

import numpy as np
import pandas as pd
import pytest
import torch

import distributed_forecasting_tpu.data as jdata
from distributed_forecasting_tpu.engine import fit_forecast as jfit_forecast
from distributed_forecasting_tpu.models.base import get_model as jget_model
from distributed_forecasting_tpu.serving import fleet as jfleet
from distributed_forecasting_tpu.serving import forecast_cache as jcache
from distributed_forecasting_tpu.serving import predictor as jpred
from distributed_forecasting_tpu_torch.monitoring import failpoints as fp
from distributed_forecasting_tpu_torch.serving import fleet as tfleet
from distributed_forecasting_tpu_torch.serving import forecast_cache as tcache
from distributed_forecasting_tpu_torch.serving import predictor as tpred
from distributed_forecasting_tpu_torch.serving import server as tserver

torch.set_num_threads(1)

#: (rtol, atol over the data's largest magnitude) of each family's predict
#: parity test: test_torch_theta.py, test_torch_croston.py,
#: test_torch_arima.py, test_torch_predictor.py (Holt-Winters) and
#: test_torch_prophet.py (the curve models' point path)
TOL = {
    "theta": (1e-5, 1e-5),
    "croston": (1e-5, 1e-6),
    "arima": (0.0, 1e-3),
    "holt_winters": (1e-5, 1e-5),
    "prophet": (1e-5, 1e-5),
    "curve": (1e-5, 1e-5),
    "prophet_ar": (1e-5, 1e-5),
}

QSET = (0.1, 0.5, 0.9)


def _fit_reference(family, n_days=60, seed=7, horizon=7):
    df = jdata.synthetic_store_item_sales(n_stores=2, n_items=2,
                                          n_days=n_days, seed=seed)
    batch = jdata.tensorize(df)
    cfg = jget_model(family).config_cls()
    params, _ = jfit_forecast(batch, model=family, config=cfg,
                              horizon=horizon)
    return batch, jpred.BatchForecaster.from_fit(batch, params, family, cfg)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Lazily fitted reference artifacts by family: (path, data scale)."""
    root = tmp_path_factory.mktemp("cache_artifacts")
    made = {}

    def get(family):
        if family not in made:
            batch, fc = _fit_reference(family)
            path = str(root / family)
            fc.save(path)
            made[family] = (path, float(np.abs(np.asarray(batch.y)).max()))
        return made[family]

    return get


@pytest.fixture(scope="module")
def theta_art(tmp_path_factory):
    """The reference's theta fit of its cache tests (120 days, seed 13),
    its artifact and history: (path, y, mask)."""
    batch, fc = _fit_reference("theta", n_days=120, seed=13, horizon=14)
    path = str(tmp_path_factory.mktemp("theta_art"))
    fc.save(path)
    return path, np.asarray(batch.y), np.asarray(batch.mask)


def _pair(path):
    """(reference forecaster, port forecaster) over one artifact."""
    return (jpred.BatchForecaster.load(path),
            tpred.BatchForecaster.load(path, device="cpu"))


def _cache(mod, fc, **over):
    conf = {"enabled": True, "quantile_sets": [list(QSET)], **over}
    cache = mod.build_forecast_cache(conf, fc)
    assert cache is not None
    return cache


def _req(fc, rows=None):
    keys = fc.keys if rows is None else fc.keys[rows]
    return pd.DataFrame(keys, columns=list(fc.key_names))


def _read(cache, req, horizon=14, quantiles=None):
    return cache.lookup(req, horizon=horizon, include_history=False,
                        quantiles=quantiles, on_missing="raise", xreg=None)


def _assert_identical(cached, dispatched):
    """Byte-equality, not closeness: columns, dtypes, bits and CSV."""
    assert cached is not None
    assert list(cached.columns) == list(dispatched.columns)
    for col in dispatched.columns:
        assert cached[col].dtype == dispatched[col].dtype, col
        assert np.array_equal(cached[col].to_numpy(),
                              dispatched[col].to_numpy()), col
    assert cached.to_csv(index=False) == dispatched.to_csv(index=False)


def _assert_close(got, want, family, scale):
    """The port's frame against the reference's: keys and ds equal, values
    within the family's :data:`TOL`."""
    rtol, atol = TOL[family]
    assert list(got.columns) == list(want.columns)
    for col in ("ds", "store", "item"):
        pd.testing.assert_series_equal(got[col], want[col])
    for col in got.columns[3:]:
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(),
                                   rtol=rtol, atol=atol * scale,
                                   err_msg=f"{family} {col}")


# -- conf ---------------------------------------------------------------------

@pytest.mark.parametrize("conf", [
    None,
    {"enabled": True, "max_horizons": 2,
     "quantile_sets": [[0.9, 0.1, 0.5, 0.5]], "max_bytes": 1024},
    {"enabled": True, "mmap_dir": "/x", "max_horizons": None},
])
def test_cache_config_parses_like_the_reference(conf):
    got = tcache.CacheConfig.from_conf(conf)
    want = jcache.CacheConfig.from_conf(conf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if conf and conf.get("max_horizons") == 2:
        # canonicalized like the request path: sorted, deduped, 3 decimals
        assert got.quantile_sets == ((0.1, 0.5, 0.9),)


@pytest.mark.parametrize("conf, match", [
    ({"max_horizon": 4}, "serving.cache"),
    ({"max_horizons": 0}, "max_horizons"),
    ({"max_bytes": 0}, "max_bytes"),
    ({"quantile_sets": [[0.5, 1.5]]}, "quantile_sets"),
])
def test_cache_config_rejects_what_the_reference_rejects(conf, match):
    for mod in (tcache, jcache):
        with pytest.raises(ValueError, match=match):
            mod.CacheConfig.from_conf(conf)


def test_canonical_quantiles_match_the_reference():
    for qs in ([0.9, 0.1, 0.9], (0.5004,), [0.25, 0.2501, 0.7]):
        assert tcache.canonical_quantiles(qs) == jcache.canonical_quantiles(qs)
    assert tcache.canonical_quantiles([0.9, 0.1, 0.9]) == (0.1, 0.9)


# -- cached frames against the reference's, and against dispatch ------------

_FAMILIES = [
    "theta",
    "prophet",
    pytest.param("arima", marks=pytest.mark.slow),
    pytest.param("croston", marks=pytest.mark.slow),
    pytest.param("curve", marks=pytest.mark.slow),
    pytest.param("holt_winters", marks=pytest.mark.slow),
    pytest.param("prophet_ar", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("family", _FAMILIES)
def test_cached_frames_match_the_reference(artifacts, family):
    path, scale = artifacts(family)
    jfc, tfc = _pair(path)
    jc, tc = _cache(jcache, jfc), _cache(tcache, tfc)
    # the full set, a subset and a scrambled order
    for rows in (None, [1, 3], [3, 0, 2, 1]):
        got = _read(tc, _req(tfc, rows), horizon=7)
        _assert_identical(got, tfc.predict(_req(tfc, rows), horizon=7))
        _assert_close(got, _read(jc, _req(jfc, rows), horizon=7), family,
                      scale)
    # quantile frames take the same gather with more columns
    got = _read(tc, _req(tfc, [0, 2]), horizon=7, quantiles=[0.9, 0.1, 0.5])
    _assert_identical(got, tfc.predict_quantiles(
        _req(tfc, [0, 2]), quantiles=QSET, horizon=7))
    _assert_close(got, _read(jc, _req(jfc, [0, 2]), horizon=7,
                             quantiles=QSET), family, scale)
    # float32 values: entry bytes equal the reference's
    for sig in ((7, None), (7, QSET)):
        assert tc._entries[sig].values.dtype == np.float32
        assert tc._entries[sig].nbytes == jc._entries[sig].nbytes


@pytest.mark.parametrize("family", ["theta", "prophet"])
def test_cached_reads_are_byte_equal_to_dispatch_at_every_bucket(artifacts,
                                                                 family):
    """Every subset of 1, 2, 3 and 4 of the 4 series (the buckets the
    ladder reaches at S 4), forwards and reversed, point and quantile:
    the gather out of the full-S frame is the dispatch's bytes."""
    import itertools

    path, _ = artifacts(family)
    _, fc = _pair(path)
    cache = _cache(tcache, fc)
    buckets = set()
    for k in range(1, 5):
        for rows in itertools.combinations(range(4), k):
            for order in (list(rows), list(rows)[::-1]):
                req = _req(fc, order)
                buckets.add(fc._bucket(len(order)))
                _assert_identical(_read(cache, req, horizon=7),
                                  fc.predict(req, horizon=7))
                _assert_identical(
                    _read(cache, req, horizon=7, quantiles=QSET),
                    fc.predict_quantiles(req, quantiles=QSET, horizon=7))
    assert buckets == {1, 2, 3, 4}
    assert cache.metrics.rebuilds.value == 2


# -- counters, admission, unknown series --------------------------------------

def _counts(cache):
    m = cache.metrics
    return {
        "hits": m.hits.value,
        "misses": {r: m.misses.value(reason=r) for r in (
            "cold", "stale", "rebuilding", "bypass", "horizon_cap")},
        "invalidations": m.invalidations.value,
        "rebuilds": m.rebuilds.value,
        "evictions": m.evictions.value,
        "entries": sorted(((sig, e.nbytes) for sig, e in
                           cache._entries.items()), key=repr),
        "bytes": cache._bytes,
    }


def test_counters_and_evictions_match_the_reference_step_by_step(theta_art):
    path, _, _ = theta_art
    jfc, tfc = _pair(path)
    jc = _cache(jcache, jfc, max_horizons=2)
    tc = _cache(tcache, tfc, max_horizons=2)

    def steps(cache, fc):
        def budget():
            # room for two h14 frames: the next admit evicts the oldest
            one = cache._entries[(14, None)].nbytes
            object.__setattr__(cache.config, "max_bytes", int(one * 2.5))

        return [
            lambda: _read(cache, _req(fc, [0])),            # cold, rebuilt
            lambda: _read(cache, _req(fc, [0, 2])),         # hit
            lambda: _read(cache, _req(fc, [1]), quantiles=[0.9, 0.1, 0.5]),
            lambda: _read(cache, _req(fc, [1]), quantiles=[0.25]),  # bypass
            lambda: cache.lookup(_req(fc), 14, True, None, "raise", None),
            lambda: cache.lookup(_req(fc), 14, False, None, "raise",
                                 object()),                 # xreg: bypass
            lambda: _read(cache, _req(fc, [3]), horizon=30),
            lambda: _read(cache, _req(fc, [3]), horizon=45),  # horizon cap
            lambda: fc.swap_state(day1=fc.day1),   # 3 invalidated, rebuilt
            lambda: _read(cache, _req(fc, [2, 1])),
            budget,
            lambda: fc.swap_state(day1=fc.day1),   # rebuilds evict
            lambda: _read(cache, _req(fc, [0]), horizon=30),
        ]

    for i, (j, t) in enumerate(zip(steps(jc, jfc), steps(tc, tfc))):
        j(), t()
        assert _counts(tc) == _counts(jc), f"step {i}"
    assert tc.metrics.evictions.value >= 1
    assert tc._bytes <= tc.config.max_bytes
    assert tc.describe() == jc.describe()


def test_inadmissible_requests_fall_through(theta_art):
    _, fc = _pair(theta_art[0])
    cache = _cache(tcache, fc, max_horizons=1)
    req = _req(fc, [0])
    assert _read(cache, req, horizon=14) is not None
    # history rows, xreg and unlisted quantile sets always dispatch
    assert cache.lookup(req, 14, True, None, "raise", None) is None
    assert cache.lookup(req, 14, False, None, "raise", object()) is None
    assert _read(cache, req, quantiles=[0.25]) is None
    # a second distinct horizon is past max_horizons=1: dispatch only
    assert _read(cache, req, horizon=30) is None
    assert cache.metrics.misses.value(reason="horizon_cap") == 1
    assert cache.metrics.misses.value(reason="bypass") == 3


def test_unknown_series_raise_as_dispatch_does(theta_art):
    _, fc = _pair(theta_art[0])
    cache = _cache(tcache, fc)
    bad = pd.DataFrame({k: [999] for k in fc.key_names})
    with pytest.raises(tpred.UnknownSeriesError):
        _read(cache, bad)
    with pytest.raises(tpred.UnknownSeriesError):
        fc.predict(bad, horizon=14)
    # on_missing=skip with every row unknown: empty, dispatch shapes it
    assert cache.lookup(bad, 14, False, None, "skip", None) is None
    assert cache.metrics.misses.value(reason="bypass") == 1


# -- no stale read after a write ----------------------------------------------

def test_no_stale_read_after_an_ingest_apply(theta_art):
    from distributed_forecasting_tpu_torch.engine.state_store import (
        SeriesStateStore,
    )

    path, y, mask = theta_art
    _, fc = _pair(path)
    store = SeriesStateStore(fc, time_bucket=16, history_y=y,
                             history_mask=mask, device="cpu")
    cache = _cache(tcache, fc)
    req = _req(fc)
    before = _read(cache, req)
    assert before is not None
    store.ingest([(0, store.day_cur + 1, 123.0)])
    assert store.apply_pending()["points"] == 1  # swap_state -> rebuild
    after = _read(cache, req)
    _assert_identical(after, fc.predict(req, horizon=14))
    assert not after["ds"].equals(before["ds"])  # the grid moved a day
    assert cache.metrics.invalidations.value == 1
    assert cache.metrics.rebuilds.value == 2
    assert cache.metrics.misses.value(reason="stale") == 0


def test_no_stale_read_after_a_full_refit(theta_art):
    from distributed_forecasting_tpu_torch.engine.state_store import (
        SeriesStateStore,
    )

    path, y, mask = theta_art
    _, fc = _pair(path)
    store = SeriesStateStore(fc, time_bucket=16, history_y=y,
                             history_mask=mask, device="cpu")
    cache = _cache(tcache, fc)
    req = _req(fc)
    before = _read(cache, req)
    assert before is not None
    # enough signal that the refit lands other parameters
    day1 = store.day_cur
    store.ingest([(s, day1 + 1 + d, 50.0 + 7.0 * s + d)
                  for s in range(fc.keys.shape[0]) for d in range(3)])
    store.apply_pending()
    prep, dispatch, complete = store.refit_stages()
    complete(dispatch(prep()))  # _install_refit -> swap_state
    after = _read(cache, req)
    _assert_identical(after, fc.predict(req, horizon=14))
    assert not np.array_equal(after["yhat"].to_numpy(),
                              before["yhat"].to_numpy())


def test_no_stale_read_after_a_windowed_tail_refit():
    from distributed_forecasting_tpu_torch.data.tensorize import SeriesBatch
    from distributed_forecasting_tpu_torch.engine.windowed import (
        WindowedConfig,
        WindowedSeriesStateStore,
        windowed_fit_forecast,
    )
    from distributed_forecasting_tpu_torch.models.arima import ArimaConfig

    rng = np.random.default_rng(3)
    S, T = 2, 2000
    eps = rng.normal(0.0, 1.0, (S, T))
    y = np.zeros((S, T))
    for t in range(2, T):
        y[:, t] = 0.55 * y[:, t - 1] + 0.20 * y[:, t - 2] + eps[:, t]
    y = (y + 10.0).astype(np.float32)
    batch = SeriesBatch(
        y=torch.from_numpy(y), mask=torch.ones(S, T),
        day=torch.arange(T, dtype=torch.int32),
        keys=np.arange(S)[:, None], key_names=("series",),
        start_date="1970-01-01")
    wcfg = WindowedConfig(enabled=True, window_len=512, overlap=64,
                          min_windows=2)
    params, _ = windowed_fit_forecast(batch, horizon=14, wconfig=wcfg)
    fc = tpred.BatchForecaster("arima", ArimaConfig(), params, batch.keys,
                               batch.key_names, day0=T - wcfg.window_len,
                               day1=T - 1)
    store = WindowedSeriesStateStore(fc, y, np.ones_like(y), history_day0=0,
                                     wconfig=wcfg, device="cpu")
    cache = _cache(tcache, fc)
    req = _req(fc)
    before = _read(cache, req, horizon=7)
    assert before is not None
    # writer 1: a day1-only grid advance (swap_state with no new params)
    store.ingest([(s, T + d, 10.0 + s + 0.5 * d)
                  for s in range(S) for d in range(2)])
    store.apply_pending()
    mid = _read(cache, req, horizon=7)
    _assert_identical(mid, fc.predict(req, horizon=7))
    assert not mid["ds"].equals(before["ds"])
    # writer 2: the tail-window refit installs new params
    prep, dispatch, complete = store.refit_stages()
    complete(dispatch(prep()))
    _assert_identical(_read(cache, req, horizon=7),
                      fc.predict(req, horizon=7))
    assert cache.metrics.invalidations.value == 2


def test_a_rebuild_a_writer_overtakes_is_discarded(theta_art):
    """The overtaken frame mixes the old state with the new generation: it
    is not published; the writer's own listener pass rebuilds from the new
    state, and every read equals a dispatch of it."""
    _, fc = _pair(theta_art[0])
    cache = _cache(tcache, fc)
    req = _req(fc)
    real_predict = fc.predict
    raced = threading.Event()

    def racing_predict(*a, **k):
        out = real_predict(*a, **k)
        if not raced.is_set():
            raced.set()
            fc.predict = real_predict
            fc.swap_state(day1=fc.day1 + 1)  # lands mid-rebuild
        return out

    fc.predict = racing_predict
    first = _read(cache, req)
    _assert_identical(_read(cache, req), real_predict(req, horizon=14))
    if first is not None:
        _assert_identical(first, real_predict(req, horizon=14))
    with cache._lock:
        entry = cache._entries[(14, None)]
    assert entry.epoch == fc.state_generation() == 1


# -- persistence --------------------------------------------------------------

def test_persisted_files_have_the_reference_layout(theta_art, tmp_path):
    """Same file stems, format string and meta keys; equal ``ds``, columns,
    ``day1`` and payload shape and dtype; payload values within theta's
    tolerance.  The fingerprint differs (pinned): a frame either package
    persisted is discarded by the other at boot."""
    path, y, _ = theta_art
    jfc, tfc = _pair(path)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jc = _cache(jcache, jfc, mmap_dir=jdir)
    tc = _cache(tcache, tfc, mmap_dir=tdir)
    for cache, fc in ((jc, jfc), (tc, tfc)):
        assert _read(cache, _req(fc, [1])) is not None
        assert _read(cache, _req(fc, [1]), quantiles=QSET) is not None
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) == [
        "h14-q0p1_0p5_0p9.meta.json", "h14-q0p1_0p5_0p9.npy",
        "h14.meta.json", "h14.npy"]
    scale = float(np.abs(y).max())
    for stem in ("h14", "h14-q0p1_0p5_0p9"):
        with open(os.path.join(tdir, stem + ".meta.json")) as f:
            got = json.load(f)
        with open(os.path.join(jdir, stem + ".meta.json")) as f:
            want = json.load(f)
        assert sorted(got) == sorted(want)
        assert got["format"] == "dftpu-forecast-cache-v1"
        for key in ("horizon", "quantiles", "columns", "day1", "ds_i8",
                    "ds_dtype"):
            assert got[key] == want[key], key
        assert got["state_fingerprint"] != want["state_fingerprint"]
        a = np.load(os.path.join(tdir, stem + ".npy"))
        b = np.load(os.path.join(jdir, stem + ".npy"))
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale)
    # the fingerprints are not shared: each package discards the other's
    for mod, fc, other in ((tcache, tfc, jdir), (jcache, jfc, tdir)):
        copy = str(tmp_path / f"copy_{mod.__name__.split('.')[0]}")
        shutil.copytree(other, copy)
        boot = _cache(mod, fc, mmap_dir=copy)
        assert boot.metrics.loads.value == 0
        assert boot.metrics.load_errors.value == 2
        assert not os.listdir(copy)


def test_a_persisted_frame_is_adopted_at_boot(theta_art, tmp_path):
    path = theta_art[0]
    _, fc = _pair(path)
    cache = _cache(tcache, fc, mmap_dir=str(tmp_path))
    req = _req(fc, [0, 2])
    assert _read(cache, req) is not None
    assert cache.metrics.persists.value == 1
    # a restart: the same artifact state, a fresh cache over the files
    _, fc2 = _pair(path)
    cache2 = _cache(tcache, fc2, mmap_dir=str(tmp_path))
    assert cache2.metrics.loads.value == 1
    hit = _read(cache2, req)
    assert cache2.metrics.rebuilds.value == 0  # served from the mmap frame
    _assert_identical(hit, fc2.predict(req, horizon=14))
    # the adopted entry is invalidated by the first install after boot
    fc2.swap_state(day1=fc2.day1)
    assert cache2.metrics.invalidations.value == 1
    _assert_identical(_read(cache2, req), fc2.predict(req, horizon=14))


def test_persisted_frames_from_other_state_are_discarded(theta_art,
                                                         tmp_path):
    path = theta_art[0]
    _, fc = _pair(path)
    assert _read(_cache(tcache, fc, mmap_dir=str(tmp_path)),
                 _req(fc)) is not None
    _, fc2 = _pair(path)
    fc2.swap_state(day1=fc2.day1 + 5)  # a restart against newer state
    cache2 = _cache(tcache, fc2, mmap_dir=str(tmp_path))
    assert cache2.metrics.loads.value == 0
    assert cache2.metrics.load_errors.value == 1
    _assert_identical(_read(cache2, _req(fc2)),
                      fc2.predict(_req(fc2), horizon=14))
    # and params that differ under the same day1 change the fingerprint
    _, fc3 = _pair(path)
    p = fc3.params
    field = dataclasses.fields(p)[0].name
    fc3.swap_state(params=dataclasses.replace(
        p, **{field: getattr(p, field) + 1.0}))
    assert tcache.ForecastCache(fc3, tcache.CacheConfig(
        enabled=True))._state_fingerprint() != tcache.ForecastCache(
            fc2, tcache.CacheConfig(enabled=True))._state_fingerprint()


def test_a_torn_persisted_payload_is_discarded(theta_art, tmp_path):
    path = theta_art[0]
    _, fc = _pair(path)
    assert _read(_cache(tcache, fc, mmap_dir=str(tmp_path)),
                 _req(fc)) is not None
    (payload,) = [p for p in os.listdir(tmp_path) if p.endswith(".npy")]
    ppath = os.path.join(tmp_path, payload)
    with open(ppath, "rb") as f:
        blob = f.read()
    with open(ppath, "wb") as f:
        f.write(blob[: len(blob) // 2])  # torn mid-write
    _, fc2 = _pair(path)
    cache2 = _cache(tcache, fc2, mmap_dir=str(tmp_path))
    assert cache2.metrics.load_errors.value == 1
    assert cache2.metrics.loads.value == 0
    assert not os.listdir(tmp_path)  # both halves of the pair removed
    _assert_identical(_read(cache2, _req(fc2)),
                      fc2.predict(_req(fc2), horizon=14))


def test_the_persist_failpoint_keeps_memory_serving(theta_art, tmp_path):
    _, fc = _pair(theta_art[0])
    cache = _cache(tcache, fc, mmap_dir=str(tmp_path))
    fp.configure("cache.persist=raise OSError")
    try:
        hit = _read(cache, _req(fc))
        assert hit is not None  # the in-memory frame serves regardless
        assert fp.fired("cache.persist") == 1
        assert cache.metrics.persist_errors.value == 1
        assert not os.listdir(tmp_path)
    finally:
        fp.deactivate()
    _assert_identical(hit, fc.predict(_req(fc), horizon=14))


def test_the_load_failpoint_discards_and_dispatch_serves(theta_art,
                                                         tmp_path):
    path = theta_art[0]
    _, fc = _pair(path)
    assert _read(_cache(tcache, fc, mmap_dir=str(tmp_path)),
                 _req(fc)) is not None
    _, fc2 = _pair(path)
    fp.configure("cache.load=raise OSError")
    try:
        cache2 = _cache(tcache, fc2, mmap_dir=str(tmp_path))
        assert fp.fired("cache.load") == 1
    finally:
        fp.deactivate()
    assert (cache2.metrics.loads.value, cache2.metrics.load_errors.value) == (
        0, 1)
    _assert_identical(_read(cache2, _req(fc2)),
                      fc2.predict(_req(fc2), horizon=14))


# -- composites, Monte-Carlo, the fleet --------------------------------------

def test_composites_and_monte_carlo_forecasters_serve_uncached(artifacts,
                                                               theta_art):
    from distributed_forecasting_tpu_torch.serving.bucketed import (
        BucketedForecaster,
    )
    from distributed_forecasting_tpu_torch.serving.ensemble import (
        BlendedForecaster,
        MultiModelForecaster,
    )

    _, fc = _pair(theta_art[0])
    S = fc.n_series
    for composite in (
            MultiModelForecaster({"theta": fc}, np.zeros(S, np.int64)),
            BlendedForecaster({"theta": fc}, np.ones((S, 1), np.float32)),
            BucketedForecaster([fc])):
        assert tcache.build_forecast_cache({"enabled": True},
                                           composite) is None
    assert tcache.build_forecast_cache({"enabled": False}, object()) is None
    assert tcache.build_forecast_cache(None, object()) is None
    # Monte-Carlo intervals (pinned): the port serves them uncached, since
    # a series' draws depend on the rows drawn beside it; the reference
    # caches them
    jfc, tfc = _pair(artifacts("prophet")[0])
    mc = {"config": dataclasses.replace(tfc.config, uncertainty_samples=50)}
    tmc = tpred.BatchForecaster(tfc.model, params=tfc.params, keys=tfc.keys,
                                key_names=tfc.key_names, day0=tfc.day0,
                                day1=tfc.day1, **mc)
    jmc = jpred.BatchForecaster(
        jfc.model, params=jfc.params, keys=jfc.keys,
        key_names=jfc.key_names, day0=jfc.day0, day1=jfc.day1,
        config=dataclasses.replace(jfc.config, uncertainty_samples=50))
    assert tcache.build_forecast_cache({"enabled": True}, tmc) is None
    assert jcache.build_forecast_cache({"enabled": True}, jmc) is not None


def test_the_fleet_max_merges_the_entry_age(theta_art):
    assert "dftpu_cache_entry_age_seconds" in tfleet._GAUGE_MAX_MERGE
    assert {"dftpu_cache_bytes", "dftpu_cache_entries"} <= \
        tfleet._GAUGE_SUM_MERGE
    texts = []
    for rows in ([0], [1, 2]):
        _, fc = _pair(theta_art[0])
        cache = _cache(tcache, fc)
        for _ in rows:
            assert _read(cache, _req(fc, rows)) is not None
        texts.append(cache.render_metrics())
    ages = [float(next(line.split()[1] for line in t.splitlines()
                       if line.startswith("dftpu_cache_entry_age_seconds ")))
            for t in texts]
    got = tfleet.aggregate_prometheus(texts)
    assert got == jfleet.aggregate_prometheus(texts)
    assert "dftpu_cache_hits_total 3" in got   # counters sum
    assert "dftpu_cache_entries 2" in got      # counts sum
    merged = float(next(line.split()[1] for line in got.splitlines()
                        if line.startswith("dftpu_cache_entry_age_seconds ")))
    assert merged == max(ages)


# -- the server over real HTTP ----------------------------------------------

def _post(srv, payload):
    conn = http.client.HTTPConnection(*srv.server_address, timeout=60)
    try:
        conn.request("POST", "/invocations", json.dumps(payload).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("batching", [False, True], ids=["direct", "batched"])
def test_the_server_serves_cached_bodies_byte_equal(theta_art, batching):
    """Two port scorers over one artifact, cache on and cache off: every
    body and status equal, each request twice (a miss or rebuild, then the
    byte memo); ``/metrics`` carries the ``dftpu_cache_*`` families."""
    from distributed_forecasting_tpu_torch.serving.batcher import (
        BatchingConfig,
    )

    path = theta_art[0]
    _, fc_on = _pair(path)
    _, fc_off = _pair(path)
    cache = _cache(tcache, fc_on)
    bcfg = BatchingConfig(enabled=batching, max_wait_ms=1.0)
    on = tserver.start_server(fc_on, cache=cache, batching=bcfg)
    off = tserver.start_server(fc_off, batching=bcfg)
    named = [dict(zip(fc_on.key_names, map(int, k))) for k in fc_on.keys]
    requests = [
        {"inputs": named[:1], "horizon": 9},
        {"inputs": named[::-1], "horizon": 9},
        {"inputs": named[1:3], "horizon": 9, "quantiles": [0.5, 0.9, 0.1]},
        {"inputs": named[:2], "horizon": 9, "quantiles": [0.25]},
        {"inputs": named[:2], "horizon": 5, "include_history": True},
        {"inputs": [{"store": 99, "item": 1}], "horizon": 9},
        {"inputs": [*named[:1], {"store": 99, "item": 1}], "horizon": 9,
         "on_missing": "skip"},
    ]
    try:
        for req in requests:
            want = _post(off, req)
            for _ in range(2):
                assert _post(on, req) == want, req
        assert cache.metrics.hits.value == 8
        assert cache.metrics.rebuilds.value == 2
        assert cache.metrics.misses.value(reason="bypass") == 4
        conn = http.client.HTTPConnection(*on.server_address, timeout=60)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        for family in ("hits_total", "misses_total", "invalidations_total",
                       "rebuilds_total", "evictions_total", "persists_total",
                       "loads_total", "entries", "bytes",
                       "entry_age_seconds"):
            assert f"# TYPE dftpu_cache_{family} " in text, family
        assert "dftpu_cache_hits_total 8" in text
    finally:
        for srv in (on, off):
            srv.shutdown()
            srv.server_close()


@pytest.mark.parametrize("use_cache", [True, False], ids=["cached", "skipped"])
def test_execute_consults_the_cache_unless_told_not_to(theta_art, use_cache):
    """``ForecastServer.execute`` (the reference's signature: a caller other
    than the HTTP handler reads the frame-level cache by default): a hit is
    the dispatched frame, byte-equal, with no dispatch counted;
    ``use_cache=False``, as the handler passes it after its own lookup,
    dispatches and leaves the cache's counters alone."""
    _, fc = _pair(theta_art[0])
    cache = _cache(tcache, fc)
    req = _req(fc, [2, 0])
    _read(cache, req)  # the cold read builds the h14 frame
    srv = tserver.start_server(fc, cache=cache)
    try:
        hits, dispatches = cache.metrics.hits.value, srv.metrics.dispatches.value
        got = srv.execute(req, horizon=14, include_history=False,
                          quantiles=None, on_missing="raise", xreg=None,
                          use_cache=use_cache)
        _assert_identical(got, fc.predict(req, horizon=14))
        assert cache.metrics.hits.value == hits + use_cache
        assert srv.metrics.dispatches.value == dispatches + (not use_cache)
    finally:
        srv.shutdown()
        srv.server_close()
