"""Port parity: the micro-batching coalescer (``serving/batcher.py``).

The scheduling cases run the same script against the reference's
``RequestBatcher`` and the port's, over one deterministic fake forecaster,
and must see the same dispatches and results: coalescing into one merged
call, exact per-request slices, signatures, xreg and non-``coalesce_safe``
forecasters dispatched alone, 429 on a full queue (``QueueFullError``), 503
on a timeout (``TimeoutError``), the drain on close and a poisoned request
retried alone without failing its neighbours.

Then the port's real ``BatchForecaster`` on the CPU, for the curve model,
Holt-Winters and arima: every coalesced response is byte-equal (through the
server's ``_encode_predictions``) to the same request served alone, at
request buckets 1, 8 and 64 — the promise ``coalesce_safe`` makes.
"""

import dataclasses
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from distributed_forecasting_tpu.serving import batcher as jbatcher
from distributed_forecasting_tpu_torch.serving import batcher as tbatcher

torch.set_num_threads(1)

PKGS = {"reference": jbatcher, "port": tbatcher}


class FakeForecaster:
    """Deterministic stand-in for BatchForecaster: T rows per requested key,
    yhat a pure function of (key, step); records each call's key count; can
    block on an event or raise on poison keys."""

    key_names = ("store", "item")
    coalesce_safe = True

    def __init__(self, block_event=None, poison=frozenset()):
        self.calls = []
        self.block_event = block_event
        self.poison = frozenset(poison)
        self.started = threading.Event()

    def predict(self, frame, horizon=90, include_history=False,
                on_missing="raise", xreg=None):
        keys = [tuple(r) for r in frame[list(self.key_names)].itertuples(
            index=False)]
        self.calls.append(len(keys))
        self.started.set()
        if self.block_event is not None:
            assert self.block_event.wait(10), "test forgot to release the fake"
        bad = [k for k in keys if k in self.poison]
        if bad:
            raise ValueError(f"poison keys {bad}")
        rows = [{"ds": f"2026-01-{t + 1:02d}", "store": s, "item": i,
                 "yhat": 1000.0 * s + 10.0 * i + t}
                for (s, i) in keys for t in range(horizon)]
        return pd.DataFrame(rows)

    def predict_quantiles(self, frame, quantiles, horizon=90,
                          include_history=False, on_missing="raise",
                          xreg=None):
        out = self.predict(frame, horizon=horizon,
                           include_history=include_history,
                           on_missing=on_missing, xreg=xreg)
        for q in quantiles:
            out[f"q{q}"] = out["yhat"]
        return out


def _frame(*keys):
    return pd.DataFrame(list(keys), columns=["store", "item"])


def _cfg(mod, **kw):
    base = dict(enabled=True, max_batch_size=16, max_wait_ms=100.0,
                max_queue_depth=32, request_timeout_s=5.0)
    base.update(kw)
    return mod.BatchingConfig(**base)


def _run(mod, fc, submits, **cfg):
    """Submit ``(keys, kwargs)`` requests back to back; returns the results
    (or the exceptions) in order, after the batcher drains."""
    b = mod.RequestBatcher(fc, _cfg(mod, **cfg))
    try:
        futs = [b.submit(_frame(*keys), **kw) for keys, kw in submits]
        outs = []
        for f in futs:
            try:
                outs.append(f.result(timeout=10))
            except Exception as e:  # noqa: BLE001 - compared below
                outs.append(e)
    finally:
        b.close()
    return outs


SCRIPTS = {
    "coalesce": [([(1, 1)], {"horizon": 7}), ([(1, 2)], {"horizon": 7}),
                 ([(2, 1)], {"horizon": 7}),
                 ([(2, 2), (1, 1)], {"horizon": 7})],
    "duplicate_key": [([(1, 1)], {"horizon": 5})] * 6,
    "signatures": [([(1, 1)], {"horizon": 5}), ([(1, 2)], {"horizon": 5}),
                   ([(2, 1)], {"horizon": 9}), ([(2, 2)], {"horizon": 9})],
    "quantiles": [([(1, 1)], {"horizon": 5, "quantiles": (0.1, 0.9)}),
                  ([(1, 2)], {"horizon": 5})],
    "xreg_solo": [([(1, 1)], {"horizon": 5, "xreg": np.zeros((5, 1))}),
                  ([(1, 2)], {"horizon": 5, "xreg": np.zeros((5, 1))})],
    "skip_missing": [([(1, 1), (9, 9)], {"horizon": 3, "on_missing": "skip"}),
                     ([(1, 2)], {"horizon": 3, "on_missing": "skip"})],
}
WANT_CALLS = {"coalesce": [4], "duplicate_key": [1], "signatures": [2, 2],
              "quantiles": [1, 1], "xreg_solo": [1, 1], "skip_missing": [3]}


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("script", list(SCRIPTS))
def test_scheduling_matches_the_reference(pkg, script):
    fc = FakeForecaster()
    outs = _run(PKGS[pkg], fc, SCRIPTS[script])
    assert sorted(fc.calls) == sorted(WANT_CALLS[script])
    probe = FakeForecaster()
    for (keys, kw), out in zip(SCRIPTS[script], outs):
        want = probe.predict(_frame(*keys), horizon=kw["horizon"])
        if "quantiles" in kw:
            want = probe.predict_quantiles(_frame(*keys), kw["quantiles"],
                                           horizon=kw["horizon"])
        pd.testing.assert_frame_equal(out, want)
        assert list(out.index) == list(range(len(out)))  # reindexed slices


@pytest.mark.parametrize("pkg", list(PKGS))
def test_non_coalesce_safe_forecaster_goes_solo(pkg):
    fc = FakeForecaster()
    fc.coalesce_safe = False  # composites reorder rows by member family
    _run(PKGS[pkg], fc, [([(1, 1)], {"horizon": 5}),
                         ([(1, 2)], {"horizon": 5})])
    assert fc.calls == [1, 1]


def test_composites_do_not_declare_coalesce_safe():
    from distributed_forecasting_tpu_torch.serving import (
        BatchForecaster,
        BlendedForecaster,
        BucketedForecaster,
        MultiModelForecaster,
    )

    assert BatchForecaster.coalesce_safe is True
    for cls in (MultiModelForecaster, BlendedForecaster, BucketedForecaster):
        assert getattr(cls, "coalesce_safe", False) is False, cls


@pytest.mark.parametrize("pkg", list(PKGS))
def test_full_queue_raises_queue_full(pkg):
    mod = PKGS[pkg]
    release = threading.Event()
    fc = FakeForecaster(block_event=release)
    b = mod.RequestBatcher(fc, _cfg(mod, max_batch_size=4, max_wait_ms=0.0,
                                    max_queue_depth=1))
    try:
        f1 = b.submit(_frame((1, 1)), horizon=3)
        assert fc.started.wait(5)  # the scheduler is inside predict
        f2 = b.submit(_frame((1, 2)), horizon=3)  # fills the 1-deep queue
        with pytest.raises(mod.QueueFullError, match="queue is full"):
            b.submit(_frame((2, 1)), horizon=3)  # -> the server's 429
        assert b.metrics.queue_depth.value == 1
    finally:
        release.set()
        b.close()
    assert len(f1.result(timeout=10)) == 3
    assert len(f2.result(timeout=10)) == 3


@pytest.mark.parametrize("pkg", list(PKGS))
def test_request_expired_in_queue_times_out(pkg):
    mod = PKGS[pkg]
    release = threading.Event()
    fc = FakeForecaster(block_event=release)
    b = mod.RequestBatcher(fc, _cfg(mod, max_batch_size=4, max_wait_ms=0.0,
                                    max_queue_depth=8,
                                    request_timeout_s=0.05))
    try:
        f1 = b.submit(_frame((1, 1)), horizon=3)
        assert fc.started.wait(5)
        f2 = b.submit(_frame((1, 2)), horizon=3)  # waits behind the block
        time.sleep(0.15)  # ... past its deadline
    finally:
        release.set()
        b.close()
    assert f1.result(timeout=10) is not None
    with pytest.raises(TimeoutError, match="timed out after 0.05s"):
        f2.result(timeout=10)  # -> the server's 503


@pytest.mark.parametrize("pkg", list(PKGS))
def test_close_drains_then_refuses(pkg):
    mod = PKGS[pkg]
    fc = FakeForecaster()
    b = mod.RequestBatcher(fc, _cfg(mod))
    futs = [b.submit(_frame((1, i)), horizon=4) for i in range(1, 5)]
    b.close()  # everything queued still gets its answer
    assert [len(f.result(timeout=10)) for f in futs] == [4] * 4
    assert not b.accepting
    with pytest.raises(mod.ShuttingDownError):
        b.submit(_frame((1, 1)), horizon=4)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_poisoned_request_does_not_fail_its_neighbours(pkg):
    fc = FakeForecaster(poison={(9, 9)})
    good, bad = _run(PKGS[pkg], fc, [([(1, 1)], {"horizon": 4}),
                                     ([(9, 9)], {"horizon": 4})])
    # one merged attempt, then one solo retry per member
    assert fc.calls == [2, 1, 1]
    assert len(good) == 4
    assert isinstance(bad, ValueError) and "poison" in str(bad)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_metrics_of_one_coalesced_dispatch(pkg):
    mod = PKGS[pkg]
    metrics = mod.ServingMetrics()
    b = mod.RequestBatcher(FakeForecaster(), _cfg(mod), metrics)
    try:
        for f in [b.submit(_frame((1, i)), horizon=3) for i in range(1, 5)]:
            f.result(timeout=10)
    finally:
        b.close()
    snap = metrics.snapshot()
    assert snap["serving_dispatches_total"] == 1
    assert snap["serving_batch_size"]["count"] == 1
    assert snap["serving_batch_size"]["buckets"]["4"] == 1
    assert "serving_batch_size_sum 4" in metrics.render()


@pytest.mark.parametrize("conf", [
    None, {},
    {"enabled": True, "max_batch_size": 8, "max_wait_ms": 2,
     "max_queue_depth": 16, "request_timeout_s": 10},
    {"enabled": "yes", "max_wait_ms": "0.5"},
], ids=["none", "empty", "full", "coerced"])
def test_batching_config_from_conf_matches_the_reference(conf):
    got = tbatcher.BatchingConfig.from_conf(conf)
    want = jbatcher.BatchingConfig.from_conf(conf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("bad", [
    {"max_batchsize": 8}, {"max_batch_size": 0}, {"max_wait_ms": -1},
    {"max_queue_depth": 0}, {"request_timeout_s": 0},
], ids=["typo", "batch_size", "wait", "queue_depth", "timeout"])
def test_batching_config_refuses_like_the_reference(bad):
    with pytest.raises(ValueError) as got:
        tbatcher.BatchingConfig.from_conf(bad)
    with pytest.raises(ValueError) as want:
        jbatcher.BatchingConfig.from_conf(bad)
    assert str(got.value) == str(want.value)


# -- the port's real forecasters on the CPU ----------------------------------

FAMILIES = ["prophet", "holt_winters", "arima"]


@pytest.fixture(scope="module")
def forecasters():
    from distributed_forecasting_tpu_torch import data, engine
    from distributed_forecasting_tpu_torch.models import get_model
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    df = data.synthetic_store_item_sales(n_stores=3, n_items=24, n_days=400,
                                         seed=11, missing_rate=0.03)
    batch = data.tensorize(df, device="cpu")
    out = {}
    for model in FAMILIES:
        params, _ = engine.fit_forecast(batch, model, horizon=14)
        scale = np.linspace(0.8, 1.3, batch.n_series).astype(np.float32)
        out[model] = BatchForecaster.from_fit(
            batch, params, model, get_model(model).config_cls(),
            interval_scale=scale)
    return out


@pytest.mark.parametrize("model", FAMILIES)
def test_coalesced_bodies_equal_solo_bodies(forecasters, model):
    """64 one-series requests (and two larger ones) through one merged
    dispatch: each body byte-equal to the request served alone, so to the
    bucket-1 (or its own bucket's) forecast, at buckets 1, 8 and 64."""
    from distributed_forecasting_tpu_torch.serving.server import (
        _encode_predictions,
    )

    fc = forecasters[model]
    keys = [tuple(map(int, k)) for k in fc.keys]
    requests = [[k] for k in keys[:62]] + [keys[62:70], keys[3:5]]
    for quantiles in (None, (0.1, 0.5, 0.9)):
        kw = {"horizon": 14, "include_history": quantiles is None,
              "quantiles": quantiles}
        b = tbatcher.RequestBatcher(fc, _cfg(tbatcher, max_batch_size=64,
                                             max_wait_ms=500.0,
                                             max_queue_depth=128))
        try:
            futs = [b.submit(_frame(*r), **kw) for r in requests]
            got = [f.result(timeout=60) for f in futs]
        finally:
            b.close()
        assert b.metrics.snapshot()["serving_dispatches_total"] == 1
        for r, out in zip(requests, got):
            frame = _frame(*r)
            solo = (fc.predict(frame, horizon=14, include_history=True)
                    if quantiles is None else fc.predict_quantiles(
                        frame, quantiles=quantiles, horizon=14))
            assert (_encode_predictions(out, fc.key_names)
                    == _encode_predictions(solo, fc.key_names)), r
