"""The port's thread sanitizer (``monitoring/sanitizer.py``) against the
reference's runtime cases (``tests/unit/test_dftsan.py``), its seven
``attach`` sites under armed workloads, and its report read by the port's
``analysis/dftsan.load_reports`` (and the reference's).

* The runtime cases: a disarmed ``attach`` leaves the object as a build
  without the sanitizer would (checked structurally: the reference's
  wall-clock overhead case is not ported, it fails under load); lock-order
  edges, RLock re-entry, unlocked and locked guarded accesses (a lock held
  by another thread still flags), ``Condition.wait_for``'s predicate run
  marked held, the stop-race shape the reference fixed, seeded
  perturbation through ``sanitizer.yield`` and the disarmed lock path
  firing no failpoint.
* Each attached class, armed, runs a short concurrent workload of its own
  with no violation and with its lock recorded: the state store and the
  WAL under concurrent ingest and predicts, the forecast cache's rebuilds,
  the forecaster's ``_mesh_lock`` under concurrent predicts and a cache
  rebuild on a one-rank mesh, the coalescer, the connection pool, and the
  fleet supervisor over in-process replicas.
* The written report has the reference's layout: the port's own
  ``analysis/dftsan.load_reports`` reads it and merges counts across
  files, and the reference's reads it too (the format check).
"""

import threading

import pandas as pd
import pytest
import torch

from distributed_forecasting_tpu_torch.monitoring import failpoints, sanitizer

torch.set_num_threads(1)

PORT = "distributed_forecasting_tpu_torch"


@pytest.fixture
def san():
    """Arm the sanitizer for one test, restore the prior state after."""
    was = sanitizer.is_enabled()
    sanitizer.configure()
    sanitizer.reset()
    yield sanitizer
    sanitizer.reset()
    if not was:
        sanitizer.deactivate()


# -- the reference's runtime cases ----------------------------------------------

class _Plain:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        sanitizer.attach(self, guards={"_lock": ("count",)})


def test_disarmed_attach_is_structurally_free():
    assert not sanitizer.is_enabled()
    obj = _Plain()
    # no class swap, no lock wrapping, no descriptors: the object a build
    # without the sanitizer would produce
    assert type(obj) is _Plain
    assert type(obj._lock) is type(threading.Lock())
    assert "count" not in type(obj).__dict__
    obj.count = 1  # no checks fire
    assert sanitizer.snapshot()["violations"] == []


class _Duo:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.RLock()
        sanitizer.attach(self, locks=("_a", "_b"))


def test_lock_order_edges_recorded(san):
    d = _Duo()
    with d._a:
        with d._b:
            pass
    with d._a:  # repeat: same edge, count bumps, no duplicate
        with d._b:
            pass
    snap = sanitizer.snapshot()
    assert len(snap["edges"]) == 1
    edge = snap["edges"][0]
    assert edge["src"][1:] == ["_Duo", "_a"]
    assert edge["dst"][1:] == ["_Duo", "_b"]
    assert edge["count"] == 2
    kinds = {tuple(e["id"])[2]: e["kind"] for e in snap["locks"]}
    assert kinds == {"_a": "lock", "_b": "rlock"}
    acquires = {tuple(e["id"])[2]: e["acquires"] for e in snap["locks"]}
    assert acquires == {"_a": 2, "_b": 2}


def test_rlock_reentry_is_not_a_self_edge(san):
    d = _Duo()
    with d._b:
        with d._b:  # re-entry on the same RLock: depth, not an edge
            pass
    assert sanitizer.snapshot()["edges"] == []


def test_unlocked_access_flagged_with_provenance(san):
    obj = _Plain()
    obj.count = 7          # write without the lock
    _ = obj.count          # read without the lock
    snap = sanitizer.snapshot()
    ops = sorted((v["op"], v["attr"]) for v in snap["violations"])
    assert ops == [("read", "count"), ("write", "count")]
    v = snap["violations"][0]
    assert v["lock"][1:] == ["_Plain", "_lock"]
    assert v["thread"] == threading.current_thread().name
    assert "test_torch_sanitizer" in v["stack"]


def test_locked_access_is_clean(san):
    obj = _Plain()
    with obj._lock:
        obj.count = 7
        assert obj.count == 7
    assert sanitizer.snapshot()["violations"] == []


def test_lock_held_by_other_thread_still_flags(san):
    obj = _Plain()
    entered = threading.Event()
    release = threading.Event()

    def holder():
        with obj._lock:
            entered.set()
            release.wait(5)

    th = threading.Thread(target=holder)
    th.start()
    entered.wait(5)
    obj.count = 9  # the lock is held, but by ANOTHER thread
    release.set()
    th.join()
    viol = sanitizer.snapshot()["violations"]
    assert len(viol) == 1 and viol[0]["op"] == "write"


def test_condition_wait_for_runs_predicate_marked_held(san):
    class Gate:
        def __init__(self):
            self._cond = threading.Condition()
            self.ready = False
            sanitizer.attach(self, guards={"_cond": ("ready",)})

    g = Gate()

    def setter():
        with g._cond:
            g.ready = True
            g._cond.notify_all()

    th = threading.Thread(target=setter)
    with g._cond:
        th.start()
        # wait releases the lock for real (setter gets in) but the
        # predicate, which READS the guarded attr, must run marked held
        assert g._cond.wait_for(lambda: g.ready, timeout=5)
    th.join()
    assert sanitizer.snapshot()["violations"] == []


class _RacySupervisor:
    """The stop() shape the reference fixed: snapshot the replica table
    under the lock, terminate outside it, then write the table back
    unlocked, clobbering whatever a concurrent resize installed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._replicas = ["r0", "r1"]
        sanitizer.attach(self, guards={"_lock": ("_replicas",)})

    def stop(self):
        with self._lock:
            doomed = list(self._replicas)
        doomed.clear()              # "terminate" outside the lock: fine
        self._replicas = []         # unlocked write-back: the bug


def test_dftsan_catches_the_stop_race_shape(san):
    _RacySupervisor().stop()
    viol = sanitizer.snapshot()["violations"]
    assert len(viol) == 1
    assert viol[0]["attr"] == "_replicas" and viol[0]["op"] == "write"
    assert "stop" in viol[0]["stack"]


def test_the_fixed_stop_shape_is_clean(san):
    class Fixed(_RacySupervisor):
        def stop(self):
            with self._lock:
                doomed = list(self._replicas)
            doomed.clear()
            with self._lock:
                self._replicas = []

    Fixed().stop()
    assert sanitizer.snapshot()["violations"] == []


def test_perturbation_is_deterministic_under_fixed_seed(san):
    def run(seed):
        failpoints.configure("sanitizer.yield=sleep 0:0.5", seed=seed)
        try:
            obj = _Plain()
            for _ in range(200):
                with obj._lock:
                    pass
            return failpoints.fired("sanitizer.yield")
        finally:
            failpoints.deactivate()

    a, b = run(42), run(42)
    assert a == b and a > 0
    # a different seed draws a different firing pattern (not a constant)
    assert run(7) != a or run(9) != a


def test_disarmed_lock_path_fires_no_failpoints(san):
    obj = _Plain()
    with obj._lock:
        pass
    assert failpoints.fired("sanitizer.yield") == 0


# -- the report, read by the port's analysis (and once by the reference's, as
# a check that the format is the reference's) ----------------------------------

def test_report_roundtrip_through_dir_with_the_reference_loader(san,
                                                               tmp_path):
    from distributed_forecasting_tpu.analysis.dftsan import load_reports

    obj = _Plain()
    obj.count = 1
    path = sanitizer.write_report(str(tmp_path))
    assert path.endswith(".json")
    merged, loaded = load_reports([str(tmp_path)])
    assert loaded == [path]
    assert len(merged["violations"]) == 1
    ((lid, attr, op, _, _),) = merged["violations"].keys()
    assert (lid[1], attr, op) == ("_Plain", "count", "write")


def test_load_reports_merges_the_port_s_counts(san, tmp_path):
    from distributed_forecasting_tpu_torch.analysis.dftsan import (
        load_reports,
    )

    obj = _Plain()
    obj.count = 1
    sanitizer.write_report(str(tmp_path / "a.json"))
    sanitizer.write_report(str(tmp_path / "b.json"))
    merged, loaded = load_reports([str(tmp_path)])
    assert len(loaded) == 2
    (v,) = merged["violations"].values()
    assert v["count"] == 2  # same site, counts add across reports


def test_env_arms_the_sanitizer_and_its_atexit_report(tmp_path):
    """``DFTPU_TSAN=1`` and ``DFTPU_TSAN_REPORT_DIR`` in a fresh process:
    an attached forecaster records its locks, and the pid-named report at
    exit loads through the port's own reader with the port's lock ids."""
    import json
    import os
    import subprocess
    import sys

    from distributed_forecasting_tpu_torch.analysis.dftsan import (
        load_reports,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import threading\n"
        "from distributed_forecasting_tpu_torch.monitoring import "
        "sanitizer\n"
        "from distributed_forecasting_tpu_torch.serving.ingest import "
        "WriteAheadLog\n"
        "assert sanitizer.is_enabled()\n"
        f"wal = WriteAheadLog({str(tmp_path / 'wal')!r})\n"
        "wal.append([{'k': [1, 1], 'd': 5, 'y': 1.0}])\n")
    env = {**os.environ, "DFTPU_TSAN": "1",
           "DFTPU_TSAN_REPORT_DIR": str(tmp_path / "reports"),
           "PYTHONPATH": root}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root, timeout=120)
    (name,) = os.listdir(tmp_path / "reports")
    with open(tmp_path / "reports" / name) as f:
        report = json.load(f)
    ids = [tuple(lock["id"]) for lock in report["locks"]]
    assert (f"{PORT}/serving/ingest.py", "WriteAheadLog", "_lock") in ids
    merged, loaded = load_reports([str(tmp_path / "reports")])
    assert len(loaded) == 1 and merged["violations"] == {}


# -- the seven attached classes, armed ------------------------------------------

@pytest.fixture(scope="module")
def hw_fit():
    """A small Holt-Winters fit on the CPU and its history: (batch,
    params, config)."""
    from distributed_forecasting_tpu_torch.data import (
        synthetic_store_item_sales,
        tensorize,
    )
    from distributed_forecasting_tpu_torch.models import get_model

    batch = tensorize(synthetic_store_item_sales(
        n_stores=2, n_items=4, n_days=90, seed=21), device="cpu")
    fns = get_model("holt_winters")
    cfg = fns.config_cls()
    return batch, fns.fit(batch.y, batch.mask, batch.day, cfg), cfg


def _forecaster(hw_fit):
    """A fresh forecaster, built while the sanitizer is armed."""
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    batch, params, cfg = hw_fit
    return BatchForecaster.from_fit(batch, params, "holt_winters", cfg)


def _requests(fc):
    return [pd.DataFrame(fc.keys[:k], columns=list(fc.key_names))
            for k in (1, 3, 8)]


def _run_threads(fns) -> None:
    errors = []

    def guarded(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(fn,)) for fn in fns]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not any(th.is_alive() for th in threads)
    if errors:
        raise errors[0]


def _clean_and_recorded(cls_name: str, module: str, attr: str) -> None:
    snap = sanitizer.snapshot()
    assert snap["violations"] == [], snap["violations"]
    acquires = {tuple(lock["id"]): lock["acquires"] for lock in snap["locks"]}
    lid = (f"{PORT}/{module}.py", cls_name, attr)
    assert acquires.get(lid, 0) > 0, sorted(acquires)


def _state_store_and_wal(hw_fit, tmp_path):
    """The ingest runtime in sync mode: WAL appends, the store's pending
    buffer and applies from four threads while two others predict."""
    from distributed_forecasting_tpu_torch.serving.ingest import (
        build_ingest_runtime,
    )

    batch, _, _ = hw_fit
    fc = _forecaster(hw_fit)
    rt = build_ingest_runtime(
        {"enabled": True, "wal_dir": str(tmp_path / "wal"),
         "apply_mode": "sync", "time_bucket": 8}, fc,
        history_y=batch.y.numpy(), history_mask=batch.mask.numpy(),
        device="cpu")
    day1 = int(fc._state_snapshot()[1])
    keys = [[int(v) for v in k] for k in fc.keys]

    def writer(i):
        return lambda: [rt.submit([{"k": keys[(i + j) % len(keys)],
                                    "d": day1 + 1 + j, "y": 10.0 + i}])
                        for j in range(3)]

    def reader():
        for req in _requests(fc) * 2:
            fc.predict(req, horizon=7)

    _run_threads([writer(i) for i in range(4)] + [reader, reader])
    rt.store.stats()
    return fc


def test_state_store_workload_is_clean(san, hw_fit, tmp_path):
    _state_store_and_wal(hw_fit, tmp_path)
    _clean_and_recorded("SeriesStateStore", "engine/state_store", "_lock")
    _clean_and_recorded("BatchForecaster", "serving/predictor",
                        "_state_lock")


def test_write_ahead_log_workload_is_clean(san, tmp_path):
    from distributed_forecasting_tpu_torch.serving.ingest import WriteAheadLog

    wal = WriteAheadLog(str(tmp_path / "wal"), max_segment_bytes=512)

    def appender(i):
        return lambda: [wal.append([{"k": [i, j], "d": 100 + j, "y": 1.0}])
                        for j in range(20)]

    _run_threads([appender(i) for i in range(4)])
    got, _ = wal.read_new()
    assert len(got) == 80
    _clean_and_recorded("WriteAheadLog", "serving/ingest", "_lock")


def _wait_for(pred, timeout=60.0):
    import time

    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.01)


def test_forecast_cache_and_the_mesh_lock_on_a_one_rank_mesh(san, hw_fit):
    """The forecaster on a one-rank mesh (an in-process gloo group): four
    threads predict through ``_mesh_lock`` while the cache's writer thread
    rebuilds after a state install, and lookups read its entries."""
    import torch.distributed as dist

    from distributed_forecasting_tpu_torch.parallel import make_mesh
    from distributed_forecasting_tpu_torch.parallel import mesh as mesh_mod
    from distributed_forecasting_tpu_torch.serving.forecast_cache import (
        build_forecast_cache,
    )

    fc = _forecaster(hw_fit)
    cache = build_forecast_cache({"enabled": True}, fc)
    mesh = make_mesh(device="cpu")
    try:
        fc.enable_mesh(mesh)
        assert fc._aot_entry("serving_predict").endswith("@mesh1")
        req = _requests(fc)[-1]

        def lookup():
            return cache.lookup(req, horizon=7, include_history=False,
                                quantiles=None, on_missing="raise",
                                xreg=None)

        lookup()                       # a cold miss starts the rebuild
        _wait_for(lambda: lookup() is not None)

        def reader():
            for r in _requests(fc) * 3:
                fc.predict(r, horizon=7)

        def installer():
            fc.swap_state(day1=fc._state_snapshot()[1])  # a republish

        _run_threads([reader] * 4 + [installer])
        _wait_for(lambda: lookup() is not None)
        assert fc.stop_mesh() == []
    finally:
        dist.destroy_process_group()
        mesh_mod._RANK_DEVICE = None
    _clean_and_recorded("ForecastCache", "serving/forecast_cache", "_lock")
    _clean_and_recorded("BatchForecaster", "serving/predictor", "_mesh_lock")


def test_request_batcher_workload_is_clean(san, hw_fit):
    from distributed_forecasting_tpu_torch.serving.batcher import (
        BatchingConfig,
        RequestBatcher,
    )

    fc = _forecaster(hw_fit)
    batcher = RequestBatcher(fc, BatchingConfig(enabled=True,
                                                max_batch_size=16,
                                                max_wait_ms=5.0))
    try:
        futures = []
        lock = threading.Lock()

        def client(req):
            def run():
                f = batcher.submit(req, horizon=7)
                with lock:
                    futures.append(f)
            return run

        _run_threads([client(r) for r in _requests(fc) * 3])
        assert all(len(f.result(60)) > 0 for f in futures)
    finally:
        batcher.close()
    _clean_and_recorded("RequestBatcher", "serving/batcher", "_cond")


def test_connection_pool_workload_is_clean(san):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from distributed_forecasting_tpu_torch.serving.dataplane import (
        ConnectionPool,
        HttpConfig,
    )

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    pool = ConnectionPool(HttpConfig())
    try:
        def client():
            for _ in range(10):
                conn, _ = pool.acquire("127.0.0.1", port, 10.0)
                conn.request("GET", "/")
                resp = conn.getresponse()
                assert resp.read() == b"ok"
                pool.release(conn, healthy=True)

        _run_threads([client] * 4)
        pool.drain("127.0.0.1", port)
    finally:
        pool.close()
        srv.shutdown()
        srv.server_close()
    _clean_and_recorded("ConnectionPool", "serving/dataplane", "_lock")


def test_fleet_supervisor_workload_is_clean(san):
    """The supervisor over in-process replicas: health polls, round-robin
    routing from four threads, a resize, a kill and a restart, the drain."""
    from test_torch_fleet import _boot, _front_call

    sup, front, procs = _boot(replicas=2)
    try:
        _run_threads([lambda: [_front_call(front) for _ in range(5)]] * 4)
        sup.resize(3)
        sup.poll_once()
        sup.kill_replica(0)
        sup.poll_once()
        sup.describe()
    finally:
        front.shutdown()
        sup.stop()
    _clean_and_recorded("FleetSupervisor", "serving/fleet", "_lock")


def test_each_of_the_seven_classes_attaches_once_armed(san, hw_fit,
                                                       tmp_path):
    """Every class the reference attaches swaps to its guarded subclass
    when built armed, keeping its name, and wraps the lock it names."""
    from distributed_forecasting_tpu_torch.serving.batcher import (
        BatchingConfig,
        RequestBatcher,
    )
    from distributed_forecasting_tpu_torch.serving.dataplane import (
        ConnectionPool,
    )
    from distributed_forecasting_tpu_torch.serving.forecast_cache import (
        build_forecast_cache,
    )
    from distributed_forecasting_tpu_torch.serving.ingest import (
        WriteAheadLog,
    )

    from test_torch_fleet import _boot

    fc = _state_store_and_wal(hw_fit, tmp_path)
    sup, front, _ = _boot(replicas=1)
    front.shutdown()
    sup.stop()
    batcher = RequestBatcher(fc, BatchingConfig(enabled=True))
    batcher.close()
    objs = {
        "BatchForecaster": (fc, "_state_lock"),
        "ForecastCache": (build_forecast_cache({"enabled": True}, fc),
                          "_lock"),
        "ConnectionPool": (ConnectionPool(), "_lock"),
        "WriteAheadLog": (WriteAheadLog(str(tmp_path / "wal2")), "_lock"),
        "RequestBatcher": (batcher, "_cond"),
        "FleetSupervisor": (sup, "_lock"),
    }
    for name, (obj, attr) in objs.items():
        parent = type(obj).__mro__[1]
        assert type(obj).__name__ == parent.__name__ == name
        assert type(obj.__dict__[attr]).__name__ == "_InstrumentedSync"
    ids = [tuple(lock["id"]) for lock in sanitizer.snapshot()["locks"]]
    assert (f"{PORT}/engine/state_store.py", "SeriesStateStore",
            "_lock") in ids
    assert sanitizer.snapshot()["violations"] == []
