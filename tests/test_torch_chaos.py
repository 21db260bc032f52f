"""Chaos invariants on the port: injected faults -> held invariants.

The reference's chaos harness (``scripts/chaos_harness.py``) holds its
package to these scenarios; here the same invariants hold the port, each a
case of one parametrised test and deterministic from its seed:

  wal_kill9_replay       a WAL writer SIGKILLed mid-stream (a child
                         process self-arms ``kill9`` after 25 acked
                         appends): replay holds every acked batch, and a
                         torn final line does not eat the next writer's
                         first append.
  wal_enospc             seeded ENOSPC on the append (p 0.3 over 200
                         appends): replay is exactly the acked set and the
                         segment cursor matches the bytes on disk.
  aot_corrupt_warm_boot  one flipped byte of the stored kernel library
                         (``aot.load.payload=corrupt``) on a warm boot: the
                         library is rebuilt, answers as the unfaulted one
                         did, the ``error`` outcome is labelled, and the
                         next clean boot hits.  The store holds a library
                         built by a ``g++`` stub, as
                         ``tests/test_torch_compile_cache.py`` does (no
                         ``nvcc`` on this host); phase 20 of
                         ``chip_smoke.py`` and a ``cuda`` case of
                         ``tests/test_torch_cuda.py`` run it on the real
                         kernel library.
  slow_replica_brownout  a replica answering 200s 0.4 s late: the slow-call
                         breaker ejects it, every request gets a 200, and
                         traffic converges on the healthy replica.
  breaker_trip_recover   a hung replica trips its breaker OPEN; revived,
                         the half-open probe recloses it within
                         ``breaker_open_s`` and a few requests.
  keepalive_kill9_mid_stream
                         a replica killed while one keep-alive client
                         streams through the front door: every request
                         gets a 200 on the same client connection, pooled
                         legs were reused before the kill and the dead
                         replica's are evicted.
  error_contract_headers 503 / 429 responses carry Retry-After, a
                         well-formed X-Trace-Id is echoed on every
                         front-door-built response, and the sharded-routing
                         headers never appear on round-robin traffic.

  cache_kill9_mid_persist
                         a process SIGKILLed inside the forecast cache's
                         persist window (a child self-arms
                         ``cache.persist=kill9`` before a state install):
                         only meta files with their payload remain, an
                         orphan payload is ignored, a fresh boot adopts the
                         committed frame and serves byte-equal forecasts,
                         and a torn payload is discarded for dispatch.
"""

import http.client
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from distributed_forecasting_tpu_torch.monitoring import failpoints as fp
from distributed_forecasting_tpu_torch.serving.ingest import (
    WriteAheadLog,
    segment_indices,
    segment_path,
)
from distributed_forecasting_tpu_torch.serving.resilience import (
    CLOSED,
    OPEN,
    ResilienceConfig,
)

from test_torch_fleet import _boot, _make_fake_replica

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD_WRITER = r"""
import sys
from distributed_forecasting_tpu_torch.monitoring import failpoints as fp
from distributed_forecasting_tpu_torch.serving.ingest import WriteAheadLog

wal_dir, kill_after = sys.argv[1], int(sys.argv[2])
wal = WriteAheadLog(wal_dir, max_segment_bytes=4096)
batch = 0
while True:
    if batch == kill_after:
        # the NEXT append SIGKILLs this process: no atexit, no flush
        fp.configure("wal.append.enospc=kill9")
    wal.append([{"batch": batch, "fill": "x" * 64}])
    print(f"ACK {batch}", flush=True)  # the append returned: acked
    batch += 1
"""


def wal_kill9_replay(tmp, seed):
    wal_dir = os.path.join(tmp, "wal_kill9")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_WRITER, wal_dir, "25"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT})
    acked = [int(line.split()[1]) for line in proc.stdout.splitlines()
             if line.startswith("ACK ")]
    assert proc.returncode == -9, proc.stderr[-500:]
    assert acked == list(range(25))
    records, _ = WriteAheadLog(wal_dir).read_new()
    replayed = {r["batch"] for r in records if "batch" in r}
    assert set(acked) <= replayed
    live = segment_path(wal_dir, segment_indices(wal_dir)[-1])
    with open(live, "ab") as f:
        f.write(b'{"batch": 999999, "torn": tr')  # no newline
    WriteAheadLog(wal_dir).append([{"batch": 1000000}])  # seals, appends
    records, _ = WriteAheadLog(wal_dir).read_new()
    replayed2 = {r["batch"] for r in records if "batch" in r}
    assert 1000000 in replayed2 and replayed <= replayed2


def wal_enospc(tmp, seed):
    wal = WriteAheadLog(os.path.join(tmp, "wal_enospc"),
                        max_segment_bytes=2048)
    fp.configure("wal.append.enospc=raise OSError:0.3", seed=seed)
    acked, failed = [], []
    for i in range(200):
        try:
            wal.append([{"i": i, "fill": "y" * 32}])
            acked.append(i)
        except OSError:
            failed.append(i)
    fp.deactivate()
    assert failed and acked
    records, _ = WriteAheadLog(os.path.join(tmp, "wal_enospc")).read_new()
    assert {r["i"] for r in records} == set(acked)
    live = segment_path(wal.directory, wal._seg)
    disk = os.path.getsize(live) if os.path.exists(live) else 0
    assert wal._seg_bytes == disk


def aot_corrupt_warm_boot(tmp, seed):
    from distributed_forecasting_tpu_torch.engine import compile_cache as cc

    directory = os.path.join(tmp, "kernels")
    builds = []

    def build():
        builds.append(1)
        out = os.path.join(tmp, f"build-{len(builds)}")
        os.makedirs(out)
        src = os.path.join(out, "lib.cpp")
        with open(src, "w") as f:
            f.write('extern "C" int answer(int x) { return 3 * x + 1; }\n')
        lib = os.path.join(out, "libstub.so")
        subprocess.run(["g++", "-shared", "-fPIC", "-O0", "-o", lib, src],
                       check=True, capture_output=True, timeout=120)
        return lib

    def boot():
        """A fresh store over the directory (a fresh process) loads the
        library; its answers to 64 inputs."""
        lib = cc.AOTStore(directory).get_or_compile(
            "c" * 32, "kernel_library", build)
        return [lib.answer(x) for x in range(64)]

    control = boot()
    assert boot() == control
    assert len(builds) == 1  # the warm boot loaded, no build
    fp.configure("aot.load.payload=corrupt:1", seed=seed)
    s0 = cc.cache_stats()
    errors = cc._entry_requests.snapshot().get(
        "entry=kernel_library,outcome=error", 0)
    recovered = boot()
    s1 = cc.cache_stats()
    assert recovered == control and len(builds) == 2
    assert s1["errors"] == s0["errors"] + 1
    assert fp.fired("aot.load.payload") == 1
    assert cc._entry_requests.snapshot()[
        "entry=kernel_library,outcome=error"] == errors + 1
    fp.deactivate()
    s2 = cc.cache_stats()
    assert boot() == control
    assert cc.cache_stats()["hits"] == s2["hits"] + 1 and len(builds) == 2


_CACHE_CHILD = r"""
import sys

import pandas as pd

from distributed_forecasting_tpu_torch.data import (
    synthetic_store_item_sales,
    tensorize,
)
from distributed_forecasting_tpu_torch.models import ThetaConfig
from distributed_forecasting_tpu_torch.models.base import get_model
from distributed_forecasting_tpu_torch.monitoring import failpoints as fp
from distributed_forecasting_tpu_torch.serving import BatchForecaster
from distributed_forecasting_tpu_torch.serving.forecast_cache import (
    build_forecast_cache,
)

mmap_dir, seed = sys.argv[1], int(sys.argv[2])
df = synthetic_store_item_sales(n_stores=2, n_items=2, n_days=120, seed=seed)
batch = tensorize(df, device="cpu")
cfg = ThetaConfig()
params = get_model("theta").fit(batch.y, batch.mask, batch.day, cfg)
fc = BatchForecaster.from_fit(batch, params, "theta", cfg)
cache = build_forecast_cache({"enabled": True, "mmap_dir": mmap_dir}, fc)
req = pd.DataFrame(fc.keys, columns=fc.key_names)
frame = cache.lookup(req, 14, False, None, "raise", None)
assert frame is not None
# the parent holds its own dispatch to this: the recovery checks rest on a
# predict that is bitwise the same across processes
print("REF " + frame.to_csv(index=False).encode().hex(), flush=True)
print("PERSISTED " + str(int(cache.metrics.persists.value)), flush=True)
# the next persist SIGKILLs this process inside the durable write: after
# the rebuilt frame went live in memory, before its commit record lands
fp.configure("cache.persist=kill9")
fc.swap_state(day1=fc.day1)  # epoch bump -> rebuild -> persist
print("SURVIVED", flush=True)
"""


def _theta_forecaster(seed):
    """The child's forecaster, fitted again in this process."""
    from distributed_forecasting_tpu_torch.data import (
        synthetic_store_item_sales,
        tensorize,
    )
    from distributed_forecasting_tpu_torch.models import ThetaConfig
    from distributed_forecasting_tpu_torch.models.base import get_model
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    df = synthetic_store_item_sales(n_stores=2, n_items=2, n_days=120,
                                    seed=seed)
    batch = tensorize(df, device="cpu")
    cfg = ThetaConfig()
    params = get_model("theta").fit(batch.y, batch.mask, batch.day, cfg)
    return BatchForecaster.from_fit(batch, params, "theta", cfg)


def cache_kill9_mid_persist(tmp, seed):
    import pandas as pd

    from distributed_forecasting_tpu_torch.serving.forecast_cache import (
        build_forecast_cache,
    )

    mmap_dir = os.path.join(tmp, "cache_kill9")
    proc = subprocess.run(
        [sys.executable, "-c", _CACHE_CHILD, mmap_dir, str(seed)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == -9, proc.stderr[-500:]
    assert "SURVIVED" not in proc.stdout, "the kill9 failpoint never fired"
    lines = proc.stdout.splitlines()
    ref_csv = next(bytes.fromhex(line.split()[1]).decode()
                   for line in lines if line.startswith("REF "))
    persists = next(int(line.split()[1])
                    for line in lines if line.startswith("PERSISTED "))
    assert persists >= 1, "the first epoch's persist never landed"
    # meta last: the crash can leave a payload without its meta, never a
    # meta without its payload
    names = set(os.listdir(mmap_dir))
    for name in names:
        if name.endswith(".meta.json"):
            assert name[:-len(".meta.json")] + ".npy" in names, name
    # the other crash shape, by hand: an orphan payload (died between the
    # payload's rename and the meta's write), which the loader ignores
    with open(os.path.join(mmap_dir, "h99.npy"), "wb") as f:
        f.write(b"orphan payload, no commit record")

    fc = _theta_forecaster(seed)
    req = pd.DataFrame(fc.keys, columns=fc.key_names)
    assert fc.predict(req, horizon=14).to_csv(index=False) == ref_csv, (
        "the predict is not bitwise the same across processes: the checks "
        "below would mean nothing")
    # clean recovery: the committed first-epoch frame is adopted (same
    # state, same fingerprint) and serves byte-equal forecasts
    boot = build_forecast_cache({"enabled": True, "mmap_dir": mmap_dir}, fc)
    assert (boot.metrics.loads.value, boot.metrics.load_errors.value) == (
        1, 0)
    got = boot.lookup(req, 14, False, None, "raise", None)
    assert got is not None and got.to_csv(index=False) == ref_csv
    assert boot.metrics.rebuilds.value == 0  # served from the adopted frame
    # torn recovery: one flipped payload byte under a commit record; the
    # digest check discards it and the read falls through to a dispatch
    ppath = os.path.join(mmap_dir, "h14.npy")
    with open(ppath, "rb") as f:
        blob = bytearray(f.read())
    blob[len(blob) // 2] ^= 0xFF
    with open(ppath, "wb") as f:
        f.write(bytes(blob))
    torn = build_forecast_cache({"enabled": True, "mmap_dir": mmap_dir}, fc)
    assert (torn.metrics.loads.value, torn.metrics.load_errors.value) == (
        0, 1)
    assert not os.path.exists(ppath), "the torn payload was not discarded"
    got = torn.lookup(req, 14, False, None, "raise", None)
    if got is None:  # a miss while the inline rebuild's gate was held
        got = fc.predict(req, horizon=14)
    assert got.to_csv(index=False) == ref_csv


def _post(front, headers=None, timeout=10.0):
    conn = http.client.HTTPConnection(*front.server_address, timeout=timeout)
    try:
        conn.request("POST", "/invocations", body=b"{}",
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        out = resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()
    _contract(out[0], out[1], (headers or {}).get("X-Trace-Id"))
    return out


def _get(front, path, headers=None):
    conn = http.client.HTTPConnection(*front.server_address, timeout=10)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        out = resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()
    _contract(out[0], out[1], (headers or {}).get("X-Trace-Id"))
    return out


def _contract(status, headers, trace_id):
    """Every client-visible error the scenarios see: retryable statuses
    carry Retry-After, and a sent X-Trace-Id is echoed."""
    if status in (429, 503):
        assert headers.get("Retry-After"), (status, headers)
    if trace_id is not None and status >= 400:
        assert headers.get("X-Trace-Id") == trace_id, (status, headers)


def slow_replica_brownout(tmp, seed):
    sup, front, procs = _boot(
        poll_s=60.0, delays={0: 0.4}, resilience=ResilienceConfig(
            breaker_failures=2, breaker_slow_s=0.1, breaker_open_s=60.0))
    try:
        statuses = [_post(front) for _ in range(8)]
        assert all(s == 200 for s, _, _ in statuses)
        slow = procs[0].server.server_address[1]
        fast = procs[1].server.server_address[1]
        assert sup.breaker_for(slow).state == OPEN
        assert all(int(h["X-Fleet-Replica"]) == fast
                   for _, h, _ in statuses[-3:])
        assert f'dftpu_fleet_breaker_state{{port="{slow}"}} 1' in \
            sup.render_metrics()
    finally:
        front.shutdown()
        sup.stop()


def breaker_trip_recover(tmp, seed):
    open_s = 1.0
    sup, front, procs = _boot(poll_s=60.0, resilience=ResilienceConfig(
        breaker_failures=1, breaker_open_s=open_s))
    try:
        dead, live = sup.all_ports()
        procs[0].hang_up()
        for _ in range(4):
            assert _post(front)[0] == 200
        assert sup.breaker_for(dead).state == OPEN
        procs[0].server = _make_fake_replica(dead)  # revived, same port
        sup.poll_once()
        assert sup.ready_count() == 2
        t0 = time.monotonic()
        while time.monotonic() < t0 + open_s + 5.0:
            assert _post(front)[0] == 200
            if sup.breaker_for(dead).state == CLOSED:
                break
            time.sleep(0.05)
        assert sup.breaker_for(dead).state == CLOSED
        assert time.monotonic() - t0 < open_s + 5.0
        ports = {int(_post(front)[1]["X-Fleet-Replica"]) for _ in range(6)}
        assert ports == {dead, live}
    finally:
        front.shutdown()
        sup.stop()


def keepalive_kill9_mid_stream(tmp, seed):
    sup, front, procs = _boot(poll_s=60.0)
    conn = http.client.HTTPConnection(*front.server_address, timeout=10)
    try:
        def stream_one():
            conn.request("POST", "/invocations", body=b"{}",
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            assert not resp.will_close
            return resp.status, json.loads(body).get("port")

        got = [stream_one() for _ in range(8)]
        assert int(sup.pool.reused.value) > 0
        assert {p for _, p in got} == set(sup.all_ports())
        dead = procs[0].server.server_address[1]
        procs[0].kill()
        got += [stream_one() for _ in range(8)]
        assert all(s == 200 for s, _ in got)
        live = next(p for p in sup.all_ports() if p != dead)
        assert all(p == live for _, p in got[-4:])
        assert int(sup.pool.evicted.value) > 0
    finally:
        conn.close()
        front.shutdown()
        sup.stop()


def error_contract_headers(tmp, seed):
    tid = f"chaos-contract-{seed}"
    sup, front, procs = _boot(replicas=1, poll_s=60.0)
    try:
        status, headers, _ = _get(front, "/readyz", {"X-Trace-Id": tid})
        assert status == 200 and headers.get("X-Trace-Id") == tid
        assert headers.get("Retry-After") is None
        status, headers, _ = _post(front, {"X-Trace-Id": tid})
        assert status == 200
        assert "X-Fleet-Shard" not in headers
        assert "X-Fleet-Scatter" not in headers
        procs[0].hang_up()
        sup.poll_once()
        assert _get(front, "/readyz", {"X-Trace-Id": tid})[0] == 503
        status, _, body = _post(front, {"X-Trace-Id": tid,
                                        "X-Deadline-Ms": "250"})
        assert status == 503 and b"deadline" in body
    finally:
        front.shutdown()
        sup.stop()


SCENARIOS = {
    "wal_kill9_replay": wal_kill9_replay,
    "wal_enospc": wal_enospc,
    "aot_corrupt_warm_boot": aot_corrupt_warm_boot,
    "slow_replica_brownout": slow_replica_brownout,
    "breaker_trip_recover": breaker_trip_recover,
    "keepalive_kill9_mid_stream": keepalive_kill9_mid_stream,
    "error_contract_headers": error_contract_headers,
    "cache_kill9_mid_persist": cache_kill9_mid_persist,
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_chaos_invariant_holds(scenario, tmp_path):
    fp.deactivate()
    try:
        SCENARIOS[scenario](str(tmp_path), seed=0)
    finally:
        fp.deactivate()
