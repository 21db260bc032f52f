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

The reference's ``cache_kill9_mid_persist`` waits for the port's forecast
cache (ROADMAP Queue 1: P12, second half).
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
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_chaos_invariant_holds(scenario, tmp_path):
    fp.deactivate()
    try:
        SCENARIOS[scenario](str(tmp_path), seed=0)
    finally:
        fp.deactivate()
