"""The port's degradation layer (``serving/resilience.py``) and its fleet
integration.

Parity with the reference, exact: ``ResilienceConfig`` parses and refuses
what the reference's does, ``parse_deadline_header`` and
``remaining_ms`` agree on the same inputs, and one scripted sequence of
calls under one scripted clock walks both packages' breakers through the
same states and answers.  Then the reference's own cases on the port:
the breaker in simulated time, the latency reservoir, the supervisor's
leg timeout and hedge delay, and the front door over in-process fake
replicas (breaker ejection and its gauge, the deadline shed, the budget
forwarded downstream, the hedged scatter leg).  The port's scorer sheds
an exhausted ``X-Deadline-Ms`` as the reference's does.
"""

import http.client
import json
import time

import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.serving import resilience as jres
from distributed_forecasting_tpu_torch.serving import resilience as tres
from distributed_forecasting_tpu_torch.serving.fleet import (
    FleetConfig,
    FleetSupervisor,
)
from distributed_forecasting_tpu_torch.serving.resilience import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
    LatencyReservoir,
    ResilienceConfig,
    deadline_from_headers,
    parse_deadline_header,
    remaining_ms,
    state_name,
)

from test_torch_fleet import _boot, _front_call

torch.set_num_threads(1)


# -- parity ---------------------------------------------------------------------

CONFS = [None, {}, {"breaker_failures": "3", "breaker_open_s": "2.5",
                    "default_deadline_ms": 800, "hedge_enabled": True},
         {"failpoints": "fleet.forward=raise:0.1", "failpoint_seed": 4},
         {"breaker_failues": 3}, {"default_deadline_ms": -1},
         {"min_leg_timeout_ms": 0}, {"breaker_open_s": 0},
         {"hedge_delay_ms": -1}, {"hedge_min_delay_ms": 0}]


@pytest.mark.parametrize("conf", CONFS)
def test_config_matches_the_reference(conf):
    def parse(mod):
        try:
            return mod.ResilienceConfig.from_conf(conf).__dict__
        except ValueError as e:
            return str(e)
    assert parse(tres) == parse(jres)


@pytest.mark.parametrize("raw", [None, "", "  ", "not-a-number", " 250.5 ",
                                 "0", "-3", "1e3", "nan", "inf"])
def test_parse_deadline_header_matches_the_reference(raw):
    got, want = tres.parse_deadline_header(raw), \
        jres.parse_deadline_header(raw)
    assert (got == want) or (got != got and want != want)  # nan == nan


def test_remaining_ms_matches_the_reference(monkeypatch):
    now = [1000.0]
    for mod in (tres, jres):
        monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    for deadline in (None, 999.0, 1000.0, 1000.25, 1300.0):
        assert tres.remaining_ms(deadline) == jres.remaining_ms(deadline)
    headers = {"X-Deadline-Ms": "500"}
    for default in (0.0, 800.0):
        assert tres.deadline_from_headers(headers, default) == \
            jres.deadline_from_headers(headers, default)
        assert tres.deadline_from_headers({}, default) == \
            jres.deadline_from_headers({}, default)


def test_breaker_walk_matches_the_reference():
    """One seeded script of allow / success / slow success / failure calls
    and clock steps, on both packages' breakers."""
    rng = np.random.default_rng(11)
    script = [(["allow", "ok", "slow", "fail", "tick"][int(i)],
               float(t)) for i, t in zip(rng.integers(0, 5, 400),
                                         rng.uniform(0.0, 2.0, 400))]

    def walk(mod):
        clock = [0.0]
        br = mod.CircuitBreaker(failures=3, open_s=1.5, slow_s=0.2,
                                time_fn=lambda: clock[0])
        trace = []
        for op, t in script:
            if op == "allow":
                trace.append(br.allow())
            elif op == "ok":
                br.record_success(elapsed_s=0.01)
            elif op == "slow":
                br.record_success(elapsed_s=0.5)
            elif op == "fail":
                br.record_failure()
            else:
                clock[0] += t
            trace.append(br.state)
        return trace

    got = walk(tres)
    assert got == walk(jres)
    assert {CLOSED, OPEN, HALF_OPEN} <= set(got)


# -- the breaker, the reservoir, the deadline helpers ----------------------------

def test_breaker_full_cycle_in_simulated_time():
    clock = [0.0]
    br = CircuitBreaker(failures=2, open_s=5.0, time_fn=lambda: clock[0])
    assert br.state == CLOSED and br.allow()
    br.record_failure()
    assert br.state == CLOSED
    br.record_failure()
    assert br.state == OPEN and not br.allow()
    clock[0] = 5.1
    assert br.allow() and br.state == HALF_OPEN
    assert not br.allow()  # one probe at a time
    br.record_failure()  # the probe failed: open again, timer restarted
    clock[0] = 9.0
    assert not br.allow()
    clock[0] = 10.2
    assert br.allow()
    br.record_success(elapsed_s=0.01)
    assert br.state == CLOSED
    slow = CircuitBreaker(failures=1, open_s=5.0, slow_s=0.1,
                          time_fn=lambda: 0.0)
    slow.record_success(elapsed_s=0.5)
    assert slow.state == OPEN
    with pytest.raises(ValueError):
        CircuitBreaker(failures=0, open_s=5.0)
    assert [state_name(s) for s in (CLOSED, OPEN, HALF_OPEN, 99)] == [
        "closed", "open", "half_open", "unknown"]


def test_reservoir_p95_and_ring_overwrite():
    res = LatencyReservoir(capacity=100)
    assert res.p95() is None
    for i in range(100):
        res.observe(i / 1000.0)
    assert res.p95() == pytest.approx(0.095)
    for _ in range(100):
        res.observe(0.001)
    assert res.p95() == pytest.approx(0.001)


def test_deadline_helpers():
    assert parse_deadline_header("garbage") is None
    now = time.monotonic()
    d = deadline_from_headers({"X-Deadline-Ms": "500"}, default_ms=60000)
    assert now + 0.3 < d < now + 0.7
    assert deadline_from_headers({}, default_ms=60000) > now + 50
    assert deadline_from_headers({}, default_ms=0) is None
    assert remaining_ms(None) is None
    assert remaining_ms(time.monotonic() - 1.0) < 0


def _bare_supervisor(resilience=None, request_timeout_s=None):
    return FleetSupervisor(FleetConfig(enabled=True, replicas=2),
                           lambda i, p: None, resilience=resilience,
                           request_timeout_s=request_timeout_s)


def test_leg_timeout_hedge_delay_and_lazy_breakers():
    sup = _bare_supervisor(request_timeout_s=30.0)
    assert sup.leg_timeout_s(None) == pytest.approx(35.0)
    assert 1.5 < sup.leg_timeout_s(time.monotonic() + 2.0) < 2.1
    assert sup.leg_timeout_s(time.monotonic() - 1.0) == pytest.approx(
        0.05, abs=0.01)
    sup = _bare_supervisor(ResilienceConfig(hedge_enabled=True,
                                            hedge_delay_ms=75.0))
    assert sup.hedge_delay_s() == pytest.approx(0.075)
    sup = _bare_supervisor(ResilienceConfig(hedge_enabled=True))
    assert sup.hedge_delay_s() == pytest.approx(0.010)
    for _ in range(50):
        sup.leg_latency.observe(0.2)
    assert sup.hedge_delay_s() == pytest.approx(0.2)
    assert sup.breaker_for(1234) is None and sup.breaker_allow(1234)
    sup = _bare_supervisor(ResilienceConfig(breaker_failures=2))
    assert sup.breaker_for(1234) is sup.breaker_for(1234) is not None


# -- the front door over fakes -------------------------------------------------

def test_breaker_trips_on_a_hung_replica_and_exports_state():
    sup, front, procs = _boot(poll_s=60.0, resilience=ResilienceConfig(
        breaker_failures=1, breaker_open_s=60.0))
    try:
        procs[0].hang_up()
        dead, live = sup.all_ports()
        for _ in range(4):
            status, headers, _ = _front_call(front)
            assert status == 200 and int(headers["X-Fleet-Replica"]) == live
        assert sup.breaker_for(dead).state == OPEN
        metrics = sup.render_metrics()
        assert f'dftpu_fleet_breaker_state{{port="{dead}"}} 1' in metrics
        assert f'dftpu_fleet_breaker_state{{port="{live}"}} 0' in metrics
        # an open breaker ejects a port that still answers
        sup.breaker_failure(live)
        assert "dftpu_fleet_breaker_skipped_total" in sup.render_metrics()
    finally:
        front.shutdown()
        sup.stop()


def _record_deadlines(procs):
    seen = []
    for proc in procs.values():
        cls = proc.server.RequestHandlerClass
        orig = cls.do_POST

        def do_POST(handler, _orig=orig):
            seen.append(handler.headers.get("X-Deadline-Ms"))
            _orig(handler)

        cls.do_POST = do_POST
    return seen


def test_deadline_shed_and_the_budget_forwarded_downstream():
    sup, front, procs = _boot(poll_s=60.0)
    try:
        seen = _record_deadlines(procs)
        status, headers, body = _front_call(
            front, headers={"X-Deadline-Ms": "0"})
        assert status == 503 and b"deadline" in body
        assert headers.get("Retry-After") == "1"
        assert seen == []  # no replica saw it
        assert "dftpu_fleet_deadline_exhausted_total 1" in \
            sup.render_metrics()
        assert _front_call(front)[0] == 200
        assert seen == [None]
        assert _front_call(front, headers={"X-Deadline-Ms": "5000"})[0] == 200
        assert 0 < int(seen[1]) <= 5000
    finally:
        front.shutdown()
        sup.stop()
    sup, front, procs = _boot(poll_s=60.0, resilience=ResilienceConfig(
        default_deadline_ms=5000.0))
    try:
        seen = _record_deadlines(procs)
        assert _front_call(front)[0] == 200
        assert 0 < int(seen[0]) <= 5000
    finally:
        front.shutdown()
        sup.stop()


def test_hedged_scatter_leg_wins_over_a_slow_owner():
    from distributed_forecasting_tpu_torch.serving.sharding import (
        ShardingConfig,
    )

    cfg = FleetConfig(enabled=True, replicas=2, health_poll_interval_s=60.0,
                      restart_backoff_s=0.05, drain_timeout_s=1.0,
                      retry_window_s=3.0)
    from test_torch_fleet import _FakeProc, _make_fake_replica
    from distributed_forecasting_tpu_torch.serving.fleet import start_fleet

    procs = {}

    def spawn(index, port, shards):
        procs[index] = _FakeProc(_make_fake_replica(
            port, delay_s=0.5 if index == 0 else 0.0))
        return procs[index]

    sup, front = start_fleet(
        cfg, spawn_fn=spawn, wait=False, key_names=("store", "item"),
        sharding=ShardingConfig(enabled=True, num_shards=4, replication=2),
        resilience=ResilienceConfig(hedge_enabled=True, hedge_delay_ms=50))
    sup.poll_once()
    try:
        inputs = [{"store": 1, "item": i} for i in range(1, 9)]
        t0 = time.monotonic()
        status, headers, _ = _front_call(
            front, body=json.dumps({"inputs": inputs}).encode())
        assert status == 200 and int(headers["X-Fleet-Scatter"]) > 1
        metrics = sup.render_metrics()
        assert "dftpu_fleet_hedges_total" in metrics
        hedges = int(sup._c_hedges.value)
        assert hedges >= 1 and int(sup._c_hedge_wins.value) >= 1
        assert time.monotonic() - t0 < 0.5 + 0.45  # no leg waited it out
    finally:
        front.shutdown()
        sup.stop()


def test_the_port_scorer_sheds_an_exhausted_budget():
    from distributed_forecasting_tpu_torch.serving.server import start_server
    from test_torch_fleet import _tiny_hw

    _, fc = _tiny_hw()
    srv = start_server(fc)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=30)
        conn.request("POST", "/invocations", body=b"{}",
                     headers={"X-Deadline-Ms": "-5"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 503 and resp.getheader("Retry-After") == "1"
        assert body == {"error": "deadline budget exhausted before dispatch"}
    finally:
        srv.shutdown()
        srv.server_close()
