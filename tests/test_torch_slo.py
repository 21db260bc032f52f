"""Port parity: the SLO evaluator (``monitoring/slo.py``).

- The shipped ``monitoring.slo`` block of ``conf/tasks/serve_config.yml``
  parses to equal configs in both packages; bad blocks and rules raise the
  reference's errors with its messages.
- ``latest_run_timestamp`` agrees on one tracking root written by the port's
  ``FileTracker`` (finished runs, a run still in flight, a corrupt meta).
- ``evaluate_once`` over a sequence of injected ``now``s, with each
  package's serving latency histogram fed the same observations and the same
  injected coverage and staleness functions, returns equal state dicts and
  renders equal ``dftpu_slo_*`` text at every tick, and leaves equal store
  rows.  The sequence covers: no traffic (nothing burns), good ticks, a
  latency breach that fires only once every window burns, hysteresis (the
  long window still burns, the short one recovered: cleared), and a coverage
  rule that raises on some ticks, counted in ``evaluation_errors`` while the
  other rules proceed.

No test waits on an interval: ``now`` is passed to every call.
"""

import json
import os

import pytest
import torch
import yaml

from distributed_forecasting_tpu.monitoring import slo as jslo
from distributed_forecasting_tpu.monitoring import store as jstore
from distributed_forecasting_tpu.serving import batcher as jbatcher
from distributed_forecasting_tpu_torch.monitoring import slo as tslo
from distributed_forecasting_tpu_torch.monitoring import store as tstore
from distributed_forecasting_tpu_torch.serving import batcher as tbatcher
from distributed_forecasting_tpu_torch.tracking import FileTracker

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0


def _shipped_block():
    with open(os.path.join(ROOT, "conf", "tasks", "serve_config.yml")) as f:
        return yaml.safe_load(f)["monitoring"]["slo"]


def _fields(cfg):
    return [(f, getattr(cfg, f)) for f in cfg.__dataclass_fields__]


@pytest.mark.parametrize("conf", ["shipped", None, {}, {"enabled": True},
                                  {"enabled": 1, "evaluation_interval_s": "5",
                                   "error_budget": 1, "windows": [[60, 3]],
                                   "rules": [{"name": "q", "kind":
                                              "latency_quantile",
                                              "objective": 0.2,
                                              "quantile": 0.5}]}])
def test_slo_config_parses_like_the_reference(conf):
    conf = _shipped_block() if conf == "shipped" else conf
    got, want = tslo.SLOConfig.from_conf(conf), jslo.SLOConfig.from_conf(conf)
    # the rules are each package's own SLORule: compared field by field
    assert ([kv for kv in _fields(got) if kv[0] != "rules"]
            == [kv for kv in _fields(want) if kv[0] != "rules"])
    assert [_fields(r) for r in got.rules] == [_fields(r) for r in want.rules]
    assert got.short_window == want.short_window


BAD = {
    "unknown_key": {"windowz": []},
    "interval": {"evaluation_interval_s": 0},
    "budget_zero": {"error_budget": 0},
    "budget_big": {"error_budget": 1.5},
    "no_windows": {"windows": []},
    "window_negative": {"windows": [[-1, 2.0]]},
    "windows_not_list": {"windows": 5},
    "rules_not_list": {"rules": {"name": "x"}},
    "duplicate_rules": {"rules": [{"name": "a", "kind": "staleness",
                                   "objective": 1},
                                  {"name": "a", "kind": "staleness",
                                   "objective": 2}]},
    "rule_unknown_key": {"rules": [{"name": "a", "kind": "staleness",
                                    "objectiv": 1}]},
    "rule_no_name": {"rules": [{"name": "", "kind": "staleness",
                                "objective": 1}]},
    "rule_kind": {"rules": [{"name": "a", "kind": "uptime"}]},
    "rule_objective": {"rules": [{"name": "a", "kind": "latency_quantile"}]},
    "rule_quantile": {"rules": [{"name": "a", "kind": "latency_quantile",
                                 "objective": 1, "quantile": 1.0}]},
    "rule_tolerance": {"rules": [{"name": "a", "kind": "coverage",
                                  "tolerance": 0}]},
}


@pytest.mark.parametrize("case", list(BAD))
def test_bad_slo_blocks_raise_like_the_reference(case):
    with pytest.raises(ValueError) as got:
        tslo.SLOConfig.from_conf(BAD[case])
    with pytest.raises(ValueError) as want:
        jslo.SLOConfig.from_conf(BAD[case])
    assert str(got.value) == str(want.value)


def test_latest_run_timestamp_agrees_on_the_ports_tracking_root(tmp_path):
    root = str(tmp_path / "tracking")
    assert tslo.latest_run_timestamp(root) is None
    assert jslo.latest_run_timestamp(root) is None
    tracker = FileTracker(root)
    eid = tracker.create_experiment("e")
    run = tracker.start_run(eid, run_name="done")
    run.end()
    tracker.log_runs_batch(eid, [{"run_name": "a"}, {"run_name": "b"}])
    assert (tslo.latest_run_timestamp(root)
            == jslo.latest_run_timestamp(root) is not None)
    # a run still in flight counts by its start_time; a corrupt meta is
    # skipped
    other = tracker.create_experiment("f")
    live = tracker.start_run(other, run_name="live")
    meta = os.path.join(root, "experiments", other, "runs", live.run_id,
                        "meta.json")
    with open(meta) as f:
        stamp = json.load(f)["start_time"]
    broken = tracker.start_run(other, run_name="broken")
    with open(os.path.join(root, "experiments", other, "runs",
                           broken.run_id, "meta.json"), "w") as f:
        f.write("{not json")
    got = tslo.latest_run_timestamp(root)
    assert got == jslo.latest_run_timestamp(root) >= stamp


SLO_CONF = {
    "enabled": True, "evaluation_interval_s": 30, "error_budget": 0.25,
    "windows": [[90, 2.0], [300, 1.0]],
    "rules": [
        {"name": "predict_latency_p95", "kind": "latency_quantile",
         "quantile": 0.95, "objective": 0.05},
        {"name": "calibration_coverage", "kind": "coverage",
         "tolerance": 0.05},
        {"name": "model_staleness", "kind": "staleness", "objective": 600},
    ],
}

# (tick, latency observations before it, coverage, coverage raises)
SCRIPT = (
    [(0, [], float("nan"), False)]                  # silence: nothing burns
    + [(k, [0.004] * 20, 0.94, False) for k in range(1, 5)]   # good
    + [(k, [0.3] * 60, 0.80, False) for k in range(5, 11)]    # breach
    + [(11, [0.002] * 10000, 0.95, False)]          # p95 recovers
    + [(k, [0.002] * 50, 0.95, k in (12, 13)) for k in range(12, 30)]
)


def _evaluator(slo, store_mod, batcher, directory, calls, conf=SLO_CONF):
    metrics = batcher.ServingMetrics()
    cov = {"v": float("nan"), "raise": False}

    def coverage():
        calls.append("coverage")
        if cov["raise"]:
            raise RuntimeError("coverage source failed")
        return cov["v"]

    ev = slo.SLOEvaluator(
        slo.SLOConfig.from_conf(conf),
        store_mod.TimeSeriesStore(directory),
        coverage_fn=coverage, nominal_fn=lambda: 0.95,
        staleness_fn=lambda: T0 - 400.0)
    ev.bind_latency(metrics.latency)
    return ev, metrics, cov


def test_evaluate_once_sequences_match_the_reference(tmp_path):
    calls = {"ref": [], "port": []}
    sides = {
        "ref": _evaluator(jslo, jstore, jbatcher, str(tmp_path / "ref"),
                          calls["ref"]),
        "port": _evaluator(tslo, tstore, tbatcher, str(tmp_path / "port"),
                           calls["port"]),
    }
    seen = {"fired": False, "cleared_with_long_burning": False,
            "errors": 0}
    for tick, lat, cov, raises in SCRIPT:
        now = T0 + 30.0 * tick
        states = {}
        for side, (ev, metrics, c) in sides.items():
            for v in lat:
                metrics.latency.observe(v)
            c["v"], c["raise"] = cov, raises
            states[side] = ev.evaluate_once(now=now)
        assert states["port"] == states["ref"], tick
        text = {s: ev.registry.render_prometheus() for s, (ev, _, _) in
                sides.items()}
        assert text["port"] == text["ref"], tick
        snap = {s: ev.snapshot() for s, (ev, _, _) in sides.items()}
        assert snap["port"] == snap["ref"], tick
        rules = {r["name"]: r for r in states["port"]["rules"]}
        if raises:
            assert "calibration_coverage" not in rules
            assert set(rules) == {"predict_latency_p95", "model_staleness"}
        lat_rule = rules["predict_latency_p95"]
        if tick == 0:
            assert lat_rule["bad"] is None and not lat_rule["firing"]
            assert rules["calibration_coverage"]["sli"] is None
        burns = lat_rule["burn_rates"]
        if lat_rule["firing"]:
            seen["fired"] = True
        elif seen["fired"] and burns["300s"] > 1.0:
            seen["cleared_with_long_burning"] = True
        seen["errors"] = sides["port"][0].evaluation_errors.value
    assert seen["fired"] and seen["cleared_with_long_burning"]
    assert seen["errors"] == 2
    assert sides["port"][0].evaluations.value == len(SCRIPT)
    assert calls["port"] == calls["ref"]
    for name in ("dftpu_slo_bad", "dftpu_slo_sli"):
        assert (sides["port"][0].store.query(name=name)
                == sides["ref"][0].store.query(name=name))
    assert "dftpu_slo_firing" in text["port"]


def test_firing_needs_every_window_to_burn(tmp_path):
    """Bad ticks after twenty good ones burn the 90 s window past its
    threshold at once, but the rule fires only when the 600 s window burns
    too (more than a quarter of its 21 samples bad)."""
    conf = dict(SLO_CONF, windows=[[90, 2.0], [600, 1.0]])
    ev, metrics, cov = _evaluator(tslo, tstore, tbatcher, str(tmp_path), [],
                                  conf=conf)
    cov["v"] = 0.95
    for k in range(20):
        metrics.latency.observe(0.001)
        ev.evaluate_once(now=T0 + 30.0 * k)
    for v in [0.4] * 1000:
        metrics.latency.observe(v)
    firing = []
    for k in range(20, 28):
        state = ev.evaluate_once(now=T0 + 30.0 * k)
        rule = next(r for r in state["rules"]
                    if r["name"] == "predict_latency_p95")
        assert rule["bad"] is True
        firing.append((rule["burn_rates"]["90s"] > 2.0,
                       rule["burn_rates"]["600s"] > 1.0, rule["firing"]))
    assert firing[2] == (True, False, False)
    assert all(f[2] == (f[0] and f[1]) for f in firing)
    assert firing[-1] == (True, True, True)


def test_evaluator_thread_starts_once_and_stop_joins_it(tmp_path):
    conf = dict(SLO_CONF, evaluation_interval_s=3600)
    ev = tslo.SLOEvaluator(tslo.SLOConfig.from_conf(conf),
                           tstore.TimeSeriesStore(str(tmp_path)))
    ev.start()
    thread = ev._thread
    assert thread.is_alive() and thread.daemon
    ev.start()
    assert ev._thread is thread
    ev.stop()
    assert not thread.is_alive() and ev._thread is None
    assert ev.evaluations.value == 0  # no tick inside an hour's wait
