"""The port's cost registry (``monitoring/cost.py``) against the reference's.

The same recorded calls — program costs, dispatches, padding — give the
reference's ``cost_table`` and ``snapshot`` (watermarks aside: each reads
its own process's memory at its own moment) and the same counter and gauge
families.  The reference's unit cases run on the port: the saturation
gauge, the thread-local attribution scope, the roofline placement, rows
with dispatches only.  The port's own part: each kernel wrapper publishes
its ``*_work`` count as the program cost of (kernel, shape) the first time
it runs at that shape — on the CPU through the plain twin, the function
whose work the count describes.
"""

import threading

import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.monitoring import cost as jcost
from distributed_forecasting_tpu_torch.monitoring import cost as tcost

torch.set_num_threads(1)


@pytest.fixture
def fresh_cost():
    """Isolate the process-wide cost singleton and active config."""
    with tcost._state_lock:
        prev = tcost._cost_metrics, tcost._active_config
        tcost._cost_metrics, tcost._active_config = None, None
    yield
    with tcost._state_lock:
        tcost._cost_metrics, tcost._active_config = prev


def _record_same_calls(cm):
    cm.record_program("fit_forecast:prophet",
                      {"flops": 1e9, "bytes_accessed": 1e8,
                       "peak_bytes": 5e6}, key="abcd1234")
    cm.record_program("hw_score", {"flops": 3.5e9, "bytes_accessed": 7.4e6},
                      key="500x1826:C96:m7")
    cm.record_program("hw_score", {"flops": 1.2e10, "bytes_accessed": 2e7},
                      key="1500x1826:C96:m7")
    for dt in (0.01, 0.013):
        cm.record_dispatch("fit_forecast:prophet", "prophet", dt)
    cm.record_dispatch("hw_score", "holt_winters", 0.0004)
    cm.record_dispatch("pipeline.dispatch", "finegrain_forecasting", 0.2)
    cm.record_padding("serving_predict:prophet", 64, 47)
    cm.record_padding("serving_predict:prophet", 1, 0)


def _drop_watermarks(snap):
    return {k: v for k, v in snap.items() if k != "watermarks"}


@pytest.mark.parametrize("peaks", [(0.0, 0.0), (1e12, 1e11), (6.7e13, 3.35e12)],
                         ids=["no_peaks", "ridge10", "h100"])
def test_cost_table_and_snapshot_equal_the_reference(peaks):
    got, want = tcost.CostMetrics(), jcost.CostMetrics()
    _record_same_calls(got)
    _record_same_calls(want)
    gcfg = tcost.CostConfig(peak_flops=peaks[0], peak_bytes_per_s=peaks[1])
    wcfg = jcost.CostConfig(peak_flops=peaks[0], peak_bytes_per_s=peaks[1])
    assert got.cost_table(gcfg) == want.cost_table(wcfg)
    g, w = got.snapshot(gcfg), want.snapshot(wcfg)
    # saturation is seconds over each registry's own (young) age
    assert g.pop("device_saturation") > 0 and w.pop("device_saturation") > 0
    assert _drop_watermarks(g) == _drop_watermarks(w)
    assert set(g["watermarks"]) == set(w["watermarks"])
    for name in ("device_seconds_total", "dispatches_total",
                 "padding_rows_total", "padding_waste"):
        assert (getattr(got, name).snapshot()
                == getattr(want, name).snapshot()), name
    for field in tcost.PROGRAM_FIELDS:
        assert (got.program[field].snapshot()
                == want.program[field].snapshot()), field


def test_families_equal_the_reference():
    """The exposition's HELP / TYPE lines are the reference's: the scorer's
    /metrics appends this registry as the reference's does."""
    def heads(cm):
        return [line for line in cm.registry.render_prometheus().splitlines()
                if line.startswith("#")]

    assert heads(tcost.CostMetrics()) == heads(jcost.CostMetrics())
    assert tcost.PROGRAM_FIELDS == jcost.PROGRAM_FIELDS


@pytest.mark.parametrize("conf", [
    {"peak_flop": 1.0}, {"saturation_window_s": 0}, {"peak_flops": -1},
    {"peak_bytes_per_s": -2.0}, {"saturation_window_s": -5},
], ids=["key", "window0", "flops_neg", "bytes_neg", "window_neg"])
def test_cost_config_refuses_what_the_reference_refuses(conf):
    with pytest.raises(ValueError) as want:
        jcost.CostConfig.from_conf(conf)
    with pytest.raises(ValueError) as got:
        tcost.CostConfig.from_conf(conf)
    assert str(got.value) == str(want.value)


def test_cost_config_strict():
    cfg = tcost.CostConfig.from_conf(None)
    assert cfg.enabled and cfg.ridge_intensity == 0.0
    cfg = tcost.CostConfig.from_conf(
        {"enabled": True, "peak_flops": 197e12, "peak_bytes_per_s": 819e9})
    assert cfg.ridge_intensity == pytest.approx(197e12 / 819e9)


def test_record_dispatch_counters_and_saturation():
    cm = tcost.CostMetrics()
    for _ in range(3):
        cm.record_dispatch("fit_forecast:theta", "theta", 0.05)
    label = "entry=fit_forecast:theta,family=theta"
    assert cm.device_seconds_total.snapshot()[label] == pytest.approx(0.15)
    assert cm.dispatches_total.snapshot()[label] == 3.0
    assert cm.device_saturation.value > 0
    # negative intervals (clock skew) clip to zero, never subtract
    cm.record_dispatch("fit_forecast:theta", "theta", -1.0)
    assert cm.device_seconds_total.snapshot()[label] == pytest.approx(0.15)


def test_attribution_scope_is_thread_local():
    cm = tcost.CostMetrics()
    with cm.attribution() as acc:
        cm.record_dispatch("e", "f", 0.01)
        t = threading.Thread(
            target=lambda: cm.record_dispatch("e", "f", 5.0))
        t.start()
        t.join(10)
        # a nested call's charge: counted, not twice against the scope
        cm.record_dispatch("cv:theta", "theta", 0.3, attribute=False)
    assert acc["dispatches"] == 1
    assert acc["device_seconds"] == pytest.approx(0.01)
    assert cm.device_seconds_total.snapshot()["entry=e,family=f"] == \
        pytest.approx(5.01)
    assert cm.dispatches_total.snapshot()[
        "entry=cv:theta,family=theta"] == 1.0
    cm.record_dispatch("e", "f", 0.02)  # outside: no scope accumulates
    assert acc["dispatches"] == 1


def test_cost_table_joins_registry_with_attribution():
    cm = tcost.CostMetrics()
    cm.record_program("fit_forecast:prophet",
                      {"flops": 1e9, "bytes_accessed": 1e8,
                       "peak_bytes": 5e6}, key="abcd1234")
    cm.record_dispatch("fit_forecast:prophet", "prophet", 0.01)
    cm.record_dispatch("fit_forecast:prophet", "prophet", 0.01)
    (row,) = cm.cost_table(tcost.CostConfig(peak_flops=1e12,
                                            peak_bytes_per_s=1e11))
    assert row["entry"] == "fit_forecast:prophet" and row["key"] == "abcd1234"
    assert row["dispatches"] == 2.0
    assert row["operational_intensity"] == pytest.approx(10.0)
    assert row["bound"] == "compute"
    assert row["attainable_flops_per_s"] == pytest.approx(1e12)
    assert row["achieved_flops_per_s"] == pytest.approx(1e11)
    assert row["fraction_of_attainable"] == pytest.approx(0.1)


def test_cost_table_attribution_only_entries_get_rows():
    cm = tcost.CostMetrics()
    cm.record_dispatch("pipeline.dispatch", "theta", 0.2)
    rows = cm.cost_table(tcost.CostConfig())
    assert [r["entry"] for r in rows] == ["pipeline.dispatch"]
    assert rows[0]["device_seconds"] == pytest.approx(0.2)
    assert "flops" not in rows[0] and "bound" not in rows[0]


def test_watermarks_sampled_into_gauges():
    cm = tcost.CostMetrics()
    cm.sample_watermarks()
    assert cm.host_rss_bytes.value > 0
    assert cm.host_rss_peak_bytes.value >= cm.host_rss_bytes.value
    # no card in use here: the device gauges stay 0
    assert cm.device_bytes.value == 0.0


def test_configure_cost_sets_the_window(fresh_cost):
    cm = tcost.configure_cost(tcost.CostConfig(saturation_window_s=5.0))
    assert cm is tcost.cost_metrics()
    assert cm.saturation_window_s == 5.0
    assert tcost.get_cost_config().saturation_window_s == 5.0


def test_record_work_publishes_a_count_once_per_key():
    cm = tcost.CostMetrics()
    calls = []

    def work():
        calls.append(1)
        return (1000, 400)

    for _ in range(3):
        cm.record_work("k", "2x3", work)
    cm.record_work("k", "4x3", lambda: (2000, 800))
    assert len(calls) == 1
    snap = cm.program["flops"].snapshot()
    assert snap == {"entry=k,key=2x3": 1000.0, "entry=k,key=4x3": 2000.0}
    assert cm.program["bytes_accessed"].snapshot()["entry=k,key=2x3"] == 400.0
    assert tcost.work_costs((5, 6)) == {"flops": 5.0, "bytes_accessed": 6.0}


def _program(cm, entry):
    out = {}
    for field in ("flops", "bytes_accessed"):
        for label, v in cm.program[field].snapshot().items():
            e, key = (part.partition("=")[2] for part in label.split(","))
            if e == entry:
                out.setdefault(key, {})[field] = v
    return out


def test_kernel_wrappers_publish_their_work_counts(fresh_cost):
    """Every wrapper of the kernel library (and the curve model's Gram and
    solve) records its count at its shape: the registry and PERF.md's
    bounds read one count."""
    from distributed_forecasting_tpu_torch.ops import fused_scan as fs
    from distributed_forecasting_tpu_torch.ops import kalman as kal
    from distributed_forecasting_tpu_torch.ops import solve

    rng = np.random.default_rng(0)
    S, T, C, m = 3, 40, 4, 7
    y = torch.as_tensor(rng.normal(10, 1, (S, T)), dtype=torch.float32)
    mask = torch.as_tensor(rng.random((S, T)) > 0.2, dtype=torch.float32)
    grid = [torch.full((C,), v) for v in (0.3, 0.1, 0.2, 0.98)]
    fs.hw_score(y, mask, *grid, m)
    rows = [torch.full((S,), v) for v in (0.3, 0.1, 0.2, 0.98)]
    fs.hw_filter(y, mask, *rows, m, "additive")
    r = 3
    phi = torch.full((S, 2), 0.2)
    theta = torch.full((S, 1), 0.1)
    out = kal.arima_filter(y - 10, mask, y, mask, phi, theta,
                           torch.zeros(S), r, 1)
    kal.arima_predict(phi, theta, out.a_T, out.P_T, torch.ones(S), r, 9)
    X = torch.as_tensor(rng.normal(0, 1, (T, 5)), dtype=torch.float32)
    G = solve.masked_gram(X, mask)
    solve.batched_cho_solve(G + 10 * torch.eye(5), torch.ones(S, 5))
    cm = tcost.cost_metrics()
    want = {
        "hw_score": {f"{S}x{T}:C{C}:m{m}": fs.hw_score_work(mask, C, m)},
        "hw_filter": {f"{S}x{T}:m{m}:additive": fs.hw_filter_work(S, T, m)},
        "arima_filter": {f"{S}x{T}:r{r}:d1": kal.arima_filter_work(S, T, r,
                                                                   1)},
        "arima_predict": {f"{S}x9:r{r}": kal.arima_predict_work(S, 9, r)},
        "masked_gram": {f"{S}x{T}:F5": solve.gram_work(S, T, 5)},
        "batched_cho_solve": {f"{S}:F5": solve.cho_solve_work(S, 5)},
    }
    for entry, keys in want.items():
        assert _program(cm, entry) == {
            k: {"flops": float(w[0]), "bytes_accessed": float(w[1])}
            for k, w in keys.items()}, entry
