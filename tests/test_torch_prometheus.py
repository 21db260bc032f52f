"""Port parity: the Prometheus primitives behind the scorer's ``GET /metrics``.

For the same seeded sequence of ``inc`` / ``set`` / ``observe`` calls, each
primitive of the port's ``monitoring/monitor.py`` renders text byte-equal to
the reference's, and its ``snapshot`` is equal.  The registry that
``ServingMetrics`` builds renders the same families, help texts and bucket
edges in the same order (``QualityMonitor``'s: tests/test_torch_quality.py).
"""

import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.monitoring import monitor as jmon
from distributed_forecasting_tpu_torch.monitoring import monitor as tmon

torch.set_num_threads(1)

# label values chosen to exercise the text format's escaping
_LABELS = ["prophet", 'quo"te', "back\\slash", "new\nline", "auto:arima"]
_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)


def _calls(kind, seed):
    """A seeded call sequence: (method, args, kwargs) triples."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(40):
        if kind == "counter":
            out.append(("inc", (float(rng.choice([1, 2.5, 0, 1e-3])),), {}))
        elif kind == "gauge":
            m = rng.choice(["set", "inc", "dec"])
            v = float(rng.choice([3, -1.5, 1e16, 0.1, 7]))
            out.append((m, (v,), {}))
        elif kind == "histogram":
            out.append(("observe", (float(rng.exponential(0.05)),), {}))
        elif kind == "labeled_counter":
            out.append(("inc", (float(rng.integers(0, 4)),),
                        {"family": str(rng.choice(_LABELS)),
                         "outcome": str(rng.choice(["hit", "miss"]))}))
        elif kind == "labeled_gauge":
            out.append(("set", (float(rng.normal()),),
                        {"family": str(rng.choice(_LABELS)),
                         "metric": str(rng.choice(["wape", "rmsse"]))}))
    return out


def _build(mod, kind):
    if kind == "counter":
        return mod.Counter()
    if kind == "gauge":
        return mod.Gauge()
    if kind == "histogram":
        return mod.Histogram(_BUCKETS)
    if kind == "labeled_counter":
        return mod.LabeledCounter(("family", "outcome"))
    return mod.LabeledGauge(("family", "metric"))


KINDS = ["counter", "gauge", "histogram", "labeled_counter", "labeled_gauge"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_primitive_renders_byte_equal(kind, seed):
    ref, port = _build(jmon, kind), _build(tmon, kind)
    for method, args, kwargs in _calls(kind, seed):
        getattr(ref, method)(*args, **kwargs)
        getattr(port, method)(*args, **kwargs)
    assert port.render("x_metric") == ref.render("x_metric")
    assert port.snapshot() == ref.snapshot()


def test_histogram_quantiles_and_buckets_equal():
    ref, port = jmon.Histogram(_BUCKETS), tmon.Histogram(_BUCKETS)
    for v in np.random.default_rng(3).exponential(0.1, 200):
        ref.observe(v)
        port.observe(v)
    assert port.cumulative_buckets() == ref.cumulative_buckets()
    assert port.snapshot_quantiles() == ref.snapshot_quantiles()
    assert (port.count, port.sum) == (ref.count, ref.sum)
    empty = tmon.Histogram(_BUCKETS).snapshot_quantiles((0.5,))
    assert np.isnan(empty[0.5])


@pytest.mark.parametrize("value", [
    'a"b', "a\\b", "a\nb", 'x\\"\n', 3, "plain"])
def test_label_and_help_escaping_equal(value):
    assert tmon.escape_label_value(value) == jmon.escape_label_value(value)
    assert tmon._escape_help(value) == jmon._escape_help(value)
    labels = {"family": value, "metric": "wape"}
    assert tmon.render_labels(labels) == jmon.render_labels(labels)
    assert tmon.render_labels({}) == ""


@pytest.mark.parametrize("v", [0, 1, 2.0, -3.0, 0.25, 1e15, 1e16, 1e-7,
                               float("nan"), float("inf")])
def test_value_format_equal(v):
    assert tmon._fmt_value(v) == jmon._fmt_value(v)


def _registry(mod):
    r = mod.MetricsRegistry()
    c = r.counter("a_total", "a counter\nwith a newline")
    g = r.gauge("b", "")
    h = r.histogram("c_seconds", _BUCKETS, "a histogram")
    lc = r.labeled_counter("d_total", ("k",), "labeled")
    lg = r.labeled_gauge("e", ("k", "m"), "labeled gauge")
    c.inc(3)
    g.set(-2.5)
    for v in (0.0005, 0.02, 0.3, 7.0):
        h.observe(v)
    lc.inc(2, k='x"y')
    lg.set(0.125, k="a", m="b")
    return r


def test_registry_render_and_snapshot_equal():
    ref, port = _registry(jmon), _registry(tmon)
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.snapshot() == ref.snapshot()
    assert ([(n, k) for n, k, _ in port.items()]
            == [(n, k) for n, k, _ in ref.items()])


@pytest.mark.parametrize("bad", [
    lambda m: m.Counter().inc(-1),
    lambda m: m.LabeledCounter(("a",)).inc(1, b="x"),
    lambda m: m.LabeledGauge(("a",)).set(1, b="x"),
    lambda m: m.Histogram(()),
    lambda m: m.LabeledCounter(()),
    lambda m: m.LabeledGauge(()),
    lambda m: (lambda r: (r.counter("x"), r.gauge("x")))(m.MetricsRegistry()),
], ids=["negative_inc", "counter_labels", "gauge_labels", "no_buckets",
        "counter_no_labels", "gauge_no_labels", "duplicate_name"])
def test_misuse_raises_alike(bad):
    with pytest.raises(ValueError):
        bad(jmon)
    with pytest.raises(ValueError):
        bad(tmon)


def test_serving_registry_renders_like_the_reference():
    """The families the port registers — names, types, help texts, bucket
    edges, order — render as the reference's on fresh registries."""
    from distributed_forecasting_tpu.serving import batcher as jb
    from distributed_forecasting_tpu_torch.serving import batcher as tb

    assert (tb.ServingMetrics().registry.render_prometheus()
            == jb.ServingMetrics().registry.render_prometheus())
    assert tb._LATENCY_BUCKETS == jb._LATENCY_BUCKETS
    assert tb._BATCH_BUCKETS == jb._BATCH_BUCKETS
