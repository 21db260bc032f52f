"""The port's tracer (``monitoring/trace.py``) against the reference's.

The span records, their JSON lines and the Chrome trace of the same spans
are the reference's, byte for byte (both packages write one process's
spans, so the process id matches too); ``TraceConfig`` refuses what the
reference refuses, with its messages.  The reference's unit cases run on
the port: nesting, error status, a context carried across threads, the
ring bound, the JSONL and Chrome exporters, the flight-recorder dump and
the single-flight profiler.  ``device_annotation`` is
``torch.profiler.record_function``: a ``ProfilerSession`` capture records
the annotation of a span opened on another thread.
"""

import dataclasses
import json
import os
import threading
import time

import pytest
import torch

from distributed_forecasting_tpu.monitoring import trace as jtrace
from distributed_forecasting_tpu_torch.monitoring import trace as ttrace

torch.set_num_threads(1)


def _records(mod):
    """The same three completed spans as each package's SpanRecord."""
    return [
        mod.SpanRecord(name="pipeline.prep", trace_id="a" * 16, span_id="1",
                       parent_id=None, start=10.0, end=10.25,
                       thread_id=7, thread_name="main",
                       attrs={"experiment": "e0"}),
        mod.SpanRecord(name="pipeline.pull", trace_id="a" * 16, span_id="2",
                       parent_id="1", start=10.3, end=10.9003,
                       thread_id=8, thread_name="dftpu-pipeline-writer",
                       attrs={"experiment": "e0", "device_seconds": 0.6}),
        mod.SpanRecord(name="aot.call", trace_id="b" * 16, span_id="3",
                       parent_id=None, start=11.0, end=11.0000125,
                       thread_id=7, thread_name="main",
                       attrs={"entry": "fit_forecast:theta"},
                       status="error:ValueError"),
    ]


@pytest.fixture()
def tracer():
    tr = ttrace.Tracer(ttrace.TraceConfig(enabled=True, ring_size=64))
    yield tr
    tr.close()


@pytest.fixture()
def global_tracing():
    """Swap the process-wide tracer for the test; defaults restored after."""
    def apply(config):
        ttrace.configure_tracing(config)
        return ttrace.get_tracer()
    yield apply
    ttrace.configure_tracing(ttrace.TraceConfig())


# -- against the reference ----------------------------------------------------

def test_span_records_and_chrome_trace_equal_the_reference():
    got, want = _records(ttrace), _records(jtrace)
    assert [r.to_json() for r in got] == [r.to_json() for r in want]
    assert [r.duration_s for r in got] == [r.duration_s for r in want]
    meta = {"reason": "test"}
    assert (json.dumps(ttrace.to_chrome_trace(got, meta))
            == json.dumps(jtrace.to_chrome_trace(want, meta)))
    assert ttrace.to_chrome_trace([]) == jtrace.to_chrome_trace([])


def test_jsonl_lines_equal_the_reference(tmp_path):
    files = {}
    for tag, mod in (("port", ttrace), ("ref", jtrace)):
        path = str(tmp_path / tag / "trace.jsonl")
        writer = mod._JsonlWriter(path)
        for rec in _records(mod):
            writer.submit(rec)
        writer.close()
        with open(path, "rb") as f:
            files[tag] = f.read()
    assert files["port"] == files["ref"]
    assert len(files["port"].splitlines()) == 3


@pytest.mark.parametrize("conf", [
    {"ringsize": 8},
    {"enabled": True, "dumpdir": "/x"},
    {"ring_size": 0},
    {"ring_size": -3},
    {"max_profile_seconds": 0},
    {"max_profile_seconds": -1.0},
], ids=["key", "key2", "ring0", "ring_neg", "profile0", "profile_neg"])
def test_trace_config_refuses_what_the_reference_refuses(conf):
    with pytest.raises(ValueError) as want:
        jtrace.TraceConfig.from_conf(conf)
    with pytest.raises(ValueError) as got:
        ttrace.TraceConfig.from_conf(conf)
    assert str(got.value) == str(want.value)


def test_trace_config_parses_as_the_reference():
    conf = {"enabled": False, "ring_size": 8, "jsonl_path": "t.jsonl",
            "dump_dir": "d", "debug_endpoints": True, "profile_dir": "p",
            "max_profile_seconds": 5}
    for c in (None, {}, conf):
        assert (dataclasses.asdict(ttrace.TraceConfig.from_conf(c))
                == dataclasses.asdict(jtrace.TraceConfig.from_conf(c)))


# -- the reference's unit cases, on the port ----------------------------------

def test_span_nesting_and_parenthood(tracer):
    with tracer.root_span("outer", trace_id="t" * 16):
        with tracer.span("inner", k=3):
            pass
    spans = {s.name: s for s in tracer.recorder.snapshot()}
    assert set(spans) == {"outer", "inner"}
    assert spans["inner"].trace_id == spans["outer"].trace_id == "t" * 16
    assert spans["inner"].parent_id == spans["outer"].span_id
    assert spans["outer"].parent_id is None
    assert spans["inner"].attrs["k"] == 3
    assert spans["inner"].start <= spans["inner"].end
    # the recorder is completion-ordered: inner closed first
    assert [s.name for s in tracer.recorder.snapshot()] == ["inner", "outer"]


def test_span_error_status(tracer):
    with pytest.raises(ValueError):
        with tracer.span("boom"):
            raise ValueError("nope")
    (span,) = tracer.recorder.snapshot()
    assert span.status == "error:ValueError"


def test_context_crosses_threads(tracer):
    """The executor's hand-off: current() captured on the producer thread,
    adopted on the consumer — one trace id, the right parent."""
    captured = {}

    def consumer(ctx):
        with tracer.context(ctx):
            with tracer.span("consumer.work"):
                pass

    with tracer.root_span("producer", trace_id="feedbeefcafe0001"):
        ctx = tracer.current()
        captured["ctx"] = ctx
        t = threading.Thread(target=consumer, args=(ctx,))
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert isinstance(captured["ctx"], ttrace.TraceContext)
    spans = {s.name: s for s in tracer.recorder.snapshot()}
    assert spans["consumer.work"].trace_id == "feedbeefcafe0001"
    assert spans["consumer.work"].parent_id == captured["ctx"].span_id
    assert spans["consumer.work"].thread_name != spans["producer"].thread_name


def test_record_span_explicit_times(tracer):
    t0 = ttrace.clock()
    t1 = t0 + 0.5
    tracer.record_span("batcher.queue_wait", t0, t1, expired=False)
    (span,) = tracer.recorder.snapshot()
    assert span.start == t0 and span.end == t1
    assert span.attrs == {"expired": False}


def test_disabled_tracer_is_noop():
    tr = ttrace.Tracer(ttrace.TraceConfig(enabled=False))
    with tr.span("a") as s1:
        with tr.root_span("b") as s2:
            pass
    assert s1 is s2  # the shared no-op span
    assert len(tr.recorder) == 0
    assert tr.current() is None
    tr.close()


def test_flight_recorder_ring_bound(tracer):
    for i in range(200):
        with tracer.span(f"s{i}"):
            pass
    assert len(tracer.recorder) == 64  # ring_size, oldest evicted
    names = [s.name for s in tracer.recorder.snapshot()]
    assert names[0] == "s136" and names[-1] == "s199"


def test_jsonl_exporter(tmp_path):
    path = str(tmp_path / "t" / "trace.jsonl")
    tr = ttrace.Tracer(ttrace.TraceConfig(jsonl_path=path))
    with tr.root_span("pipeline.dispatch", trace_id="a" * 16, experiment="e"):
        with tr.span("aot.call"):
            pass
    tr.close()  # flush and join the writer thread
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    assert [r["name"] for r in rows] == ["aot.call", "pipeline.dispatch"]
    assert all(r["trace_id"] == "a" * 16 for r in rows)
    assert rows[1]["attrs"]["experiment"] == "e"
    assert rows[0]["duration_ms"] >= 0


def test_chrome_trace_format(tracer, tmp_path):
    with tracer.root_span("outer", trace_id="c" * 16):
        with tracer.span("inner"):
            time.sleep(0.002)
    doc = ttrace.to_chrome_trace(tracer.recorder.snapshot(),
                                 metadata={"run": "x"})
    assert doc["displayTimeUnit"] == "ms"
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(xs) == 2 and metas, doc
    assert min(e["ts"] for e in xs) == 0  # relative to the earliest span
    inner = next(e for e in xs if e["name"] == "inner")
    assert inner["dur"] >= 2000  # microseconds
    assert inner["args"]["trace_id"] == "c" * 16
    assert doc["otherData"]["run"] == "x"
    p = ttrace.write_chrome_trace(str(tmp_path / "d" / "t.trace.json"),
                                  tracer.recorder.snapshot())
    with open(p) as f:
        assert json.load(f)["traceEvents"]


def test_dump_flight_recorder(tmp_path, global_tracing):
    global_tracing(ttrace.TraceConfig(enabled=True))
    assert ttrace.dump_flight_recorder("x") is None  # no dump_dir
    tr = global_tracing(ttrace.TraceConfig(
        enabled=True, dump_dir=str(tmp_path / "dumps")))
    assert ttrace.dump_flight_recorder("empty") is None  # empty ring
    with tr.span("s"):
        pass
    p1 = ttrace.dump_flight_recorder("http-503")
    p2 = ttrace.dump_flight_recorder("http-503")
    assert p1 and p2 and p1 != p2  # one file per incident
    assert os.path.basename(p1).startswith("flight-")
    assert "http-503" in os.path.basename(p1)
    with open(p1) as f:
        assert json.load(f)["traceEvents"]


def test_profiler_session_single_flight(tmp_path):
    sess = ttrace.ProfilerSession(None, max_seconds=10.0)
    assert not sess.available
    with pytest.raises(RuntimeError):
        sess.capture(1.0)
    sess = ttrace.ProfilerSession(str(tmp_path / "prof"), max_seconds=10.0)
    assert sess.available
    with sess._flag_lock:
        sess._active = True  # a capture is in flight
    with pytest.raises(ttrace.ProfilerBusyError):
        sess.capture(0.1)
    with sess._flag_lock:
        sess._active = False


def test_profiler_capture_holds_another_threads_annotation(tmp_path):
    """A capture on this thread records the ``device_annotation`` of work
    on another thread (``profile_all_threads``), and exports a Chrome trace;
    the capture window is clamped to ``max_seconds``."""
    sess = ttrace.ProfilerSession(str(tmp_path / "prof"), max_seconds=0.3)
    stop = threading.Event()

    def work():
        while not stop.is_set():
            with ttrace.device_annotation("pipeline_dispatch:e0"):
                torch.ones(64).sum()
            time.sleep(0.005)

    t = threading.Thread(target=work)
    t.start()
    try:
        t0 = time.monotonic()
        out = sess.capture(30.0)
        assert time.monotonic() - t0 < 10.0  # clamped to 0.3 s, plus export
    finally:
        stop.set()
        t.join(10)
    assert not t.is_alive()
    with open(os.path.join(out, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert "pipeline_dispatch:e0" in names
    assert not sess._active


@pytest.mark.parametrize("value", [None, ""], ids=["unset", "empty"])
def test_enable_from_env_is_a_noop_without_the_variable(monkeypatch, value,
                                                        global_tracing):
    before = global_tracing(ttrace.TraceConfig(enabled=True, ring_size=8))
    if value is None:
        monkeypatch.delenv("DFTPU_TRACE_DIR", raising=False)
    else:
        monkeypatch.setenv("DFTPU_TRACE_DIR", value)
    assert ttrace.enable_from_env() is None
    assert jtrace.enable_from_env() is None
    assert ttrace.get_tracer() is before


def test_enable_from_env_installs_the_reference_config(monkeypatch, tmp_path,
                                                       global_tracing):
    """``DFTPU_TRACE_DIR`` set: the installed tracer's config is the
    reference's for the same directory, and its spans reach the JSONL file
    under it."""
    monkeypatch.setenv("DFTPU_TRACE_DIR", str(tmp_path))
    want = jtrace.enable_from_env()
    try:
        tr = ttrace.enable_from_env()
        assert tr is ttrace.get_tracer()
        assert dataclasses.asdict(tr.config) == dataclasses.asdict(
            want.config)
        assert tr.config.debug_endpoints and tr.config.enabled
        assert tr.config.profile_dir == os.path.join(str(tmp_path),
                                                     "profile")
        with tr.span("from-env"):
            pass
    finally:
        jtrace.configure_tracing(jtrace.TraceConfig())
    ttrace.configure_tracing(ttrace.TraceConfig())  # flushes the exporter
    with open(tmp_path / "trace.jsonl") as f:
        names = [json.loads(line)["name"] for line in f]
    assert "from-env" in names
