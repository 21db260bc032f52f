"""Port parity: the on-disk metric store (``monitoring/store.py``).

- The same point streams appended to a store of each package give equal
  ``query`` / ``names`` / ``stats`` reads, and byte-equal segment files.
- Segments written by either package are read by the other; a torn last line
  (a writer's ``os.write`` cut short) is skipped by ``query`` and left
  unconsumed by ``read_segments_from`` in both.
- ``compact`` rewrites sealed segments only, never the live append target,
  and drops what the reference's drops.
- Eight threads appending at once leave only whole lines.
- ``QualityStoreConfig`` accepts and refuses what the reference's does, with
  its messages.
- ``flatten_registry_snapshot`` and ``ScrapeLoop.scrape_once(now)`` give equal
  points from registries fed the same calls.

Every test passes ``now`` explicitly and none waits on a shipped interval.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from distributed_forecasting_tpu.monitoring import monitor as jmon
from distributed_forecasting_tpu.monitoring import store as jstore
from distributed_forecasting_tpu_torch.monitoring import monitor as tmon
from distributed_forecasting_tpu_torch.monitoring import store as tstore

torch.set_num_threads(1)

PKGS = {"ref": jstore, "port": tstore}
T0 = 1_700_000_000.0


def _points(seed, n=200, t0=T0, span=3600.0):
    """Points over ``span`` seconds: a few names, labels and odd values."""
    rng = np.random.default_rng(seed)
    stamps = t0 + np.sort(rng.uniform(0, span, n))
    names = ["dftpu_slo_bad", "dftpu_quality_wape", "serving_requests_total",
             "dftpu_slo_sli"]
    out = []
    for i in range(n):
        labels = {}
        if rng.random() < 0.7:
            labels["rule"] = str(rng.choice(["p95", "coverage", "stale"]))
        if rng.random() < 0.3:
            labels["family"] = "prophet"
        value = float(rng.choice([0.0, 1.0, rng.normal(0, 100), 1e-300,
                                  12345678.125]))
        out.append({"ts": float(stamps[i]),
                    "name": str(rng.choice(names)), "labels": labels,
                    "value": value})
    return out


def _fill(pkg, directory, points, batch=17, seg_bytes=4096):
    st = PKGS[pkg].TimeSeriesStore(directory, retention_s=1800.0,
                                   max_segment_bytes=seg_bytes)
    for i in range(0, len(points), batch):
        assert st.append(points[i:i + batch]) == len(points[i:i + batch])
    return st


def _segments(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


QUERIES = [
    {},
    {"name": "dftpu_slo_bad"},
    {"name": "dftpu_slo_bad", "labels": {"rule": "p95"}},
    {"labels": {"family": "prophet"}},
    {"since": T0 + 600.0},
    {"since": T0 + 600.0, "until": T0 + 1200.0, "name": "dftpu_slo_sli"},
    {"name": "absent"},
]


@pytest.mark.parametrize("seed, seg_bytes", [(0, 4096), (1, 1024),
                                             (2, 4194304)])
def test_equal_point_streams_give_equal_reads(tmp_path, seed, seg_bytes):
    points = _points(seed)
    stores = {p: _fill(p, str(tmp_path / p), points, seg_bytes=seg_bytes)
              for p in PKGS}
    assert _segments(str(tmp_path / "port")) == _segments(str(tmp_path / "ref"))
    for q in QUERIES:
        assert stores["port"].query(**q) == stores["ref"].query(**q), q
    assert stores["port"].names() == stores["ref"].names()
    got, want = stores["port"].stats(), stores["ref"].stats()
    assert got.pop("directory") == str(tmp_path / "port")
    want.pop("directory")
    assert got == want
    if seg_bytes == 1024:
        assert got["segments"] > 3


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_segments_are_read_across_packages_and_torn_lines_skipped(tmp_path,
                                                                  writer):
    reader = "port" if writer == "ref" else "ref"
    d = str(tmp_path / "s")
    points = _points(3, n=60)
    _fill(writer, d, points, seg_bytes=1024)
    last = PKGS[writer].segment_path(d, PKGS[writer].segment_indices(d)[-1])
    whole = PKGS[reader].TimeSeriesStore(d).query()
    assert whole == PKGS[writer].TimeSeriesStore(d).query()
    assert len(whole) == 60
    # a writer's os.write cut short: half a record, no newline
    torn = json.dumps({"ts": T0 + 9e4, "name": "torn", "labels": {},
                       "value": 1.0}, separators=(",", ":"))
    with open(last, "a") as f:
        f.write(torn[: len(torn) // 2])
    for pkg in PKGS:
        got = PKGS[pkg].TimeSeriesStore(d).query()
        assert got == whole, pkg
        lines, cursor = PKGS[pkg].read_segments_from(d)
        assert [json.loads(x) for x in lines] == [
            json.loads(x) for x in PKGS[writer].read_segments_from(d)[0]]
        assert len(lines) == 60
        assert cursor == PKGS[writer].read_segments_from(d)[1]
        assert cursor[PKGS[pkg].segment_indices(d)[-1]] < os.path.getsize(last)
    # the tail completes: the next poll from the cursor returns it, once
    with open(last, "a") as f:
        f.write(torn[len(torn) // 2:] + "\n")
    for pkg in PKGS:
        _, cursor = PKGS[pkg].read_segments_from(d)
        before = dict(cursor)
        lines, _ = PKGS[pkg].read_segments_from(d, {
            k: v for k, v in before.items()})
        assert lines == []
        old = {k: v for k, v in before.items()}
        old[max(old)] -= len(torn) + 1
        lines, after = PKGS[pkg].read_segments_from(d, old)
        assert [json.loads(x)["name"] for x in lines] == ["torn"]
        assert after == before


def test_compact_never_touches_the_live_segment(tmp_path):
    points = _points(4, n=300, span=7200.0)
    out = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        st = _fill(pkg, d, points, seg_bytes=2048)
        segs = PKGS[pkg].segment_indices(d)
        live = PKGS[pkg].segment_path(d, segs[-1])
        with open(live, "rb") as f:
            live_bytes = f.read()
        dropped = st.compact(now=T0 + 7200.0)
        with open(live, "rb") as f:
            assert f.read() == live_bytes, pkg
        after = PKGS[pkg].segment_indices(d)
        assert after[-1] == segs[-1] and len(after) == 2
        # a sealed segment's old points are gone, the live one's all stay
        kept = st.query()
        in_live = [json.loads(x) for x in live_bytes.decode().splitlines()]
        assert all(p in kept for p in in_live)
        assert all(p["ts"] >= T0 + 7200.0 - 1800.0
                   for p in kept if p not in in_live)
        assert len(kept) + dropped == len(points)
        out[pkg] = (dropped, kept, _segments(d))
        assert st.append(points[:3]) == 3  # appends go on after a compaction
    assert out["port"][0] == out["ref"][0] > 0
    assert out["port"][1] == out["ref"][1]
    assert out["port"][2] == out["ref"][2]


def test_compact_with_nothing_sealed_is_a_no_op(tmp_path):
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        st = _fill(pkg, d, _points(5, n=20))
        before = _segments(d)
        assert st.compact(now=T0 + 1e6) == 0
        assert _segments(d) == before


def test_concurrent_appends_leave_whole_lines(tmp_path):
    """Eight threads append batches of different sizes at once: every line
    of every segment parses, and every point is there exactly once."""
    st = tstore.TimeSeriesStore(str(tmp_path), max_segment_bytes=8192)
    barrier = threading.Barrier(8)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # hand the lock over as often as it can

    def writer(i):
        barrier.wait()
        for j in range(40):
            st.append([{"ts": T0 + j, "name": f"w{i}", "labels": {"j": str(j),
                        "pad": "x" * (i * 37 % 200)}, "value": k}
                       for k in range(1 + (i + j) % 5)])

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    n = 0
    for idx in tstore.segment_indices(str(tmp_path)):
        with open(tstore.segment_path(str(tmp_path), idx)) as f:
            text = f.read()
        assert text.endswith("\n")
        for line in text.splitlines():
            json.loads(line)
            n += 1
    want = sum(1 + (i + j) % 5 for i in range(8) for j in range(40))
    assert n == want == len(st.query())
    for i in range(8):
        got = sorted((p["labels"]["j"], p["value"]) for p in st.query(
            name=f"w{i}"))
        assert got == sorted((str(j), float(k)) for j in range(40)
                             for k in range(1 + (i + j) % 5))


CONFS = [None, {}, {"enabled": True}, {"enabled": True, "directory": None},
         {"enabled": True, "directory": "/x", "retention_s": 60,
          "compact_interval_s": "30", "scrape_interval_s": 0.5,
          "max_segment_bytes": 1024}]


@pytest.mark.parametrize("conf", CONFS)
def test_quality_store_config_matches_the_reference(conf):
    got = tstore.QualityStoreConfig.from_conf(conf)
    want = jstore.QualityStoreConfig.from_conf(conf)
    assert [(f, getattr(got, f)) for f in got.__dataclass_fields__] == [
        (f, getattr(want, f)) for f in want.__dataclass_fields__]


@pytest.mark.parametrize("bad", [
    {"retension_s": 10}, {"retention_s": 0}, {"scrape_interval_s": -1},
    {"compact_interval_s": 0}, {"max_segment_bytes": 1023},
    {"retention_s": "soon"}])
def test_quality_store_config_refuses_like_the_reference(bad):
    with pytest.raises(ValueError) as got:
        tstore.QualityStoreConfig.from_conf(bad)
    with pytest.raises(ValueError) as want:
        jstore.QualityStoreConfig.from_conf(bad)
    assert str(got.value) == str(want.value)


def test_store_refuses_a_non_positive_retention_like_the_reference(tmp_path):
    for pkg in PKGS:
        with pytest.raises(ValueError, match="retention_s must be > 0"):
            PKGS[pkg].TimeSeriesStore(str(tmp_path / pkg), retention_s=0)


def _registry(mod, seed):
    """A registry of every kind, fed the same seeded calls."""
    rng = np.random.default_rng(seed)
    r = mod.MetricsRegistry()
    c = r.counter("t_requests_total", "requests")
    g = r.gauge("t_depth", "depth")
    h = r.histogram("t_latency_seconds", (0.005, 0.01, 0.05, 0.1, 0.5, 1.0),
                    "latency")
    e = r.histogram("t_empty_seconds", (1.0,), "never observed")
    lc = r.labeled_counter("t_errors_total", ("route", "code"), "errors")
    lg = r.labeled_gauge("t_metric", ("family", "metric"), "metric")
    for _ in range(50):
        c.inc(float(rng.integers(1, 4)))
        g.set(float(rng.normal()))
        h.observe(float(rng.gamma(2.0, 0.03)))
        lc.inc(route=str(rng.choice(["/a", "/b"])),
               code=str(rng.choice(["400", "503"])))
        lg.set(float(rng.random()), family="prophet",
               metric=str(rng.choice(["wape", "rmsse"])))
    return r, e


@pytest.mark.parametrize("seed", [0, 1])
def test_flatten_registry_snapshot_matches_the_reference(seed):
    (tr, _), (jr, _) = _registry(tmon, seed), _registry(jmon, seed)
    for prefix in (None, {"replica": "0"}):
        got = tstore.flatten_registry_snapshot(tr, T0, prefix)
        want = jstore.flatten_registry_snapshot(jr, T0, prefix)
        assert got == want
    names = {p["name"] for p in got}
    assert {"t_latency_seconds_p95", "t_empty_seconds_count"} <= names
    assert "t_empty_seconds_p50" not in names  # NaN quantiles are not stored


def test_scrape_once_writes_what_the_reference_writes(tmp_path):
    out = {}
    for pkg, mod in (("ref", jmon), ("port", tmon)):
        regs = [_registry(mod, 0)[0], _registry(mod, 1)[0]]
        st = PKGS[pkg].TimeSeriesStore(str(tmp_path / pkg), retention_s=100.0,
                                       max_segment_bytes=2048)

        def dead():
            raise RuntimeError("source gone")

        loop = PKGS[pkg].ScrapeLoop(st, [({}, lambda: regs[0]), ({}, dead),
                                         ({}, lambda: None)],
                                    scrape_interval_s=3600.0,
                                    compact_interval_s=50.0)
        loop.add_source({"replica": "1"}, lambda: regs[1])
        written = [loop.scrape_once(now=T0 + 10.0 * k) for k in range(12)]
        out[pkg] = (written, st.query(), _segments(str(tmp_path / pkg)))
    assert out["port"] == out["ref"]
    assert out["port"][0][0] > 0


def test_stop_joins_the_thread_and_leaves_a_final_scrape(tmp_path):
    st = tstore.TimeSeriesStore(str(tmp_path))
    reg, _ = _registry(tmon, 0)
    loop = tstore.ScrapeLoop(st, [({}, lambda: reg)],
                             scrape_interval_s=3600.0)
    loop.start()
    thread = loop._thread
    assert thread.is_alive() and thread.daemon
    loop.start()  # a second start keeps the one thread
    assert loop._thread is thread
    assert st.query() == []
    loop.stop(final_scrape=True)
    assert not thread.is_alive() and loop._thread is None
    assert {p["name"] for p in st.query()} >= {"t_requests_total",
                                                "t_latency_seconds_count"}
