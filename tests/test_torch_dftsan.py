"""The port's dftsan join (``analysis/dftsan.py``) against the reference's.

* The port's sanitizer armed over a small CPU workload: a coalescer fed
  from four threads, a WAL appended from four, a forecaster predicting
  while its state is swapped.  Its report, and hand-written entries beside
  it (an edge the static model lacks, unlocked accesses in product and in
  test code), go through both packages' ``load_reports`` and
  ``cross_check`` over a project of the port's tree: the findings are
  equal, and the armed workload's own part raises no error.
* A static cycle the runtime confirms, on a fixture tree in both.
* The port's CLI: exit 2 when it finds no report, 1 on an unlocked access,
  0 on a clean report, SARIF with the three runtime rules, a suppression
  at the reported site; each as the reference's CLI answers.
"""

import json
import os
import textwrap
import threading

import pandas as pd
import pytest
import torch

from distributed_forecasting_tpu.analysis import dftsan as ref_dftsan
from distributed_forecasting_tpu.analysis.core import (
    DflintConfig as RefConfig,
    build_project as ref_build_project,
)
from distributed_forecasting_tpu_torch.analysis import dftsan
from distributed_forecasting_tpu_torch.analysis.core import (
    DflintConfig,
    build_project,
)
from distributed_forecasting_tpu_torch.monitoring import sanitizer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "distributed_forecasting_tpu_torch"
PREDICTOR = f"{PORT}/serving/predictor.py"
RUNTIME_RULES = {"dftsan-unlocked-access", "dftsan-cycle-confirmed",
                 "dftsan-unmodeled-edge"}


@pytest.fixture(scope="module")
def projects():
    """(the port's project, the reference's) of the port's tree, as the
    port's dftsan CLI builds it: the checkout's root, the port's package
    the target, the committed config."""
    targets = [os.path.join(ROOT, PORT)]
    return build_project(ROOT, targets), ref_build_project(ROOT, targets)


@pytest.fixture
def san():
    was = sanitizer.is_enabled()
    sanitizer.configure()
    sanitizer.reset()
    yield sanitizer
    sanitizer.reset()
    if not was:
        sanitizer.deactivate()


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


def _armed_workload(tmp_path) -> None:
    """A coalescer, a WAL and a forecaster built and driven while armed."""
    from distributed_forecasting_tpu_torch.data import (
        synthetic_store_item_sales,
        tensorize,
    )
    from distributed_forecasting_tpu_torch.models import get_model
    from distributed_forecasting_tpu_torch.serving import BatchForecaster
    from distributed_forecasting_tpu_torch.serving.batcher import (
        BatchingConfig,
        RequestBatcher,
    )
    from distributed_forecasting_tpu_torch.serving.ingest import WriteAheadLog

    batch = tensorize(synthetic_store_item_sales(
        n_stores=2, n_items=3, n_days=60, seed=5), device="cpu")
    fns = get_model("holt_winters")
    cfg = fns.config_cls()
    fc = BatchForecaster.from_fit(
        batch, fns.fit(batch.y, batch.mask, batch.day, cfg),
        "holt_winters", cfg)
    batcher = RequestBatcher(fc, BatchingConfig(enabled=True,
                                                max_batch_size=8,
                                                max_wait_ms=5.0))
    wal = WriteAheadLog(str(tmp_path / "wal"), max_segment_bytes=512)
    reqs = [pd.DataFrame(fc.keys[:k], columns=list(fc.key_names))
            for k in (1, 2, 6)]
    futures, lock = [], threading.Lock()

    def client(req):
        def run():
            f = batcher.submit(req, horizon=7)
            with lock:
                futures.append(f)
        return run

    def appender(i):
        return lambda: [wal.append([{"k": [i, j], "d": 100 + j, "y": 1.0}])
                        for j in range(10)]

    def installer():
        fc.swap_state(day1=fc._state_snapshot()[1])

    def reader():
        for req in reqs:
            fc.predict(req, horizon=7)

    try:
        _run_threads([client(r) for r in reqs] * 2
                     + [appender(i) for i in range(4)]
                     + [installer, reader, reader])
        assert all(len(f.result(60)) > 0 for f in futures)
    finally:
        batcher.close()
    assert len(wal.read_new()[0]) == 40


def _edge(src, dst, path, line):
    return {"src": list(src), "dst": list(dst), "count": 3,
            "path": path, "line": line, "thread": "worker"}


def _key(f):
    return (f.rule, f.path, f.line, f.severity, f.message, f.snippet)


def test_cross_check_of_an_armed_workload_equals_the_reference(
        san, tmp_path, projects):
    _armed_workload(tmp_path)
    reports = tmp_path / "reports"
    path = sanitizer.write_report(str(reports) + os.sep)
    mine, loaded = dftsan.load_reports([str(reports)])
    theirs, ref_loaded = ref_dftsan.load_reports([str(reports)])
    assert loaded == ref_loaded == [path]
    assert mine == theirs
    ids = {lid[1:] for lid in mine["locks"]}
    assert {("BatchForecaster", "_state_lock"), ("RequestBatcher", "_cond"),
            ("WriteAheadLog", "_lock")} <= ids
    port_project, ref_project = projects
    workload = dftsan.cross_check(mine, port_project)
    assert [f for f in workload if f.severity == "error"] == []
    assert [_key(f) for f in workload] == [
        _key(f) for f in ref_dftsan.cross_check(theirs, ref_project)]

    # beside it: an edge no static path takes, unlocked accesses in the
    # port's code and in a test (dropped), on the port's real locks
    wal = (f"{PORT}/serving/ingest.py", "WriteAheadLog", "_lock")
    state = (PREDICTOR, "BatchForecaster", "_state_lock")
    for report in (mine, theirs):
        report["edges"][(wal, state)] = _edge(wal, state, PREDICTOR, 560)
        report["violations"][(state, "params", "read", PREDICTOR, 570)] = {
            "count": 2, "thread": "http-worker-1",
            "stack": f"{PREDICTOR}:570 in predict"}
        report["violations"][(state, "day1", "write",
                              "tests/test_torch_predictor.py", 9)] = {
            "count": 1, "thread": "MainThread", "stack": "t"}
    got = dftsan.cross_check(mine, port_project)
    want = ref_dftsan.cross_check(theirs, ref_project)
    assert [_key(f) for f in got] == [_key(f) for f in want]
    rules = sorted(f.rule for f in got if f not in workload)
    assert rules == ["dftsan-unlocked-access", "dftsan-unmodeled-edge"]
    (access,) = [f for f in got if f.rule == "dftsan-unlocked-access"]
    assert access.path == PREDICTOR and access.severity == "error"
    assert "read of BatchForecaster.params" in access.message


_STATIC_CYCLE = """
    import threading

    class Duo:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def one(self):
            with self._a:
                with self._b:
                    pass

        def two(self):
            with self._b:
                with self._a:
                    pass
"""


def _write(root, rel, text):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))


def test_a_confirmed_static_cycle_equals_the_reference(tmp_path):
    _write(tmp_path, "serving/duo.py", _STATIC_CYCLE)
    a = ("serving/duo.py", "Duo", "_a")
    b = ("serving/duo.py", "Duo", "_b")
    got, want = [], []
    for mod, build, config, out in (
            (dftsan, build_project, DflintConfig, got),
            (ref_dftsan, ref_build_project, RefConfig, want)):
        report, _ = mod.load_reports([])
        report["edges"][(a, b)] = _edge(a, b, "serving/duo.py", 9)
        report["edges"][(b, a)] = _edge(b, a, "serving/duo.py", 15)
        out.extend(mod.cross_check(report, build(
            str(tmp_path), [str(tmp_path)], config=config())))
    assert [f.rule for f in got] == ["dftsan-cycle-confirmed"] * 2
    assert all(f.severity == "error" for f in got)
    assert "deadlock is reachable" in got[0].message
    assert [_key(f) for f in got] == [_key(f) for f in want]


def test_a_project_of_the_port_package_alone_joins(san, tmp_path):
    """The project of the port's package with nothing else indexed: every
    method name is unique there, so the model resolves more edges, among
    them ``_mesh_lock`` before both a class's and a module's lock of
    ``monitoring/cost.py``.  The lock-order pass sorts such ids with
    ``rules_lockorder._order_key`` (the reference's raw tuple sort raises
    TypeError on them); the join runs and the workload is clean."""
    excludes = tuple(sorted(d for d in os.listdir(ROOT) if d != PORT))
    project = build_project(ROOT, [os.path.join(ROOT, PORT)],
                            config=DflintConfig(exclude=excludes))
    _armed_workload(tmp_path)
    report, _ = dftsan.load_reports([sanitizer.write_report(
        str(tmp_path / "reports") + os.sep)])
    found = dftsan.cross_check(report, project)
    assert [f for f in found if f.severity == "error"] == []


def _fake_report(directory, **extra):
    rep = {"version": 1, "pid": 1, "locks": [], "edges": [],
           "violations": [], "dropped": {"edges": 0, "violations": 0}}
    rep.update(extra)
    directory.mkdir(parents=True, exist_ok=True)
    p = directory / "dftsan-1.json"
    p.write_text(json.dumps(rep))
    return p


def _cli_tree(tmp_path):
    """A checkout-shaped tree: both packages hold the cycle fixture, each
    CLI models its own package."""
    _write(tmp_path, "pyproject.toml", "[tool.dflint]\n")
    for pkg in (PORT, "distributed_forecasting_tpu"):
        _write(tmp_path, f"{pkg}/serving/duo.py", _STATIC_CYCLE)
    return tmp_path


def _violation(pkg, line):
    return {"lock": [f"{pkg}/serving/duo.py", "Duo", "_a"], "attr": "t",
            "op": "write", "path": f"{pkg}/serving/duo.py", "line": line,
            "count": 1, "thread": "worker", "stack": "s"}


def test_the_cli_finds_no_report_and_exits_2(tmp_path, capsys):
    root = _cli_tree(tmp_path)
    empty = tmp_path / "reports"
    empty.mkdir()
    assert dftsan.main([str(empty), "--root", str(root)]) == 2
    assert "no report files found" in capsys.readouterr().err
    assert ref_dftsan.main([str(empty), "--root", str(root)]) == 2
    capsys.readouterr()


def test_the_cli_exit_codes_and_sarif_match_the_reference(tmp_path,
                                                         capsys):
    root = _cli_tree(tmp_path)
    clean = _fake_report(tmp_path / "clean")
    assert dftsan.main([str(clean), "--root", str(root)]) == 0
    assert "0 error(s), 0 warning(s)" in capsys.readouterr().out
    codes = {}
    for name, main, pkg in (
            ("port", dftsan.main, PORT),
            ("ref", ref_dftsan.main, "distributed_forecasting_tpu")):
        rep = _fake_report(tmp_path / name, violations=[_violation(pkg, 5)])
        codes[name] = main([str(rep), "--root", str(root), "--format",
                            "sarif"])
        (run,) = json.loads(capsys.readouterr().out)["runs"]
        assert RUNTIME_RULES <= {r["id"] for r in
                                 run["tool"]["driver"]["rules"]}
        (result,) = run["results"]
        assert result["ruleId"] == "dftsan-unlocked-access"
        assert result["locations"][0]["physicalLocation"][
            "artifactLocation"]["uri"] == f"{pkg}/serving/duo.py"
    assert codes == {"port": 1, "ref": 1}


def test_the_cli_honours_a_suppression_at_the_site(tmp_path, capsys):
    root = _cli_tree(tmp_path)
    _write(root, f"{PORT}/serving/duo.py", """
        import threading

        class Duo:
            def __init__(self):
                self._a = threading.Lock()
                self.t = 0  # dflint: disable=dftsan-unlocked-access
    """)
    rep = _fake_report(tmp_path / "reports", violations=[_violation(PORT, 7)])
    assert dftsan.main([str(rep), "--root", str(root)]) == 0
    assert "1 suppressed inline" in capsys.readouterr().out
