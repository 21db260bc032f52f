"""The port's dflint (``distributed_forecasting_tpu_torch.analysis``) against
the reference's (``distributed_forecasting_tpu.analysis``).

* Every rule the port registers, on one fixture tree each (source strings
  written under ``tmp_path``, as ``tests/unit/test_dflint*.py`` and
  ``test_dfproto.py`` write theirs), through both packages' ``lint_paths``:
  the findings are equal in (rule, path, line, severity), snippet and
  related hops, and in message, except where the port names its own
  framework (:data:`RENAMED` lists those messages).  The runtime-fed
  dftsan rules are held in ``tests/test_torch_dftsan.py``.
* The machinery: ``REGISTRY`` is the reference's less exactly the five
  JAX-only rules (:data:`JAX_ONLY`); suppressions, the baseline's format
  and multiset, the ``[tool.dflint]`` block, SARIF 2.1.0 and the CLI's
  exit codes 0 / 1 / 2, each against the reference.
* The port-only clauses, on the port alone: a torch draw without
  ``generator=`` in a numeric path is ``nondeterminism``; a device sync
  under a lock is ``blocking-under-lock``.
* Importing the port's ``analysis`` pulls no torch, numpy, pandas or jax.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from distributed_forecasting_tpu import analysis as ref
from distributed_forecasting_tpu.analysis import cli as ref_cli
from distributed_forecasting_tpu.analysis import core as ref_core
from distributed_forecasting_tpu.analysis import protocol as ref_protocol
from distributed_forecasting_tpu.analysis import sarif as ref_sarif
from distributed_forecasting_tpu_torch import analysis as port
from distributed_forecasting_tpu_torch.analysis import cli as port_cli
from distributed_forecasting_tpu_torch.analysis import core as port_core
from distributed_forecasting_tpu_torch.analysis import sarif as port_sarif

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's rules whose subject eager PyTorch does not have: no
# jit-traced body, static argnums, donated buffers or per-signature compile
JAX_ONLY = {"host-sync-in-hot-path", "tracer-leak", "static-argnum-drift",
            "host-reuse-after-donation", "recompile-churn"}

# messages that name the port's framework: (rule, the reference's words,
# the port's words in their place)
RENAMED = [
    ("nondeterminism", "thread a jax.random key or a",
     "thread a torch.Generator or a"),
    # the table's generator is the package's own protocol module
    ("proto-endpoint-table-drift",
     "python -m distributed_forecasting_tpu.analysis.protocol",
     "python -m distributed_forecasting_tpu_torch.analysis.protocol"),
]


def _write(root, files: dict) -> None:
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))


def _client(path, method="POST", status=None, headers=None, read=None):
    """A client module hitting ``path`` (the reference's dfproto helper)."""
    body = ["import http.client", "", "def call():",
            "    conn = http.client.HTTPConnection('localhost', 8080)"]
    if headers:
        body.append(f"    conn.request({method!r}, {path!r}, "
                    f"headers={headers!r})")
    else:
        body.append(f"    conn.request({method!r}, {path!r})")
    body.append("    resp = conn.getresponse()")
    if read:
        body.append(f"    resp.getheader({read!r})")
    if status is not None:
        body.append(f"    if resp.status == {status}:")
        body.append("        return True")
    body.append("    return resp")
    return "\n".join(body) + "\n"


_RACY = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0

        def bump(self):
            with self._lock:
                self._n += 1

        def peek(self):
            return self._n

        def reset(self):
            self._n = 0
"""

_NOISY = """
    import random
    import time
    import numpy as np

    def jitter(x):
        return x + np.random.normal() + random.random()

    def stamp():
        return time.time()

    def seeded(x):
        return x + np.random.default_rng(0).normal() + time.monotonic()
"""

_CONFIG = {
    "conf/app.yml": """
        horizon: 90
        max_batchsize: 8
        alpha: 0.5
    """,
    "src/consume.py": """
        import dataclasses

        def run(conf):
            return conf.get("horizon")

        @dataclasses.dataclass
        class FitConfig:
            alpha: float
            beta: float

            @classmethod
            def from_conf(cls, conf):
                return cls(**conf)
    """,
}

_METRICS = {
    "serving/fleet.py": """
        _GAUGE_MAX_MERGE = frozenset({"dftpu_wal_bytes", "dftpu_gone",
                                      "dftpu_rows_total"})
        _GAUGE_SUM_MERGE = frozenset({"dftpu_queue_depth", "dftpu_wal_bytes"})
        _GAUGE_MAX_PREFIXES = ("dftpu_slo_",)
    """,
    "monitoring/metrics.py": """
        def build(r):
            r.gauge("dftpu_wal_bytes", "in two policies")
            r.gauge("dftpu_queue_depth", "policed")
            r.gauge("dftpu_orphan_gauge", "no policy anywhere")
            r.labeled_gauge("dftpu_slo_burn", ("rule",), "prefix-policed")
            r.counter("dftpu_rows_total", "a counter")
    """,
}

_FAILPOINTS = {
    "docs/resilience.md": """
        # Resilience

        ## Failpoint catalogue

        | site | module | boundary |
        | --- | --- | --- |
        | `wal.append` | `serving/wal.py` | append write |
        | `doc.only.site` | `nowhere.py` | stale row |
    """,
    "serving/wal.py": """
        def append(buf):
            failpoint("wal.append")
            failpoint("wal.undocumented")
    """,
    "scripts/chaos_harness.py": """
        SPEC = "wal.append=kill9; wal.ghost=raise OSError:0.3"
    """,
}

_SPANS = {
    "docs/observability.md": """
        ## Span catalog

        | span | thread | meaning |
        | --- | --- | --- |
        | `serve.predict` | handler | the predictor call |
        | `doc.only.span` | nobody | stale row |
    """,
    "serving/server.py": """
        def handle(tracer, match):
            with tracer.span("serve.predict"):
                pass
            with get_tracer().span("serve.undocumented"):
                pass
            match.span("regex.group.span")
    """,
}

_LOCK_CYCLE = """
    import threading

    A = threading.Lock()
    B = threading.Lock()
    L = threading.RLock()

    def _inner_a():
        with A:
            pass

    def forward():
        with A:
            with B:
                pass

    def backward():
        with B:
            _inner_a()

    def reentrant():
        with L:
            with L:
                pass
"""

_BLOCKING = """
    import os
    import queue
    import subprocess
    import threading
    import time

    L = threading.Lock()
    Q = queue.Queue(maxsize=8)
    U = queue.Queue()

    def _persist(path, payload):
        with open(path, "w") as fh:
            fh.write(payload)

    def submit(item):
        with L:
            Q.put(item)
            Q.put(item, timeout=0.5)
            U.put(item)

    def save(path, payload):
        with L:
            _persist(path, payload)
            os.replace(path, path + ".bak")
            subprocess.run(["true"])
            time.sleep(0.1)

    class Worker:
        def __init__(self):
            self._lock = threading.Lock()
            self._thread = threading.Thread(target=self.run)

        def run(self):
            pass

        def stop(self):
            with self._lock:
                self._thread.join()
"""

_PROPAGATION = {
    "serving/hop.py": """
        import http.client
        import threading

        def outer(deadline, payload):
            return fetch_all(payload)

        def fetch_all(payload):
            conn = http.client.HTTPConnection("replica")
            conn.request("POST", "/predict", payload)
            return conn.getresponse().read()

        def forward(deadline, payload):
            conn = http.client.HTTPConnection("replica")
            conn.request("POST", "/predict", payload)
            return conn.getresponse().read()

        def budgeted(deadline, payload):
            timeout = leg_timeout_s(deadline)
            headers = {"X-Deadline-Ms": str(remaining_ms(deadline))}
            conn = http.client.HTTPConnection("replica", timeout=timeout)
            conn.request("POST", "/predict", payload, headers)
            return conn.getresponse().read()

        def work():
            pass

        def run(tracer):
            with tracer.root_span("req"):
                t = threading.Thread(target=work)
                t.start()
                t.join()

        def pull(counter):
            try:
                failpoint("serving.pull")
                return fetch()
            except Exception:
                return None
    """,
}

_PREDICT_SERVER = """
    class Handler:
        def _send(self, status, body=None, extra_headers=()):
            self.send_response(status)
            for name, value in extra_headers:
                self.send_header(name, value)

        def do_POST(self):
            if self.path == "/predict":
                self._send(200, {"forecast": []})
                return
            self._send(404)
"""

_SHED_SERVER = """
    class Handler:
        def _send(self, status, extra_headers=()):
            self.send_response(status)
            for name, value in extra_headers:
                self.send_header(name, value)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200)
                return
            if self.path == "/status":
                budget = self.headers.get("X-Budget-Ms")
                self._send(200, extra_headers=(("X-Served-By", "me"),))
                return
            self._send(503)
"""

# rule -> (files, lint targets): each tree raises its rule at least once
FIXTURES = {
    "unlocked-shared-state": ({"monitoring/box.py": _RACY},
                              ["monitoring/box.py"]),
    "nondeterminism": ({"ops/noise.py": _NOISY,
                        "workflows/noise.py": _NOISY},
                       ["ops/noise.py", "workflows/noise.py"]),
    "config-drift": (_CONFIG, ["src/consume.py"]),
    "metrics-merge-drift": (_METRICS, ["serving/fleet.py",
                                       "monitoring/metrics.py"]),
    "failpoint-site-drift": (_FAILPOINTS, ["serving/wal.py",
                                           "scripts/chaos_harness.py",
                                           "docs/resilience.md"]),
    "span-kind-drift": (_SPANS, ["serving/server.py",
                                 "docs/observability.md"]),
    "lock-order-cycle": ({"serving/locks.py": _LOCK_CYCLE},
                         ["serving/locks.py"]),
    "blocking-under-lock": ({"serving/state.py": _BLOCKING},
                            ["serving/state.py"]),
    "deadline-propagation": (_PROPAGATION, ["serving"]),
    "trace-context-loss": (_PROPAGATION, ["serving"]),
    "error-path-accounting": (_PROPAGATION, ["serving"]),
    "proto-unserved-route": ({"serving/server.py": _PREDICT_SERVER,
                              "serving/client.py": _client("/forecast_v2")},
                             ["serving"]),
    "proto-status-drift": ({"serving/server.py": _PREDICT_SERVER,
                            "serving/client.py": _client("/predict", "GET",
                                                         status=418)},
                           ["serving"]),
    "proto-retry-after": ({"serving/server.py": _SHED_SERVER,
                           "serving/client.py": _client("/healthz", "GET")},
                          ["serving"]),
    "proto-header-drift": ({"serving/server.py": _SHED_SERVER,
                            "serving/client.py": _client("/status", "GET")},
                           ["serving"]),
    "proto-endpoint-table-drift": ({"serving/server.py": _PREDICT_SERVER,
                                    "serving/client.py": _client("/predict")},
                                   ["serving"]),
}


def _endpoint_doc(tmp_path) -> None:
    """docs/serving.md with the generated table less its last row and a
    stale one added (the reference's generator writes it)."""
    proj = ref_core.build_project(str(tmp_path), [str(tmp_path)])
    table = ref_protocol.render_endpoint_table(
        ref_protocol.get_protocol_analysis(proj).routes)
    rows = table[:-1] + ["| `/zombie` | GET | 200 | — | — |"]
    (tmp_path / "docs").mkdir(exist_ok=True)
    (tmp_path / "docs" / "serving.md").write_text(
        "# Serving\n\n## Endpoint contract\n\n" + "\n".join(rows)
        + "\n\n## Configuration\n\nnone\n")


def _renamed(f) -> str:
    """The message the port gives for the reference's finding ``f``."""
    msg = f.message
    for rule, theirs, ours in RENAMED:
        if f.rule == rule:
            msg = msg.replace(theirs, ours)
    return msg


def _both(tmp_path, targets, config=None):
    paths = [str(tmp_path / t) for t in targets]
    want = [f for f in ref.lint_paths(paths, root=str(tmp_path),
                                      config=config)
            if f.rule not in JAX_ONLY]
    got = port.lint_paths(paths, root=str(tmp_path), config=config)
    return got, want


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_findings_equal_the_reference(rule, tmp_path):
    files, targets = FIXTURES[rule]
    _write(tmp_path, files)
    if rule == "proto-endpoint-table-drift":
        _endpoint_doc(tmp_path)
        targets = targets + ["docs/serving.md"]
    got, want = _both(tmp_path, targets)
    assert any(f.rule == rule for f in got), [f.render() for f in got]
    key = lambda f: (f.rule, f.path, f.line, f.severity)  # noqa: E731
    assert [key(f) for f in got] == [key(f) for f in want]
    for g, w in zip(got, want):
        assert g.message == _renamed(w)
        assert (g.snippet, g.related) == (w.snippet, w.related)


def test_registry_is_the_reference_minus_the_jax_only_rules():
    assert JAX_ONLY <= set(ref.REGISTRY)
    assert set(port.REGISTRY) == set(ref.REGISTRY) - JAX_ONLY
    for name, cls in port.REGISTRY.items():
        theirs = ref.REGISTRY[name]
        assert cls.default_severity == theirs.default_severity, name
        assert cls.dir_names == theirs.dir_names, name
        assert cls.__name__ == theirs.__name__, name
    assert port.__all__ == ref.__all__


@pytest.mark.parametrize("lines, line, rule", [
    (["x = 1  # dflint: disable=nondeterminism"], 1, "nondeterminism"),
    (["# dflint: disable=all", "x = 1"], 2, "config-drift"),
    (["y = 1  # dflint: disable=nondeterminism", "z = 2"], 2,
     "nondeterminism"),
    (["# dflint: disable=lock-order-cycle, nondeterminism", "z = 2"], 2,
     "nondeterminism"),
    (["# dflint: disable=lock-order-cycle", "z = 2"], 2, "nondeterminism"),
    (["x = 1  # dflint: disable=unlocked-shared-state — a reason"], 1,
     "unlocked-shared-state"),
])
def test_suppression_matches_the_reference(lines, line, rule):
    f = port_core.Finding(rule=rule, severity="error", path="p.py",
                          line=line, message="m", snippet=lines[line - 1])
    g = ref_core.Finding(**f.to_dict())
    assert port_core.is_suppressed(f, lines) == ref_core.is_suppressed(
        g, lines)
    assert port_core.suppression_map(lines) == ref_core.suppression_map(lines)


def test_inline_suppression_silences_a_fixture_in_both(tmp_path):
    _write(tmp_path, {"monitoring/box.py": _RACY.replace(
        "return self._n",
        "return self._n  # dflint: disable=unlocked-shared-state")})
    got, want = _both(tmp_path, ["monitoring/box.py"])
    assert [f.line for f in got] == [f.line for f in want]
    assert len(got) == 1


def test_baseline_format_and_multiset_match_the_reference(tmp_path):
    mk = lambda mod, line, snip: mod.Finding(  # noqa: E731
        rule="r", severity="error", path="p.py", line=line, message="m",
        snippet=snip)
    findings = [mk(port_core, 9, "bad()"), mk(port_core, 3, "bad()"),
                mk(port_core, 5, "other()")]
    port_core.write_baseline(str(tmp_path / "port.json"), findings)
    ref_core.write_baseline(str(tmp_path / "ref.json"),
                            [ref_core.Finding(**f.to_dict())
                             for f in findings])
    assert (tmp_path / "port.json").read_bytes() == (
        tmp_path / "ref.json").read_bytes()
    base = port_core.load_baseline(str(tmp_path / "port.json"))
    assert base == ref_core.load_baseline(str(tmp_path / "port.json"))
    # each entry absorbs one occurrence: a third copy still fails
    kept, absorbed = port_core.apply_baseline(
        findings + [mk(port_core, 12, "bad()")], base)
    assert absorbed == 3 and [f.line for f in kept] == [12]


def test_pyproject_block_reads_as_the_reference_reads_it():
    path = os.path.join(ROOT, "pyproject.toml")
    mine = port.DflintConfig.from_pyproject(path)
    theirs = ref.DflintConfig.from_pyproject(path)
    assert mine == port.DflintConfig(**dataclasses.asdict(theirs))
    with pytest.raises(ValueError, match="diable"):
        port.DflintConfig.from_dict({"diable": ["nondeterminism"]})
    with pytest.raises(ValueError, match="must be one of"):
        port.DflintConfig.from_dict({"severity": {"nondeterminism": "x"}})
    # a JAX-only rule is not one of the port's
    with pytest.raises(ValueError, match="unknown rule"):
        port.DflintConfig.from_dict({"disable": ["tracer-leak"]})


def test_severity_override_and_disable_match_the_reference(tmp_path):
    _write(tmp_path, {"monitoring/box.py": _RACY})
    block = {"severity": {"unlocked-shared-state": "warning"}}
    paths = [str(tmp_path / "monitoring/box.py")]
    got = port.lint_paths(paths, root=str(tmp_path),
                          config=port.DflintConfig.from_dict(block))
    want = ref.lint_paths(paths, root=str(tmp_path),
                          config=ref.DflintConfig.from_dict(block))
    assert [(f.line, f.severity) for f in got] == [
        (f.line, f.severity) for f in want]
    assert {f.severity for f in got} == {"warning"}
    assert port.lint_paths(paths, root=str(tmp_path),
                           config=port.DflintConfig.from_dict(
                               {"disable": ["unlocked-shared-state"]})) == []


def test_sarif_log_matches_the_reference(tmp_path):
    _write(tmp_path, _PROPAGATION)
    got, want = _both(tmp_path, ["serving"])
    mine = port_sarif.to_sarif(got)
    theirs = ref_sarif.to_sarif(want)
    assert (mine["$schema"], mine["version"]) == (
        theirs["$schema"], theirs["version"]) == (
        ref_sarif.SARIF_SCHEMA, "2.1.0")
    (run,), (ref_run,) = mine["runs"], theirs["runs"]
    rules = run["tool"]["driver"]["rules"]
    assert [r["id"] for r in rules] == sorted(port.REGISTRY)
    by_id = {r["id"]: r for r in ref_run["tool"]["driver"]["rules"]}
    assert all(r == by_id[r["id"]] for r in rules)

    def resolved(r, descriptors):
        r = dict(r)
        assert descriptors[r.pop("ruleIndex")]["id"] == r["ruleId"]
        return r

    assert [resolved(r, rules) for r in run["results"]] == [
        resolved(r, ref_run["tool"]["driver"]["rules"])
        for r in ref_run["results"]]
    assert any("codeFlows" in r for r in run["results"])


@pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
def test_cli_exit_codes_match_the_reference(tmp_path, capsys, fmt):
    _write(tmp_path, {"monitoring/box.py": _RACY, "ops/ok.py": "x = 1\n"})
    codes = {}
    for name, cli in (("port", port_cli), ("ref", ref_cli)):
        base = ["--root", str(tmp_path), "--format", fmt]
        dirty = [str(tmp_path / "monitoring")] + base
        clean = [str(tmp_path / "ops")] + base
        codes[name] = [cli.main(clean)]
        capsys.readouterr()
        codes[name].append(cli.main(dirty))
        out = capsys.readouterr().out
        if fmt == "json":
            assert json.loads(out)["counts"] == {"error": 2, "warning": 0}
        elif fmt == "sarif":
            assert json.loads(out)["version"] == "2.1.0"
    assert codes["port"] == codes["ref"] == [0, 1]


def test_cli_baseline_round_trip_and_usage_errors(tmp_path, capsys):
    _write(tmp_path, {"monitoring/box.py": _RACY})
    argv = [str(tmp_path / "monitoring"), "--root", str(tmp_path)]
    assert port_cli.main(argv) == 1
    assert port_cli.main(argv + ["--write-baseline"]) == 0
    assert port_cli.main(argv) == 0  # grandfathered
    assert ref_cli.main(argv) == 0   # the same file reads the same
    assert port_cli.main(argv + ["--no-baseline"]) == 1
    capsys.readouterr()
    # a bad [tool.dflint] block and no lint target are usage errors
    (tmp_path / "pyproject.toml").write_text(
        '[tool.dflint]\ndiable = ["nondeterminism"]\n')
    assert port_cli.main(argv) == 2
    assert "config error" in capsys.readouterr().err
    (tmp_path / "pyproject.toml").unlink()
    assert port_cli.main([str(tmp_path / "missing"), "--root",
                          str(tmp_path)]) == 2
    capsys.readouterr()


def test_cli_lists_the_port_s_rules_and_flags_syntax_errors(tmp_path,
                                                          capsys):
    assert port_cli.main(["--list-rules"]) == 0
    listed = [line.split()[0]
              for line in capsys.readouterr().out.splitlines()]
    assert listed == sorted(port.REGISTRY)
    _write(tmp_path, {"ops/broken.py": "def f(:\n"})
    assert port_cli.main([str(tmp_path / "ops"), "--root",
                          str(tmp_path)]) == 1
    assert "syntax-error" in capsys.readouterr().out


def test_cli_default_target_is_the_port_package(tmp_path, capsys):
    pkg = tmp_path / "distributed_forecasting_tpu_torch"
    _write(tmp_path, {"distributed_forecasting_tpu_torch/monitoring/box.py":
                      _RACY,
                      "distributed_forecasting_tpu/monitoring/ok.py":
                      "x = 1\n"})
    assert pkg.is_dir()
    assert port_cli.main(["--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "distributed_forecasting_tpu_torch/monitoring/box.py" in out


# -- the port-only clauses ----------------------------------------------------

def test_torch_draws_without_a_generator_are_nondeterminism(tmp_path):
    draws = """
        import torch
        from torch import randn_like

        def noisy(x, g):
            a = torch.rand(3)
            b = torch.randn(2, 2, device=x.device)
            c = torch.randint(0, 5, (4,))
            d = torch.randperm(7)
            e = randn_like(x)
            f = torch.normal(x, 1.0)
            h = torch.bernoulli(x)
            i = torch.multinomial(x, 2)
            j = torch.poisson(x)
            k = torch.rand_like(x) + torch.randint_like(x, 3)
            return a, b, c, d, e, f, h, i, j, k

        def seeded(x, g):
            return (torch.rand(3, generator=g)
                    + torch.randn(3, generator=g)
                    + torch.normal(x, 1.0, generator=g)
                    + torch.zeros(3) + torch.ones_like(x))
    """
    _write(tmp_path, {"models/draws.py": draws, "serving/draws.py": draws})
    found = port.lint_paths([str(tmp_path / "models"),
                             str(tmp_path / "serving")], root=str(tmp_path))
    assert {f.path for f in found} == {"models/draws.py"}
    assert [f.rule for f in found] == ["nondeterminism"] * 11
    lines = {f.line for f in found}
    assert len(lines) == 10  # line k holds two draws
    assert all("generator=" in f.message for f in found)
    assert "torch.randn_like()" in " ".join(f.message for f in found)
    # the reference has no torch clause: the same tree is clean there
    assert ref.lint_paths([str(tmp_path / "models")],
                          root=str(tmp_path)) == []


def test_device_syncs_under_a_lock_are_blocking(tmp_path):
    _write(tmp_path, {"serving/sync.py": """
        import threading
        import torch

        L = threading.Lock()

        def drain(event, stream):
            with L:
                torch.cuda.synchronize()
                event.synchronize()
                torch.cuda.current_stream().synchronize()

        def outside(event):
            torch.cuda.synchronize()
            event.synchronize()
            with L:
                pass
    """})
    found = port.lint_paths([str(tmp_path / "serving")], root=str(tmp_path))
    assert [(f.rule, f.line) for f in found] == [
        ("blocking-under-lock", 9), ("blocking-under-lock", 10),
        ("blocking-under-lock", 11)]
    assert "torch.cuda.synchronize() (device sync)" in found[0].message
    assert ".synchronize() (device sync)" in found[1].message


def test_a_module_lock_and_a_class_lock_of_one_file_sort(tmp_path):
    """Both acquired under a third lock: the lock-order pass orders a
    module global's id (owner None) before a class's (the reference's raw
    tuple sort raises TypeError here), and a real cycle through them is
    still found."""
    _write(tmp_path, {"serving/mixed.py": """
        import threading

        G = threading.Lock()
        M = threading.Lock()

        class Box:
            def __init__(self):
                self._l = threading.Lock()

            def both(self):
                with M:
                    with G:
                        pass
                    with self._l:
                        pass

            def back(self):
                with self._l:
                    with M:
                        pass
    """})
    found = port.lint_paths([str(tmp_path / "serving")], root=str(tmp_path))
    assert [(f.rule, f.line) for f in found] == [
        ("lock-order-cycle", 15), ("lock-order-cycle", 20)]


def test_analysis_package_never_imports_torch_numpy_pandas_or_jax():
    code = (
        "import sys; import distributed_forecasting_tpu_torch.analysis; "
        "import distributed_forecasting_tpu_torch.analysis.cli; "
        "mods = {m.split('.')[0] for m in sys.modules}; "
        "bad = mods & {'torch', 'jax', 'jaxlib', 'numpy', 'pandas', "
        "'distributed_forecasting_tpu'}; "
        "print(sorted(bad)); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
