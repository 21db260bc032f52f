"""dflint v3: catalogue-drift rules.

Sixteen PRs have accreted three catalogues that are load-bearing but were
only ever policed by review: the fleet's gauge merge policy
(``serving/fleet.py::aggregate_prometheus``), the failpoint site table
(``docs/resilience.md``), and the span catalog
(``docs/observability.md``).  Each of these has a silent failure mode —
a new ``dftpu_*`` gauge falls into counter-sum semantics, a failpoint is
armed that no code site fires, a span is emitted that no runbook
explains.  These rules make every one of those a lint error, in both
directions (code missing from the catalogue AND catalogue rows with no
code behind them).

All three are whole-project rules over string literals — registration
calls, ``failpoint("...")`` sites, ``tracer.span("...")`` sites — joined
against either policy constants (``_GAUGE_MAX_MERGE`` /
``_GAUGE_SUM_MERGE`` / ``_GAUGE_*_PREFIXES``) or a markdown table's
backticked first-column names.  A project with no policy constants / no
catalogue doc is out of scope and lints clean (the fixture trees in
tests/unit/test_dflint*.py must stay unaffected).

Pure AST + stdlib.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Tuple

from distributed_forecasting_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Project,
    Rule,
    register,
)

#: registration method name -> prometheus family kind
_METRIC_CTORS = {
    "gauge": "gauge",
    "labeled_gauge": "gauge",
    "counter": "counter",
    "labeled_counter": "counter",
    "histogram": "histogram",
}

#: policy constant name -> merge policy; sets name metrics, prefixes
#: cover namespaces
_POLICY_SETS = {
    "_GAUGE_MAX_MERGE": "max",
    "_GAUGE_SUM_MERGE": "sum",
    "_GAUGE_REPLICATE_MERGE": "replicate",
}
_POLICY_PREFIXES = {
    "_GAUGE_MAX_PREFIX": "max",
    "_GAUGE_MAX_PREFIXES": "max",
    "_GAUGE_SUM_PREFIX": "sum",
    "_GAUGE_SUM_PREFIXES": "sum",
    "_GAUGE_REPLICATE_PREFIX": "replicate",
    "_GAUGE_REPLICATE_PREFIXES": "replicate",
}

_BACKTICK_NAME = re.compile(r"`([a-z0-9_]+(?:\.[a-z0-9_]+)+)`")
_FAILPOINT_TERM = re.compile(
    r"(?:^|[;\n])\s*([a-z0-9_.]+)\s*=\s*(?:raise|sleep|corrupt|kill9)\b")


def _is_test_module(module: ModuleInfo) -> bool:
    return ("tests" in module.segments[:-1]
            or module.segments[-1].startswith("test_")
            or module.segments[-1] == "conftest.py")


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _string_constants(node: ast.AST) -> Iterable[ast.Constant]:
    """Every string constant inside a (possibly wrapped) collection
    literal: ``frozenset({...})``, ``{...}``, ``(...)``, ``[...]`` — and a
    bare string constant itself."""
    if isinstance(node, ast.Call) and node.args:
        yield from _string_constants(node.args[0])
        return
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _string_constants(elt)
        return
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node


def _doc_table(project: Project, relpath: str, section: str,
               ) -> Tuple[bool, Dict[str, int]]:
    """(doc exists, {backticked dotted name in a row's FIRST cell ->
    line}) for the markdown table under ``## <section>``."""
    lines = project.read_lines(relpath)
    if not lines:
        return False, {}
    names: Dict[str, int] = {}
    in_section = False
    for i, line in enumerate(lines, start=1):
        stripped = line.strip()
        if stripped.startswith("## "):
            in_section = stripped[3:].strip() == section
            continue
        if not in_section or not stripped.startswith("|"):
            continue
        cells = stripped.split("|")
        if len(cells) < 2:
            continue
        first = cells[1]
        if set(first.strip()) <= {"-", " ", ":"}:
            continue  # the header separator row
        for m in _BACKTICK_NAME.finditer(first):
            names.setdefault(m.group(1), i)
    return True, names


# ---------------------------------------------------------------------------
# metrics-merge-drift
# ---------------------------------------------------------------------------


@register
class MetricsMergeDrift(Rule):
    """Every ``dftpu_*`` gauge must carry an explicit fleet-merge policy
    (sum/max/replicate) in aggregate_prometheus's policy constants —
    an unpoliced gauge silently falls into counter-sum semantics."""

    name = "metrics-merge-drift"
    default_severity = "error"

    def check_project(self, project: Project) -> List[Finding]:
        # policy constants, wherever they are assigned at module top level
        sets: Dict[str, Dict[str, Tuple[ModuleInfo, ast.Constant]]] = {
            "max": {}, "sum": {}, "replicate": {}}
        prefixes: Dict[str, List[str]] = {"max": [], "sum": [],
                                          "replicate": []}
        found_policy = False
        for module in project.all_modules:
            if module.tree is None or _is_test_module(module):
                continue
            for node in module.tree.body:
                if not isinstance(node, ast.Assign):
                    continue
                for target in node.targets:
                    if not isinstance(target, ast.Name):
                        continue
                    policy = _POLICY_SETS.get(target.id)
                    if policy is not None:
                        found_policy = True
                        for c in _string_constants(node.value):
                            sets[policy].setdefault(c.value, (module, c))
                    policy = _POLICY_PREFIXES.get(target.id)
                    if policy is not None:
                        found_policy = True
                        for c in _string_constants(node.value):
                            prefixes[policy].append(c.value)
        if not found_policy:
            return []  # no merge policy in this project: out of scope

        # statically registered metric families (literal names only)
        declared: Dict[str, Tuple[str, ModuleInfo, ast.Call]] = {}
        for module in project.all_modules:
            if module.tree is None or _is_test_module(module):
                continue
            for node in ast.walk(module.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                kind = _METRIC_CTORS.get(node.func.attr)
                if kind is None or not node.args:
                    continue
                name = _literal_str(node.args[0])
                if name is not None:
                    declared.setdefault(name, (kind, module, node))

        out: List[Finding] = []

        def covered_by_prefix(name: str) -> bool:
            return any(name.startswith(p)
                       for ps in prefixes.values() for p in ps)

        for name, (kind, module, node) in sorted(declared.items()):
            if kind != "gauge" or not name.startswith("dftpu_"):
                continue  # counters/histograms sum by TYPE — that IS the
                #           explicit policy for them
            in_sets = [p for p in sets if name in sets[p]]
            if len(in_sets) > 1:
                out.append(self.finding(module, node, (
                    f"gauge {name!r} appears in multiple merge policies "
                    f"({', '.join(sorted(in_sets))}) — aggregate_prometheus "
                    f"applies whichever matches first; keep exactly one")))
            elif not in_sets and not covered_by_prefix(name):
                out.append(self.finding(module, node, (
                    f"gauge {name!r} has no explicit fleet-merge policy — "
                    f"it silently falls into counter-sum semantics in "
                    f"aggregate_prometheus; add it to _GAUGE_SUM_MERGE "
                    f"(partition semantics), _GAUGE_MAX_MERGE (shared or "
                    f"worst-replica state), or a replicate/max prefix")))

        for policy, entries in sorted(sets.items()):
            for name, (module, node) in sorted(entries.items()):
                hit = declared.get(name)
                if hit is None:
                    out.append(self.finding(module, node, (
                        f"merge policy ({policy}) names {name!r} but no "
                        f"statically registered metric carries that name — "
                        f"stale entry, or the registration renamed; drop "
                        f"or fix it")))
                elif hit[0] != "gauge":
                    out.append(self.finding(module, node, (
                        f"merge policy ({policy}) names {name!r} which is "
                        f"registered as a {hit[0]} — non-gauge families "
                        f"always sum by TYPE, this entry is dead")))
        return out


# ---------------------------------------------------------------------------
# failpoint-site-drift
# ---------------------------------------------------------------------------


@register
class FailpointSiteDrift(Rule):
    """Failpoint names must agree across code sites, the
    docs/resilience.md catalogue, and the chaos-harness arm specs —
    both directions."""

    name = "failpoint-site-drift"
    default_severity = "error"

    doc_path = "docs/resilience.md"
    doc_section = "Failpoint catalogue"

    def check_project(self, project: Project) -> List[Finding]:
        doc_exists, doc_names = _doc_table(project, self.doc_path,
                                           self.doc_section)
        if not doc_exists:
            return []  # no catalogue in this project: out of scope

        # code sites: failpoint("name") / failpoint_data("name", ...)
        sites: Dict[str, Tuple[ModuleInfo, ast.Call]] = {}
        for module in project.all_modules:
            if (module.tree is None or _is_test_module(module)
                    or module.relpath.endswith("monitoring/failpoints.py")):
                continue
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fn = node.func
                callee = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else None)
                if callee not in ("failpoint", "failpoint_data"):
                    continue
                name = _literal_str(node.args[0])
                if name is not None:
                    sites.setdefault(name, (module, node))

        # names the chaos harness arms (any spec-shaped string literal)
        armed: Dict[str, Tuple[ModuleInfo, ast.Constant]] = {}
        for module in project.all_modules:
            if module.tree is None or \
                    module.segments[-1] != "chaos_harness.py":
                continue
            for node in ast.walk(module.tree):
                if isinstance(node, ast.Constant) and \
                        isinstance(node.value, str):
                    for m in _FAILPOINT_TERM.finditer(node.value):
                        armed.setdefault(m.group(1), (module, node))

        out: List[Finding] = []
        for name, (module, node) in sorted(sites.items()):
            if name not in doc_names:
                out.append(self.finding(module, node, (
                    f"failpoint site {name!r} is not in the "
                    f"{self.doc_path} catalogue — every site must be "
                    f"documented (boundary it models, activation example)")))
        for name, line in sorted(doc_names.items()):
            if name not in sites:
                out.append(Finding(
                    rule=self.name, severity=self.default_severity,
                    path=self.doc_path, line=line,
                    message=(f"{self.doc_path} catalogues failpoint "
                             f"{name!r} but no code site fires it — stale "
                             f"row, or the site lost its literal name"),
                    snippet=_doc_snippet(project, self.doc_path, line)))
        for name, (module, node) in sorted(armed.items()):
            if name not in sites:
                out.append(self.finding(module, node, (
                    f"chaos harness arms failpoint {name!r} but no code "
                    f"site carries that name — the scenario injects "
                    f"nothing and its invariant check is vacuous")))
        return out


# ---------------------------------------------------------------------------
# span-kind-drift
# ---------------------------------------------------------------------------


@register
class SpanKindDrift(Rule):
    """Span kinds emitted through monitoring/trace.py must match the
    docs/observability.md span catalog — both directions."""

    name = "span-kind-drift"
    default_severity = "error"

    doc_path = "docs/observability.md"
    doc_section = "Span catalog"

    def check_project(self, project: Project) -> List[Finding]:
        doc_exists, doc_names = _doc_table(project, self.doc_path,
                                           self.doc_section)
        if not doc_exists:
            return []

        emitted: Dict[str, Tuple[ModuleInfo, ast.Call]] = {}
        for module in project.all_modules:
            if (module.tree is None or _is_test_module(module)
                    or module.relpath.endswith("monitoring/trace.py")):
                continue
            for node in ast.walk(module.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("span", "root_span",
                                               "record_span")
                        and node.args):
                    continue
                if not _tracer_receiver(node.func.value):
                    continue  # m.span(1) on a regex match etc.
                name = _literal_str(node.args[0])
                if name is not None:
                    emitted.setdefault(name, (module, node))

        out: List[Finding] = []
        for name, (module, node) in sorted(emitted.items()):
            if name not in doc_names:
                out.append(self.finding(module, node, (
                    f"span kind {name!r} is emitted but missing from the "
                    f"{self.doc_path} span catalog — add a row (thread, "
                    f"meaning, key attrs)")))
        for name, line in sorted(doc_names.items()):
            if name not in emitted:
                out.append(Finding(
                    rule=self.name, severity=self.default_severity,
                    path=self.doc_path, line=line,
                    message=(f"{self.doc_path} catalogues span kind "
                             f"{name!r} but nothing emits it — stale row, "
                             f"or the emit site lost its literal name"),
                    snippet=_doc_snippet(project, self.doc_path, line)))
        return out


def _tracer_receiver(expr: ast.AST) -> bool:
    """``tracer.span`` / ``get_tracer().span`` / ``self._tracer.span`` —
    anything whose receiver name mentions a tracer."""
    if isinstance(expr, ast.Name):
        return "tracer" in expr.id
    if isinstance(expr, ast.Attribute):
        return "tracer" in expr.attr
    if isinstance(expr, ast.Call):
        fn = expr.func
        if isinstance(fn, ast.Name):
            return "tracer" in fn.id
        if isinstance(fn, ast.Attribute):
            return "tracer" in fn.attr
    return False


def _doc_snippet(project: Project, relpath: str, line: int) -> str:
    lines = project.read_lines(relpath)
    if 1 <= line <= len(lines):
        return lines[line - 1].strip()
    return ""
