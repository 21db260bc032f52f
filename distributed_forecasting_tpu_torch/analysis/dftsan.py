"""dftsan analysis side: join the observed lock graph against the static
model and render runtime findings through the dflint pipeline.

``monitoring/sanitizer.py`` (the runtime half) writes a JSON event report
per instrumented process: every lock acquisition edge it observed, hold
statistics, and every guarded-attribute access made without the owning
lock.  This module loads one or more of those reports, rebuilds the
STATIC acquired-while-holding graph with ``rules_lockorder``'s analysis
(the lock ids match by construction — ``(relpath, class, attr)`` on both
sides), and emits three runtime-fed rules:

* ``dftsan-unlocked-access`` (error) — a guarded attribute was read or
  written without its lock, with thread + stack provenance;
* ``dftsan-cycle-confirmed`` (error) — an observed edge lies inside a
  static lock-order SCC: the modeled deadlock is REACHABLE, not
  hypothetical;
* ``dftsan-unmodeled-edge`` (warning) — the runtime acquired B while
  holding A but the static graph has no such edge: the model is
  incomplete (an untracked call path, or lock use the AST rules cannot
  see) and should be updated before it is trusted.

Findings reuse everything dflint already has: inline
``# dflint: disable=<rule>`` suppressions at the reported site, the
checked-in baseline, ``--format text|json|sarif`` (the rules are in
``REGISTRY`` so SARIF gets descriptors), and the 0/1/2 exit-code
contract.  ``chip_smoke.py`` phase 24 runs an armed serving workload on
the card and then this CLI over the report directory
(``python -m distributed_forecasting_tpu_torch.analysis.dftsan <dirs>``).

Pure stdlib + the analysis package: this module never imports the
runtime sanitizer (that would drag torch and numpy in through the
monitoring package) — the JSON report is the only coupling.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from distributed_forecasting_tpu_torch.analysis.core import (
    DflintConfig,
    Finding,
    Project,
    Rule,
    apply_baseline,
    build_project,
    find_root,
    is_suppressed,
    load_baseline,
    register,
    suppression_map,
    write_baseline,
)
from distributed_forecasting_tpu_torch.analysis.rules_lockorder import (
    LockId,
    _fmt,
    get_lock_analysis,
)

__all__ = ["cross_check", "load_reports", "main"]


# ---------------------------------------------------------------------------
# rule shells — runtime-fed: check_project yields nothing (there is no AST
# to inspect); registering them gives the findings SARIF descriptors,
# --list-rules visibility, and config severity/disable coverage.
# ---------------------------------------------------------------------------


@register
class DftsanUnlockedAccess(Rule):
    """Runtime: a sanitizer-guarded attribute was accessed without the
    owning lock held (see docs/static-analysis.md "Dynamic layer")."""

    name = "dftsan-unlocked-access"
    default_severity = "error"

    def check_project(self, project: Project) -> List[Finding]:
        return []


@register
class DftsanCycleConfirmed(Rule):
    """Runtime: an observed lock edge participates in a statically modeled
    lock-order cycle — the deadlock is reachable, not hypothetical."""

    name = "dftsan-cycle-confirmed"
    default_severity = "error"

    def check_project(self, project: Project) -> List[Finding]:
        return []


@register
class DftsanUnmodeledEdge(Rule):
    """Runtime: the observed lock graph holds an acquired-while-holding
    edge the static model lacks — update the model before trusting it."""

    name = "dftsan-unmodeled-edge"
    default_severity = "warning"

    def check_project(self, project: Project) -> List[Finding]:
        return []


# ---------------------------------------------------------------------------
# report loading / merging
# ---------------------------------------------------------------------------


def _as_lock_id(raw) -> Optional[LockId]:
    if (isinstance(raw, (list, tuple)) and len(raw) == 3
            and isinstance(raw[0], str) and isinstance(raw[2], str)
            and (raw[1] is None or isinstance(raw[1], str))):
        return (raw[0], raw[1], raw[2])
    return None


def load_reports(paths: Sequence[str]) -> Tuple[dict, List[str]]:
    """Merge sanitizer reports (files, or directories globbed for
    ``dftsan-*.json``); returns (merged report, loaded file list)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "*.json"))))
        else:
            files.append(p)
    merged = {"locks": {}, "edges": {}, "violations": {},
              "dropped": {"edges": 0, "violations": 0}}
    loaded: List[str] = []
    for path in files:
        with open(path) as f:
            rep = json.load(f)
        loaded.append(path)
        for entry in rep.get("locks", ()):
            lid = _as_lock_id(entry.get("id"))
            if lid is None:
                continue
            st = merged["locks"].setdefault(lid, {
                "kind": entry.get("kind", "lock"), "acquires": 0,
                "max_hold_ms": 0.0, "threads": set()})
            st["acquires"] += int(entry.get("acquires", 0))
            st["max_hold_ms"] = max(st["max_hold_ms"],
                                    float(entry.get("max_hold_ms", 0.0)))
            st["threads"].update(entry.get("threads", ()))
        for entry in rep.get("edges", ()):
            src = _as_lock_id(entry.get("src"))
            dst = _as_lock_id(entry.get("dst"))
            if src is None or dst is None:
                continue
            key = (src, dst)
            e = merged["edges"].get(key)
            if e is None:
                merged["edges"][key] = {
                    "count": int(entry.get("count", 1)),
                    "path": entry.get("path", "<unknown>"),
                    "line": int(entry.get("line", 1)),
                    "thread": entry.get("thread", "?")}
            else:
                e["count"] += int(entry.get("count", 1))
        for entry in rep.get("violations", ()):
            lid = _as_lock_id(entry.get("lock"))
            if lid is None:
                continue
            key = (lid, entry.get("attr", "?"), entry.get("op", "?"),
                   entry.get("path", "<unknown>"),
                   int(entry.get("line", 1)))
            v = merged["violations"].get(key)
            if v is None:
                merged["violations"][key] = {
                    "count": int(entry.get("count", 1)),
                    "thread": entry.get("thread", "?"),
                    "stack": entry.get("stack", "")}
            else:
                v["count"] += int(entry.get("count", 1))
        for k in ("edges", "violations"):
            merged["dropped"][k] += int(rep.get("dropped", {}).get(k, 0))
    return merged, loaded


# ---------------------------------------------------------------------------
# the join
# ---------------------------------------------------------------------------


def _severity(project: Project, rule: str, default: str) -> str:
    for name, sev in project.config.severity:
        if name == rule:
            return sev
    return default


def _is_test_path(relpath: str) -> bool:
    parts = relpath.replace(os.sep, "/").split("/")
    return ("tests" in parts[:-1]
            or parts[-1].startswith("test_")
            or parts[-1] == "conftest.py")


def cross_check(report: dict, project: Project) -> List[Finding]:
    """Observed graph vs static model + unlocked accesses -> findings.

    Unlocked accesses whose call site is a TEST module are dropped: tests
    legitimately poke guarded internals from a single thread (asserting on
    ``_entries`` after the workload quiesced), and flagging those would
    bury the product-code signal under suppression comments.  Lock-order
    edges keep their test-path sites — the edge exists in product lock
    objects regardless of which thread's stack observed it.
    """
    analysis = get_lock_analysis(project)
    static_edges = {(s, d) for s, d, _, _ in analysis.edges}
    cyclic, sccs = analysis.cycles()
    known_locks = set(analysis.syncs)
    out: List[Finding] = []

    for (src, dst), e in sorted(report.get("edges", {}).items()):
        in_cycle = (src == dst and src in cyclic) or any(
            src in c and dst in c for c in sccs)
        if in_cycle:
            out.append(Finding(
                rule="dftsan-cycle-confirmed",
                severity=_severity(project, "dftsan-cycle-confirmed",
                                   "error"),
                path=e["path"], line=e["line"],
                message=(f"runtime confirmed a statically modeled "
                         f"lock-order cycle: {_fmt(dst)} acquired while "
                         f"holding {_fmt(src)} ({e['count']}x, thread "
                         f"{e['thread']!r}) — the deadlock is reachable, "
                         f"fix the acquisition order"),
                snippet=_snippet(project, e["path"], e["line"])))
        elif (src, dst) not in static_edges and src != dst:
            known = src in known_locks and dst in known_locks
            hint = ("an acquisition path the AST rules cannot resolve"
                    if known else
                    "a lock the static catalogue does not index "
                    "(dynamic attribute, or assigned outside __init__)")
            out.append(Finding(
                rule="dftsan-unmodeled-edge",
                severity=_severity(project, "dftsan-unmodeled-edge",
                                   "warning"),
                path=e["path"], line=e["line"],
                message=(f"observed {_fmt(dst)} acquired while holding "
                         f"{_fmt(src)} ({e['count']}x, thread "
                         f"{e['thread']!r}) but the static lock-order "
                         f"graph has no such edge — {hint}; extend the "
                         f"model or restructure so the order is "
                         f"statically visible"),
                snippet=_snippet(project, e["path"], e["line"])))

    for (lid, attr, op, path, line), v in sorted(
            report.get("violations", {}).items()):
        if _is_test_path(path):
            continue
        out.append(Finding(
            rule="dftsan-unlocked-access",
            severity=_severity(project, "dftsan-unlocked-access", "error"),
            path=path, line=line,
            message=(f"{op} of {lid[1]}.{attr} without holding "
                     f"{_fmt(lid)} ({v['count']}x, thread "
                     f"{v['thread']!r}; stack: {v['stack']}) — take the "
                     f"lock or snapshot under it"),
            snippet=_snippet(project, path, line)))

    out.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return out


def _snippet(project: Project, relpath: str, line: int) -> str:
    lines = project.read_lines(relpath)
    if 1 <= line <= len(lines):
        return lines[line - 1].strip()
    return ""


def _apply_suppressions(project: Project, findings: Sequence[Finding],
                        ) -> Tuple[List[Finding], int]:
    kept: List[Finding] = []
    suppressed = 0
    cache: Dict[str, tuple] = {}
    for f in findings:
        if f.path not in cache:
            lines = project.read_lines(f.path)
            cache[f.path] = (lines, suppression_map(lines))
        lines, smap = cache[f.path]
        if is_suppressed(f, lines, smap):
            suppressed += 1
        else:
            kept.append(f)
    return kept, suppressed


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dftsan",
        description=("Cross-check sanitizer runtime reports against the "
                     "static lock model (docs/static-analysis.md, "
                     "\"Dynamic layer\")"))
    p.add_argument("reports", nargs="+",
                   help="sanitizer JSON report file(s) or directories "
                        "(directories glob *.json)")
    p.add_argument("--root", default=None,
                   help="project root (default: nearest ancestor with a "
                        "pyproject.toml)")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather every current finding into the dflint "
                        "baseline file and exit 0")
    p.add_argument("--no-baseline", action="store_true",
                   help="report baselined findings too")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    root = os.path.abspath(args.root) if args.root else find_root(os.getcwd())
    try:
        config = DflintConfig.from_pyproject(
            os.path.join(root, "pyproject.toml"))
    except ValueError as e:
        print(f"dftsan: config error: {e}", file=sys.stderr)
        return 2

    try:
        report, loaded = load_reports(args.reports)
    except (OSError, json.JSONDecodeError) as e:
        print(f"dftsan: cannot load report(s): {e}", file=sys.stderr)
        return 2
    if not loaded:
        # an instrumented run that produced no report is a broken setup,
        # not a clean one — fail loudly so CI cannot green-wash it
        print("dftsan: no report files found under "
              f"{', '.join(args.reports)}", file=sys.stderr)
        return 2

    project = build_project(
        root, [os.path.join(root, "distributed_forecasting_tpu_torch")],
        config=config)
    findings = cross_check(report, project)
    findings, suppressed = _apply_suppressions(project, findings)

    baseline_path = os.path.join(root, config.baseline)
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"dftsan: wrote {len(findings)} finding(s) to "
              f"{os.path.relpath(baseline_path, root)}")
        return 0
    absorbed = 0
    if not args.no_baseline:
        findings, absorbed = apply_baseline(findings,
                                            load_baseline(baseline_path))

    errors = [f for f in findings if f.severity == "error"]
    warnings = [f for f in findings if f.severity != "error"]
    n_edges = len(report["edges"])
    n_static = sum(
        1 for key in report["edges"]
        if key in {(s, d) for s, d, _, _ in
                   get_lock_analysis(project).edges})
    if args.format == "sarif":
        from distributed_forecasting_tpu_torch.analysis.sarif import to_sarif
        print(json.dumps(to_sarif(findings), indent=2))
    elif args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "counts": {"error": len(errors), "warning": len(warnings)},
            "suppressed": suppressed,
            "baselined": absorbed,
            "observed": {
                "reports": len(loaded),
                "locks": len(report["locks"]),
                "edges": n_edges,
                "modeled_edges": n_static,
                "dropped": report["dropped"],
            },
        }, indent=2))
    else:
        for f in findings:
            print(f.render())
        tail = (f"dftsan: {len(loaded)} report(s), "
                f"{len(report['locks'])} lock(s), {n_edges} edge(s) "
                f"({n_static} modeled) — {len(errors)} error(s), "
                f"{len(warnings)} warning(s)")
        if suppressed or absorbed:
            tail += (f" ({suppressed} suppressed inline, "
                     f"{absorbed} baselined)")
        print(tail)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
