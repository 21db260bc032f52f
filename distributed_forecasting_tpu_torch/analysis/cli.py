"""dflint command line — text/JSON/SARIF output, git-scoped linting,
baseline management, CI codes.

Exit codes: 0 clean (warnings allowed), 1 at least one error-severity
finding survived suppressions + baseline, 2 bad invocation or bad
[tool.dflint] config.  ``python -m distributed_forecasting_tpu_torch.analysis.cli``
and tests/test_torch_analysis_tree.py both drive this entry point, so its
behavior IS the CI contract.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from distributed_forecasting_tpu_torch.analysis.core import (
    REGISTRY,
    DflintConfig,
    analyze,
    apply_baseline,
    build_project,
    find_root,
    load_baseline,
    write_baseline,
)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dflint",
        description=("Repo-native static analysis of the PyTorch port "
                     "(docs/static-analysis.md)"),
    )
    p.add_argument("paths", nargs="*",
                   help="files/directories to lint (default: the "
                        "distributed_forecasting_tpu_torch package under "
                        "the root)")
    p.add_argument("--root", default=None,
                   help="project root (default: nearest ancestor with a "
                        "pyproject.toml)")
    p.add_argument("--conf-dir", default=None,
                   help="YAML conf tree for config-drift (default: "
                        "<root>/conf)")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text",
                   help="sarif emits a SARIF 2.1.0 log on stdout "
                        "(redirect into a file for code-scanning upload)")
    p.add_argument("--changed-only", action="store_true",
                   help="lint only Python files changed vs --diff-base "
                        "(plus untracked ones); clean exit when nothing "
                        "under the targets changed")
    p.add_argument("--diff-base", default="HEAD",
                   help="git rev the --changed-only diff is taken against "
                        "(default: HEAD, i.e. uncommitted work; CI passes "
                        "the PR base)")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather every current finding into the "
                        "baseline file and exit 0")
    p.add_argument("--no-baseline", action="store_true",
                   help="report baselined findings too")
    p.add_argument("--list-rules", action="store_true")
    return p


def _changed_files(root: str, base: str) -> Optional[List[str]]:
    """Root-relative posix paths of .py files changed vs ``base`` plus
    untracked ones, or None when git cannot answer (not a checkout, bad
    rev).  Deleted files are excluded — there is nothing left to lint."""
    import subprocess

    out: List[str] = []
    for cmd in (
        ["git", "diff", "--name-only", "--diff-filter=d", base, "--", "*.py"],
        ["git", "ls-files", "--others", "--exclude-standard", "--", "*.py"],
    ):
        try:
            proc = subprocess.run(cmd, cwd=root, capture_output=True,
                                  text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        out.extend(line.strip() for line in proc.stdout.splitlines()
                   if line.strip())
    return sorted(set(out))


def _under_targets(relpath: str, root: str, targets: List[str]) -> bool:
    for t in targets:
        trel = os.path.relpath(os.path.abspath(t), root).replace(os.sep, "/")
        if trel == ".":
            return True
        if relpath == trel or relpath.startswith(trel + "/"):
            return True
    return False


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.list_rules:
        for name in sorted(REGISTRY):
            rule = REGISTRY[name]()
            scope = ", ".join(sorted(rule.dir_names)) or "all modules"
            print(f"{name:24s} [{rule.default_severity}] scope: {scope}")
        return 0

    start = args.root or (args.paths[0] if args.paths else os.getcwd())
    root = os.path.abspath(args.root) if args.root else find_root(start)
    try:
        config = DflintConfig.from_pyproject(
            os.path.join(root, "pyproject.toml"))
    except ValueError as e:
        print(f"dflint: config error: {e}", file=sys.stderr)
        return 2

    targets = args.paths or [
        os.path.join(root, "distributed_forecasting_tpu_torch")]
    targets = [t for t in targets if os.path.exists(t)]
    if not targets:
        print("dflint: no lint targets exist", file=sys.stderr)
        return 2

    if args.changed_only:
        changed = _changed_files(root, args.diff_base)
        if changed is None:
            print(f"dflint: --changed-only: git diff against "
                  f"{args.diff_base!r} failed (not a checkout, or bad rev)",
                  file=sys.stderr)
            return 2
        narrowed = [os.path.join(root, c) for c in changed
                    if _under_targets(c, root, targets)
                    and os.path.exists(os.path.join(root, c))]
        if not narrowed:
            if args.format == "text":
                print("dflint: no changed Python files under the lint "
                      "targets — nothing to do")
            targets = []
        else:
            targets = narrowed
        if not targets:
            if args.format == "sarif":
                from distributed_forecasting_tpu_torch.analysis.sarif import to_sarif
                print(json.dumps(to_sarif([]), indent=2))
            elif args.format == "json":
                print(json.dumps({"findings": [], "counts": {
                    "error": 0, "warning": 0}, "suppressed": 0,
                    "baselined": 0}, indent=2))
            return 0

    project = build_project(root, targets, config=config,
                            conf_dir=args.conf_dir)
    findings, suppressed = analyze(project)

    baseline_path = os.path.join(root, config.baseline)
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"dflint: wrote {len(findings)} finding(s) to "
              f"{os.path.relpath(baseline_path, root)}")
        return 0

    absorbed = 0
    if not args.no_baseline:
        findings, absorbed = apply_baseline(findings,
                                            load_baseline(baseline_path))

    errors = [f for f in findings if f.severity == "error"]
    warnings = [f for f in findings if f.severity != "error"]
    if args.format == "sarif":
        from distributed_forecasting_tpu_torch.analysis.sarif import to_sarif
        print(json.dumps(to_sarif(findings), indent=2))
    elif args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "counts": {"error": len(errors), "warning": len(warnings)},
            "suppressed": suppressed,
            "baselined": absorbed,
        }, indent=2))
    else:
        for f in findings:
            print(f.render())
        tail = (f"dflint: {len(errors)} error(s), {len(warnings)} "
                f"warning(s)")
        if suppressed or absorbed:
            tail += (f" ({suppressed} suppressed inline, "
                     f"{absorbed} baselined)")
        print(tail)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
