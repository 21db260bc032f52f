"""dflint core: findings, rule registry, suppressions, baseline, config.

The analysis layer is pure AST + stdlib (plus PyYAML/tomli, both already in
the image): importing it must never pull torch, numpy, pandas or jax, so
the lint runs on a machine with no accelerator and cannot accidentally
initialize a device (ROADMAP: tier-1 stays CPU-only and fast).

Vocabulary:

* a :class:`Rule` inspects modules (or the whole project) and yields
  :class:`Finding`\\ s;
* rules self-register into :data:`REGISTRY` via :func:`register` at import;
* findings can be silenced inline (``# dflint: disable=<rule>`` on the
  flagged line, or alone on the line above) or grandfathered in the
  checked-in baseline file (``.dflint-baseline.json``);
* the ``[tool.dflint]`` block in pyproject.toml configures rule
  enable/disable, per-rule severity overrides, and path excludes — unknown
  keys are rejected, same strictness contract as the serving conf
  (serving/batcher.BatchingConfig.from_conf).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning")

#: pseudo-rule used for files the parser rejects; not in REGISTRY but valid
#: in suppressions / severity overrides so a vendored bad file can be waived
SYNTAX_RULE = "syntax-error"

_DEFAULT_EXCLUDES = (
    ".git", "__pycache__", "build", "dist", "native", ".eggs",
)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    path: str          # posix path relative to the project root
    line: int          # 1-based
    message: str
    snippet: str = ""  # stripped source line — the baseline fingerprint key
    #: interprocedural trace: (path, line, message) hops from source to sink,
    #: rendered as SARIF relatedLocations + a codeFlow; excluded from the
    #: fingerprint so a trace reroute doesn't invalidate a baselined finding
    related: Tuple[Tuple[str, int, str], ...] = ()

    def fingerprint(self) -> Tuple[str, str, str]:
        """Line-number-insensitive identity: edits elsewhere in a file must
        not invalidate a grandfathered finding."""
        return (self.rule, self.path, self.snippet)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] "
                f"{self.severity}: {self.message}")


@dataclasses.dataclass
class ModuleInfo:
    path: str                 # absolute
    relpath: str              # posix, relative to project root
    source: str
    tree: Optional[ast.Module]  # None when the file does not parse
    lines: List[str]

    @property
    def segments(self) -> Tuple[str, ...]:
        return tuple(self.relpath.split("/"))

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


class Rule:
    """Base class: subclass, set ``name``, implement ``check_module`` (or
    override ``check_project`` for whole-repo rules like config-drift)."""

    name: str = ""
    default_severity: str = "error"
    #: directory names (path segments) the rule is scoped to; empty = all
    dir_names: frozenset = frozenset()

    def applies_to(self, module: ModuleInfo) -> bool:
        if not self.dir_names:
            return True
        return bool(self.dir_names.intersection(module.segments[:-1]))

    def check_module(self, module: ModuleInfo, project: "Project") -> List[Finding]:
        return []

    def check_project(self, project: "Project") -> List[Finding]:
        out: List[Finding] = []
        for module in project.modules:
            if module.tree is not None and self.applies_to(module):
                out.extend(self.check_module(module, project))
        return out

    def finding(self, module: ModuleInfo, node, message: str,
                related: Sequence[Tuple[str, int, str]] = ()) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=self.name,
            severity=self.default_severity,
            path=module.relpath,
            line=line,
            message=message,
            snippet=module.line_text(line),
            related=tuple(related),
        )


REGISTRY: Dict[str, type] = {}


def register(cls):
    if not cls.name:
        raise ValueError(f"rule class {cls.__name__} has no name")
    REGISTRY[cls.name] = cls
    return cls


# ---------------------------------------------------------------------------
# configuration — the [tool.dflint] pyproject block
# ---------------------------------------------------------------------------

_KNOWN_KEYS = {"enable", "disable", "exclude", "baseline", "severity"}


@dataclasses.dataclass(frozen=True)
class DflintConfig:
    enable: Tuple[str, ...] = ()    # non-empty -> run ONLY these rules
    disable: Tuple[str, ...] = ()
    exclude: Tuple[str, ...] = ()   # relpath prefixes skipped everywhere
    baseline: str = ".dflint-baseline.json"
    severity: Tuple[Tuple[str, str], ...] = ()  # (rule, severity) overrides

    @classmethod
    def from_pyproject(cls, path: str) -> "DflintConfig":
        if not os.path.exists(path):
            return cls()
        try:
            import tomllib as tomli  # py>=3.11
        except ModuleNotFoundError:
            import tomli

        with open(path, "rb") as f:
            data = tomli.load(f)
        block = data.get("tool", {}).get("dflint")
        if block is None:
            return cls()
        return cls.from_dict(block)

    @classmethod
    def from_dict(cls, block: Dict) -> "DflintConfig":
        unknown = set(block) - _KNOWN_KEYS
        if unknown:
            # a typo like "diable" must not silently lint with defaults
            raise ValueError(
                f"unknown [tool.dflint] key(s) {sorted(unknown)}; "
                f"valid: {sorted(_KNOWN_KEYS)}")
        valid_rules = set(REGISTRY) | {SYNTAX_RULE}
        for key in ("enable", "disable"):
            for rule in block.get(key, ()):
                if rule not in valid_rules:
                    raise ValueError(
                        f"[tool.dflint] {key} names unknown rule {rule!r}; "
                        f"valid: {sorted(valid_rules)}")
        severity = block.get("severity", {})
        if not isinstance(severity, dict):
            raise ValueError("[tool.dflint] severity must be a table")
        for rule, sev in severity.items():
            if rule not in valid_rules:
                raise ValueError(
                    f"[tool.dflint] severity names unknown rule {rule!r}")
            if sev not in SEVERITIES:
                raise ValueError(
                    f"[tool.dflint] severity for {rule!r} must be one of "
                    f"{SEVERITIES}, got {sev!r}")
        return cls(
            enable=tuple(block.get("enable", ())),
            disable=tuple(block.get("disable", ())),
            exclude=tuple(block.get("exclude", ())),
            baseline=str(block.get("baseline", ".dflint-baseline.json")),
            severity=tuple(sorted(severity.items())),
        )

    def enabled_rules(self) -> List[Rule]:
        names = list(self.enable) if self.enable else sorted(REGISTRY)
        rules = []
        for name in names:
            if name in self.disable or name == SYNTAX_RULE:
                continue
            rule = REGISTRY[name]()
            for override_name, sev in self.severity:
                if override_name == name:
                    rule.default_severity = sev
            rules.append(rule)
        return rules


# ---------------------------------------------------------------------------
# project model
# ---------------------------------------------------------------------------


class Project:
    """Everything a rule may inspect.

    ``modules``: the lint targets; ``all_modules``: every parseable source
    file under the root (config-drift scans consumption across the whole
    tree even when only a subdirectory is being linted); ``conf_files``:
    the YAML conf tree.
    """

    def __init__(self, root: str, modules: List[ModuleInfo],
                 all_modules: List[ModuleInfo], conf_files: List[str],
                 config: DflintConfig):
        self.root = root
        self.modules = modules
        self.all_modules = all_modules
        self.conf_files = conf_files
        self.config = config

    def relpath(self, path: str) -> str:
        return os.path.relpath(path, self.root).replace(os.sep, "/")

    def read_lines(self, relpath: str) -> List[str]:
        for m in self.all_modules:
            if m.relpath == relpath:
                return m.lines
        try:
            with open(os.path.join(self.root, relpath)) as f:
                return f.read().splitlines()
        except OSError:
            return []


def _excluded(relpath: str, excludes: Sequence[str]) -> bool:
    return any(relpath == e or relpath.startswith(e.rstrip("/") + "/")
               for e in excludes)


def _load_module(path: str, root: str) -> ModuleInfo:
    with open(path, encoding="utf-8", errors="replace") as f:
        source = f.read()
    try:
        tree = ast.parse(source)
    except SyntaxError:
        tree = None
    return ModuleInfo(
        path=path,
        relpath=os.path.relpath(path, root).replace(os.sep, "/"),
        source=source,
        tree=tree,
        lines=source.splitlines(),
    )


def _walk_py(base: str, root: str, excludes: Sequence[str]) -> List[str]:
    out = []
    if os.path.isfile(base):
        return [base] if base.endswith(".py") else []
    for dirpath, dirnames, filenames in os.walk(base):
        rel = os.path.relpath(dirpath, root).replace(os.sep, "/")
        dirnames[:] = [
            d for d in sorted(dirnames)
            if d not in _DEFAULT_EXCLUDES and not d.startswith(".")
            and not _excluded(f"{rel}/{d}".lstrip("./"), excludes)
        ]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                p = os.path.join(dirpath, fn)
                if not _excluded(os.path.relpath(p, root).replace(os.sep, "/"),
                                 excludes):
                    out.append(p)
    return out


def find_root(start: str) -> str:
    """Nearest ancestor (inclusive) holding a pyproject.toml, else start."""
    cur = os.path.abspath(start)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    probe = cur
    while True:
        if os.path.exists(os.path.join(probe, "pyproject.toml")):
            return probe
        parent = os.path.dirname(probe)
        if parent == probe:
            return cur
        probe = parent


def build_project(root: str, targets: Sequence[str],
                  config: Optional[DflintConfig] = None,
                  conf_dir: Optional[str] = None) -> Project:
    root = os.path.abspath(root)
    if config is None:
        config = DflintConfig.from_pyproject(os.path.join(root, "pyproject.toml"))
    all_paths = _walk_py(root, root, config.exclude)
    all_modules = [_load_module(p, root) for p in all_paths]
    by_path = {m.path: m for m in all_modules}
    target_paths: List[str] = []
    for t in targets:
        target_paths.extend(_walk_py(os.path.abspath(t), root, config.exclude))
    modules = []
    for p in dict.fromkeys(target_paths):
        modules.append(by_path.get(p) or _load_module(p, root))
    conf_dir = conf_dir if conf_dir is not None else os.path.join(root, "conf")
    conf_files = []
    if os.path.isdir(conf_dir):
        for dirpath, dirnames, filenames in os.walk(conf_dir):
            dirnames.sort()
            for fn in sorted(filenames):
                if fn.endswith((".yml", ".yaml")):
                    p = os.path.join(dirpath, fn)
                    if not _excluded(os.path.relpath(p, root).replace(os.sep, "/"),
                                     config.exclude):
                        conf_files.append(p)
    return Project(root, modules, all_modules, conf_files, config)


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*dflint:\s*disable=([A-Za-z0-9_,\- ]+)")


def suppression_map(lines: Sequence[str]) -> Dict[int, frozenset]:
    out: Dict[int, frozenset] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = frozenset(
                tok.strip() for tok in m.group(1).split(",") if tok.strip())
    return out


def is_suppressed(finding: Finding, lines: Sequence[str],
                  smap: Optional[Dict[int, frozenset]] = None) -> bool:
    smap = suppression_map(lines) if smap is None else smap
    for lineno in (finding.line, finding.line - 1):
        toks = smap.get(lineno)
        if not toks:
            continue
        if lineno == finding.line - 1:
            # the line above only counts when it is a standalone directive
            # comment — a trailing directive governs its own line
            text = lines[lineno - 1].strip() if lineno >= 1 else ""
            if not text.startswith("#"):
                continue
        if "all" in toks or finding.rule in toks:
            return True
    return False


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> Dict[Tuple[str, str, str], int]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    counts: Dict[Tuple[str, str, str], int] = {}
    for entry in data.get("findings", ()):
        fp = (entry["rule"], entry["path"], entry.get("snippet", ""))
        counts[fp] = counts.get(fp, 0) + 1
    return counts


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = [
        {"rule": f.rule, "path": f.path, "snippet": f.snippet}
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    ]
    with open(path, "w") as f:
        json.dump({"version": 1, "findings": entries}, f, indent=2)
        f.write("\n")


def apply_baseline(findings: Sequence[Finding],
                   baseline: Dict[Tuple[str, str, str], int],
                   ) -> Tuple[List[Finding], int]:
    """Drop findings covered by the baseline; each entry absorbs one
    occurrence so a SECOND copy of a grandfathered pattern still fails."""
    remaining = dict(baseline)
    kept: List[Finding] = []
    absorbed = 0
    for f in findings:
        fp = f.fingerprint()
        if remaining.get(fp, 0) > 0:
            remaining[fp] -= 1
            absorbed += 1
        else:
            kept.append(f)
    return kept, absorbed


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def analyze(project: Project) -> Tuple[List[Finding], int]:
    """Run every enabled rule; returns (unsuppressed findings sorted by
    location, count of inline-suppressed findings)."""
    findings: List[Finding] = []
    for module in project.modules:
        if module.tree is None:
            findings.append(Finding(
                rule=SYNTAX_RULE, severity="error", path=module.relpath,
                line=1, message="file does not parse as Python",
                snippet=module.line_text(1)))
    for rule in project.config.enabled_rules():
        findings.extend(rule.check_project(project))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    kept: List[Finding] = []
    suppressed = 0
    smaps: Dict[str, Tuple[List[str], Dict[int, frozenset]]] = {}
    for f in findings:
        if f.path not in smaps:
            lines = project.read_lines(f.path)
            smaps[f.path] = (lines, suppression_map(lines))
        lines, smap = smaps[f.path]
        if is_suppressed(f, lines, smap):
            suppressed += 1
        else:
            kept.append(f)
    return kept, suppressed
