"""config-drift: the conf/ YAML tree and the code must name the same keys.

The conf system is layered dicts consumed with string lookups
(``tr.get("horizon")``), ``**``-splat into config dataclasses
(``CVConfig(**cv)``), and keyword pass-through — so a typo'd YAML key
(``max_batchsize``) silently does nothing, which for keys like
``calibrate_intervals`` means silently shipping the wrong artifact.  PR 1
hardened one block (``BatchingConfig.from_conf`` rejects unknown keys);
this rule covers the rest of the tree *statically*:

* every mapping key in ``conf/**/*.yml`` must correspond to something the
  code can consume: a string-literal lookup (``x["k"]`` / ``.get("k")``),
  a dataclass/class attribute field, or a keyword parameter/argument name
  anywhere in the source tree;
* in reverse, every required (default-less) field of a ``*Config``
  dataclass that declares a ``from_conf`` entry point must appear as a key
  somewhere under ``conf/`` — a required knob no conf file can spell is
  drift in the other direction (reported as a warning).

Consumption is collected over the WHOLE source tree, not just the lint
targets, so linting one subpackage cannot produce phantom drift.
"""

from __future__ import annotations

import ast
from typing import List, Set

import yaml

from distributed_forecasting_tpu_torch.analysis.core import (
    Finding,
    Project,
    Rule,
    register,
)

_LOOKUP_METHODS = frozenset({"get", "pop", "setdefault"})


def consumed_keys(project: Project) -> Set[str]:
    keys: Set[str] = set()
    for module in project.all_modules:
        if module.tree is None:
            continue
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Subscript):
                s = node.slice
                if isinstance(s, ast.Constant) and isinstance(s.value, str):
                    keys.add(s.value)
            elif isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _LOOKUP_METHODS
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    keys.add(node.args[0].value)
                for kw in node.keywords:
                    if kw.arg:
                        keys.add(kw.arg)
            elif isinstance(node, ast.ClassDef):
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and isinstance(
                            stmt.target, ast.Name):
                        keys.add(stmt.target.id)
                    elif isinstance(stmt, ast.Assign):
                        for t in stmt.targets:
                            if isinstance(t, ast.Name):
                                keys.add(t.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                for p in a.posonlyargs + a.args + a.kwonlyargs:
                    keys.add(p.arg)
    return keys


def _yaml_mapping_keys(path: str):
    """Yield (key, 1-based line) for every mapping key in the document,
    via yaml.compose so line numbers survive (safe_load drops marks)."""
    with open(path) as f:
        try:
            root = yaml.compose(f)
        except yaml.YAMLError:
            return
    todo = [root]
    while todo:
        node = todo.pop()
        if isinstance(node, yaml.MappingNode):
            for key_node, value_node in node.value:
                if isinstance(key_node, yaml.ScalarNode):
                    yield (str(key_node.value),
                           key_node.start_mark.line + 1)
                todo.append(value_node)
        elif isinstance(node, yaml.SequenceNode):
            todo.extend(node.value)


def _required_fields(cls: ast.ClassDef) -> List[str]:
    """Annotated class-body fields with no default — the dataclass-required
    set (``x: int = 3`` and ``y: str = field(default=...)`` both excluded
    because they carry a value node)."""
    required = []
    for stmt in cls.body:
        if (isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
                and stmt.value is None
                and not stmt.target.id.startswith("_")):
            required.append(stmt.target.id)
    return required


@register
class ConfigDrift(Rule):
    name = "config-drift"

    def check_project(self, project: Project) -> List[Finding]:
        if not project.conf_files:
            return []
        consumed = consumed_keys(project)
        out: List[Finding] = []
        all_yaml_keys: Set[str] = set()
        for cf in project.conf_files:
            rel = project.relpath(cf)
            for key, line in _yaml_mapping_keys(cf):
                all_yaml_keys.add(key)
                if key not in consumed:
                    out.append(Finding(
                        rule=self.name,
                        severity=self.default_severity,
                        path=rel,
                        line=line,
                        message=(
                            f"conf key {key!r} is not consumed anywhere in "
                            f"the source tree (no ['{key}'] / .get('{key}') "
                            f"lookup, dataclass field, or keyword) — typo'd "
                            f"keys silently do nothing"),
                        snippet=_line_text(cf, line),
                    ))
        # reverse direction: required from_conf dataclass fields must be
        # spellable from conf/
        for module in project.all_modules:
            if module.tree is None:
                continue
            for cls in ast.walk(module.tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                has_from_conf = any(
                    isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and n.name == "from_conf"
                    for n in cls.body)
                if not has_from_conf:
                    continue
                for field in _required_fields(cls):
                    if field not in all_yaml_keys:
                        out.append(Finding(
                            rule=self.name,
                            severity="warning",
                            path=module.relpath,
                            line=cls.lineno,
                            message=(
                                f"{cls.name}.{field} is required (no "
                                f"default) and loadable via from_conf, but "
                                f"no conf/ file ever sets {field!r} — "
                                f"default it or add it to a conf"),
                            snippet=module.line_text(cls.lineno),
                        ))
        return out


def _line_text(path: str, line: int) -> str:
    try:
        with open(path) as f:
            lines = f.read().splitlines()
        return lines[line - 1].strip() if 1 <= line <= len(lines) else ""
    except OSError:
        return ""
