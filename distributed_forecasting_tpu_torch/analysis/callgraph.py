"""Project-wide call resolution for dflint.

The rules that follow calls across modules (``rules_lockorder``,
``rules_propagation``, ``protocol``) and the ones that only need a module's
aliases (``rules_threads``, ``rules_purity``) share one index of the whole
tree, built once per :class:`Project`.

Resolution rules (the reference's docs/static-analysis.md):

* a module's dotted name is its posix relpath with ``/`` -> ``.`` and the
  ``.py`` / ``/__init__.py`` suffix dropped;
* ``import a.b.c``, ``import a.b.c as x``, ``from a.b import c`` and
  relative forms (``from .cv import f``, ``from ..ops import filters``)
  all resolve through :class:`pyast.ImportMap` with the module's package;
* a dotted reference resolves by longest known-module prefix, then the
  remainder is looked up among that module's top-level defs; a name bound
  by an ImportFrom re-export (``__init__.py`` chains) is followed
  transitively with a depth guard.

Known limits (deliberate, a linter must stay quiet when it cannot know):
dynamic dispatch (``get_model(name).fit``), dict-of-functions registries,
``getattr``, and method calls on objects are not followed; star imports
are ignored.

The reference's call graph also closes jit-traced scope over these edges;
eager PyTorch has no traced scope, so the port keeps only the resolution.
Pure AST + stdlib, same as the rest of the analysis package.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from distributed_forecasting_tpu_torch.analysis.core import ModuleInfo, Project
from distributed_forecasting_tpu_torch.analysis.pyast import (
    FunctionNode,
    ImportMap,
    _defs_by_name,
)

_MAX_REEXPORT_DEPTH = 8


def module_name(relpath: str) -> str:
    """``distributed_forecasting_tpu_torch/engine/cv.py`` ->
    ``distributed_forecasting_tpu_torch.engine.cv``; a package
    ``__init__.py`` maps to the package itself."""
    name = relpath[:-3] if relpath.endswith(".py") else relpath
    if name.endswith("/__init__"):
        name = name[: -len("/__init__")]
    return name.replace("/", ".")


def _package_of(relpath: str) -> Optional[str]:
    """The package relative imports resolve against: the containing package
    for a module, the package itself for its ``__init__.py``."""
    name = module_name(relpath)
    if relpath.endswith("/__init__.py"):
        return name
    return name.rsplit(".", 1)[0] if "." in name else None


def _top_level_defs(tree: ast.Module) -> Dict[str, ast.AST]:
    """Module-level function defs — the only ones an import can bind.
    Descends into top-level If/Try bodies (version-gated defs) but not into
    classes or other functions."""
    out: Dict[str, ast.AST] = {}
    todo: List[ast.AST] = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, FunctionNode):
            out.setdefault(node.name, node)
        elif isinstance(node, (ast.If, ast.Try)):
            for body in ast.iter_child_nodes(node):
                todo.append(body)
    return out


class CallGraph:
    """Built once per :class:`Project` over ``all_modules`` (the whole tree,
    not just the lint targets, so a target's calls into modules outside the
    target set still resolve)."""

    def __init__(self, project: Project):
        self._modules: Dict[str, ModuleInfo] = {}
        self._imaps: Dict[str, ImportMap] = {}
        self._defs: Dict[str, Dict[str, List[ast.AST]]] = {}
        self._top_defs: Dict[str, Dict[str, ast.AST]] = {}

        for m in project.all_modules:
            if m.tree is None:
                continue
            name = module_name(m.relpath)
            self._modules[name] = m
            self._imaps[name] = ImportMap(m.tree, package=_package_of(m.relpath))
            self._defs[name] = _defs_by_name(m.tree)
            self._top_defs[name] = _top_level_defs(m.tree)

    # -- public API --------------------------------------------------------

    def import_map(self, module: ModuleInfo) -> ImportMap:
        name = module_name(module.relpath)
        imap = self._imaps.get(name)
        if imap is None:  # unparsed or outside the indexed tree
            imap = ImportMap(module.tree, package=_package_of(module.relpath))
        return imap

    def resolve_dotted(self, dotted: str,
                       ) -> Optional[Tuple[ModuleInfo, ast.AST]]:
        """A canonical dotted name -> (defining module, function def), or
        None when it does not land on a project function."""
        hit = self._resolve(dotted, 0)
        if hit is None:
            return None
        mod, fn = hit
        return self._modules[mod], fn

    def resolve_call(self, module: ModuleInfo, func_expr: ast.AST,
                     ) -> List[Tuple[ModuleInfo, ast.AST]]:
        """Project functions a call head may land on: a bare Name resolves
        to the module's own defs or through its imports; a dotted Attribute
        resolves through the import map.  Method calls on objects resolve
        to nothing here (see module docstring on dynamic-dispatch limits)."""
        name = module_name(module.relpath)
        out: List[Tuple[ModuleInfo, ast.AST]] = []
        if isinstance(func_expr, ast.Name):
            for fn in self._defs.get(name, {}).get(func_expr.id, ()):
                out.append((module, fn))
            if not out:
                hit = self._resolve_name(name, func_expr.id)
                if hit is not None:
                    out.append((self._modules[hit[0]], hit[1]))
            return out
        imap = self.import_map(module)
        dotted = imap.dotted(func_expr)
        if dotted is not None:
            hit = self.resolve_dotted(dotted)
            if hit is not None:
                out.append(hit)
        return out

    # -- resolution --------------------------------------------------------

    def _resolve(self, dotted: str, depth: int,
                 ) -> Optional[Tuple[str, ast.AST]]:
        if depth > _MAX_REEXPORT_DEPTH:
            return None
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:i])
            if mod not in self._modules:
                continue
            rest = parts[i:]
            if len(rest) == 1:
                return self._resolve_in(mod, rest[0], depth)
            # pkg.sub.f where pkg/__init__.py re-exports sub: follow the
            # first remaining segment through the module's imports
            target = self._imaps[mod].aliases.get(rest[0])
            if target is not None:
                return self._resolve(".".join([target] + rest[1:]), depth + 1)
            return None
        return None

    def _resolve_in(self, mod: str, name: str, depth: int,
                    ) -> Optional[Tuple[str, ast.AST]]:
        fn = self._top_defs[mod].get(name)
        if fn is not None:
            return mod, fn
        target = self._imaps[mod].aliases.get(name)
        if target is not None and target != name:
            return self._resolve(target, depth + 1)
        return None

    def _resolve_name(self, mod: str, name: str,
                      ) -> Optional[Tuple[str, ast.AST]]:
        """A bare Name in ``mod`` that is not a local def: follow the
        import binding."""
        target = self._imaps[mod].aliases.get(name)
        if target is None or target == name:
            return None
        return self._resolve(target, 0)


def get_callgraph(project: Project) -> CallGraph:
    """One graph per Project instance — every rule in an :func:`analyze`
    run shares the build."""
    graph = getattr(project, "_dflint_callgraph", None)
    if graph is None:
        graph = CallGraph(project)
        project._dflint_callgraph = graph
    return graph
