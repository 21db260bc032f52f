"""Framework-free AST helpers shared by the dflint rules.

The counterpart of the reference package's ``analysis/jaxast.py``, less its
jit-entry detection and the traced-scope helpers built on it (eager PyTorch
has no traced bodies), so the port keeps only the questions every other
rule asks of a module, without importing anything but the stdlib:

1. *alias resolution* — which local name means ``threading.Lock`` /
   ``numpy`` / ``torch.cuda.synchronize`` here (``import numpy as np``,
   ``from functools import partial``, ...)?  :class:`ImportMap`.
2. *which functions a module defines*, by name: :func:`_defs_by_name`.

Project-wide resolution (imports, aliases and re-export chains over the
whole tree) lives in :mod:`analysis.callgraph`.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def _relative_base(package: Optional[str], level: int) -> Optional[str]:
    """The package a ``from ...x import y`` resolves in: level 1 is the
    module's own package, each extra level walks one package up.  None when
    the import reaches above the project root (or no package is known)."""
    if package is None:
        return None
    parts = package.split(".")
    up = level - 1
    if up >= len(parts):
        return None
    return ".".join(parts[: len(parts) - up]) if up else package


class ImportMap:
    """Local name -> canonical dotted path, from every import in the module
    (function-local imports included: the port imports ``torch`` inside the
    functions that launch kernels).

    ``package`` is the dotted package the module lives in; when given,
    relative imports (``from .cv import cross_validate``, level >= 1)
    resolve against it so the call graph can follow them.  Without it they
    are skipped, which is safe for the absolute-only rules (the stdlib,
    numpy and torch are never imported relatively)."""

    def __init__(self, tree: ast.AST, package: Optional[str] = None):
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
                    else:
                        top = a.name.split(".")[0]
                        self.aliases[top] = top
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = _relative_base(package, node.level)
                    if base is None:
                        continue
                    mod = f"{base}.{node.module}" if node.module else base
                elif node.module:
                    mod = node.module
                else:
                    continue
                for a in node.names:
                    self.aliases[a.asname or a.name] = f"{mod}.{a.name}"

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain rooted at an
        imported name (``np.random.uniform`` -> ``numpy.random.uniform``);
        None when the root is not an import (locals, params, builtins)."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id)
        if base is None:
            return None
        parts.append(base)
        return ".".join(reversed(parts))


def _defs_by_name(tree: ast.AST) -> Dict[str, List[ast.AST]]:
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, FunctionNode):
            out.setdefault(node.name, []).append(node)
    return out
