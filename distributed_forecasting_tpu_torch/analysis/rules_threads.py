"""unlocked-shared-state: the serving path's concurrency contract.

The scorer is a ``ThreadingHTTPServer``: every ``/invocations`` runs on its
own handler thread, the batcher adds a scheduler thread, and ``GET
/metrics`` scrapes concurrently with all of them.  PR 1 established the
contract — shared mutable state in ``serving/`` and ``monitoring/`` classes
is guarded by an owning ``threading.Lock``/``Condition`` (``RequestBatcher``
holds ``self._cond`` around every ``_queue``/``_closed`` touch).

This rule mechanizes it per class that owns a lock attribute:

* any WRITE to a non-lock ``self`` attribute outside a ``with self.<lock>:``
  block (and outside ``__init__``, where the object is still thread-local)
  is flagged;
* any READ of a *guarded* attribute — one written under the lock somewhere
  in the class — outside the lock is flagged too: an unlocked read races
  the locked writer, and multi-field reads (a histogram's count next to its
  sum) can tear mid-update.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from distributed_forecasting_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Rule,
    register,
)
from distributed_forecasting_tpu_torch.analysis.callgraph import get_callgraph
from distributed_forecasting_tpu_torch.analysis.pyast import ImportMap

_LOCK_TYPES = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
})

#: in-place mutators on container attributes (deque/list/dict/set)
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "update",
    "setdefault", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "sort", "reverse",
})

#: construction/teardown happen-before any concurrent access
_EXEMPT_METHODS = frozenset({"__init__", "__new__", "__del__", "__post_init__"})


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' when node is exactly ``self.x``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _Access:
    __slots__ = ("attr", "kind", "node", "locked", "method")

    def __init__(self, attr, kind, node, locked, method):
        self.attr = attr
        self.kind = kind        # "write" | "read"
        self.node = node
        self.locked = locked
        self.method = method


def _lock_attrs(cls: ast.ClassDef, imap: ImportMap) -> Set[str]:
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if imap.dotted(node.value.func) in _LOCK_TYPES:
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr:
                        locks.add(attr)
    return locks


def _collect_accesses(method, locks: Set[str]) -> List[_Access]:
    accesses: List[_Access] = []

    def visit(node: ast.AST, locked: bool):
        if isinstance(node, ast.With):
            # `with self._lock:` / `with self._cond:` guards its body;
            # other context managers (files, errstate) do not
            holds = locked or any(
                _self_attr(item.context_expr) in locks
                for item in node.items
            )
            for item in node.items:
                visit(item.context_expr, locked)
            for child in node.body:
                visit(child, holds)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not method:
            return  # nested defs (locally-scoped helpers) out of scope
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                attr = _self_attr(t) or (
                    _self_attr(t.value)
                    if isinstance(t, ast.Subscript) else None)
                if attr and attr not in locks:
                    accesses.append(_Access(attr, "write", node, locked,
                                            method.name))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            attr = _self_attr(node.func.value)
            if attr and attr not in locks and node.func.attr in _MUTATORS:
                accesses.append(_Access(attr, "write", node, locked,
                                        method.name))
        if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
            attr = _self_attr(node)
            if attr and attr not in locks:
                accesses.append(_Access(attr, "read", node, locked,
                                        method.name))
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    for stmt in method.body:
        visit(stmt, False)
    return accesses


@register
class UnlockedSharedState(Rule):
    name = "unlocked-shared-state"
    dir_names = frozenset({"serving", "monitoring"})

    def check_module(self, module: ModuleInfo, project) -> List[Finding]:
        # shared, callgraph-cached ImportMap — no private per-rule re-walk
        imap = get_callgraph(project).import_map(module)
        out: List[Finding] = []
        for cls in ast.walk(module.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = _lock_attrs(cls, imap)
            if not locks:
                continue
            lock_names = "/".join(f"self.{name}" for name in sorted(locks))
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            accesses: List[_Access] = []
            for m in methods:
                if m.name in _EXEMPT_METHODS:
                    continue
                accesses.extend(_collect_accesses(m, locks))
            # attributes ever written under the lock are lock-guarded state;
            # attributes only ever READ (self.config, callbacks) are not
            guarded = {a.attr for a in accesses
                       if a.kind == "write" and a.locked}
            # methods themselves are attribute Loads (self._process(...)):
            # never guarded, so they fall out via the guarded set
            reported: Set[Tuple[str, int]] = set()
            for a in accesses:
                if a.locked:
                    continue
                key = (a.attr, a.node.lineno)
                if key in reported:
                    continue
                if a.kind == "write":
                    reported.add(key)
                    out.append(self.finding(
                        module, a.node,
                        f"{cls.name}.{a.method} mutates self.{a.attr} "
                        f"without holding {lock_names} in a class whose "
                        f"state is lock-guarded — racy against the locked "
                        f"writers/readers"))
                elif a.attr in guarded:
                    reported.add(key)
                    out.append(self.finding(
                        module, a.node,
                        f"{cls.name}.{a.method} reads self.{a.attr} outside "
                        f"{lock_names}, but it is written under the lock "
                        f"elsewhere — unlocked reads can tear against a "
                        f"concurrent update"))
        return out
