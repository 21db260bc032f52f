"""Lock-order and blocking-while-locked analysis.

The serving batcher, pipelined executor, compile cache, metrics registry
and native-build shim all own ``threading`` primitives; a deadlock between
any two of them takes down a whole serving replica, and a lock held across
file I/O or a device sync serializes every thread behind one slow
operation.  Neither failure reproduces in unit tests (they need the
unlucky interleaving), which is exactly the argument for checking them
statically.

Two rules over one shared analysis:

* **lock-order-cycle** — build the *acquired-while-holding* relation over
  every ``threading.Lock/RLock/Condition`` in the project (``with`` blocks
  only, the repo idiom; bare ``acquire()/release()`` pairs are out of
  scope and documented as such) and flag every edge participating in a
  cycle, including the self-edge of re-acquiring a non-reentrant lock.
* **blocking-under-lock** — flag calls that can block indefinitely while a
  lock is held: a device sync (``torch.cuda.synchronize``, ``.synchronize()``
  on an event or stream), ``Queue.put/get`` without a
  timeout (``put`` only when the queue is bounded — an unbounded put never
  blocks), ``subprocess``, ``os.fsync``/file I/O, ``socket`` ops,
  untimeout'd ``join()/result()/wait()``.  ``Condition.wait/wait_for`` on
  the *held* condition is exempt — waiting releases it; that is the
  primitive working as designed.

Both rules are interprocedural: call sites resolve through
:mod:`analysis.callgraph` (module functions), the enclosing class
(``self.helper()``), or a unique-method-name heuristic (``obj.meth()``
when exactly one project class defines ``meth`` and the name is not a
common stdlib method), and each function gets a fixpoint summary of the
locks it acquires and the blocking calls it makes, transitively.

Pure AST + stdlib.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from distributed_forecasting_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Project,
    Rule,
    register,
)
from distributed_forecasting_tpu_torch.analysis.callgraph import get_callgraph
from distributed_forecasting_tpu_torch.analysis.pyast import FunctionNode, ImportMap

#: constructor dotted name -> sync kind
_SYNC_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "threading.Semaphore": "semaphore",
    "threading.BoundedSemaphore": "semaphore",
    "queue.Queue": "queue",
    "queue.LifoQueue": "queue",
    "queue.PriorityQueue": "queue",
    "queue.SimpleQueue": "queue",
}

#: kinds that participate in hold tracking / ordering edges (semaphores are
#: capacity limiters — holding one across slow work is their job, and
#: multiple holders make "order" meaningless)
_ORDER_KINDS = frozenset({"lock", "rlock", "condition"})

#: dotted calls that can block the calling thread indefinitely (or for an
#: unbounded I/O duration)
_BLOCKING_DOTTED = {
    "torch.cuda.synchronize": "torch.cuda.synchronize() (device sync)",
    "os.fsync": "os.fsync() (disk flush)",
    "time.sleep": "time.sleep()",
    "subprocess.run": "subprocess.run()",
    "subprocess.call": "subprocess.call()",
    "subprocess.check_call": "subprocess.check_call()",
    "subprocess.check_output": "subprocess.check_output()",
    "subprocess.Popen": "subprocess.Popen()",
    "socket.create_connection": "socket.create_connection()",
    "shutil.rmtree": "shutil.rmtree() (file I/O)",
    "shutil.copy": "shutil.copy() (file I/O)",
    "shutil.copy2": "shutil.copy2() (file I/O)",
    "shutil.copytree": "shutil.copytree() (file I/O)",
    "shutil.move": "shutil.move() (file I/O)",
    "os.makedirs": "os.makedirs() (file I/O)",
    "os.listdir": "os.listdir() (file I/O)",
    "os.scandir": "os.scandir() (file I/O)",
    "os.walk": "os.walk() (file I/O)",
    "os.remove": "os.remove() (file I/O)",
    "os.replace": "os.replace() (file I/O)",
    "os.rename": "os.rename() (file I/O)",
    "os.utime": "os.utime() (file I/O)",
}

#: socket-ish method names blocking regardless of receiver type
_BLOCKING_METHODS = frozenset({"recv", "accept", "sendall", "connect"})

#: method names too generic for the unique-method-name call heuristic —
#: they collide with stdlib containers/threads and would fabricate edges
_COMMON_METHODS = frozenset({
    "append", "extend", "insert", "add", "get", "put", "pop", "update",
    "remove", "discard", "clear", "sort", "reverse", "copy", "index",
    "count", "join", "split", "strip", "format", "encode", "decode",
    "read", "write", "flush", "close", "open", "start", "stop", "run",
    "set", "items", "keys", "values", "acquire", "release", "wait",
    "notify", "notify_all", "result", "done", "cancel", "send",
})

#: a lock id: (module relpath, owning class or None for module globals,
#: attribute/variable name)
LockId = Tuple[str, Optional[str], str]


def _order_key(lock: LockId) -> Tuple[str, str, str]:
    """A sort key for lock ids: a module global's owner (None) sorts before
    any class, where comparing the raw tuples would raise TypeError."""
    rel, cls, name = lock
    return rel, cls or "", name


def _fmt(lock: LockId) -> str:
    rel, cls, name = lock
    owner = f"{cls}.{name}" if cls else name
    return f"{owner} ({rel})"


def _has_timeout(call: ast.Call) -> bool:
    return any(kw.arg in ("timeout",) for kw in call.keywords)


def _nonblocking_flag(call: ast.Call) -> bool:
    """``get(False)`` / ``put(x, False)`` / ``acquire(blocking=False)``."""
    for kw in call.keywords:
        if kw.arg in ("block", "blocking") and isinstance(kw.value, ast.Constant):
            return kw.value.value is False
    return any(isinstance(a, ast.Constant) and a.value is False
               for a in call.args)


class _FnCtx:
    __slots__ = ("module", "cls")

    def __init__(self, module: ModuleInfo, cls: Optional[str]):
        self.module = module
        self.cls = cls


class _LockAnalysis:
    """One shared build per Project for both rules."""

    def __init__(self, project: Project):
        self.project = project
        self.graph = get_callgraph(project)
        #: LockId -> kind
        self.syncs: Dict[LockId, str] = {}
        #: LockId (queues) -> True when bounded (put can block)
        self.queue_bounded: Dict[LockId, bool] = {}
        self.fn_ctx: Dict[ast.AST, _FnCtx] = {}
        #: (relpath, class) -> {method name -> fn}
        self.class_methods: Dict[Tuple[str, str], Dict[str, ast.AST]] = {}
        #: method name -> [(module, class, fn)] across the project
        self.methods: Dict[str, List[Tuple[ModuleInfo, str, ast.AST]]] = {}
        self._summaries: Dict[ast.AST, Tuple[Set[LockId],
                                             List[Tuple[str, str, int]]]] = {}
        self._building: Set[int] = set()
        #: (src, dst, module, node) — dst acquired while src held
        self.edges: List[Tuple[LockId, LockId, ModuleInfo, ast.AST]] = []
        #: (module, node, message, related-hops)
        self.block_hits: List[Tuple[ModuleInfo, ast.AST, str,
                                    Tuple[Tuple[str, int, str], ...]]] = []

        for m in project.all_modules:
            if m.tree is not None:
                self._index_module(m)
        for fn, ctx in list(self.fn_ctx.items()):
            self._walk_fn(fn, ctx)

    # -- indexing ----------------------------------------------------------

    def _index_module(self, module: ModuleInfo) -> None:
        imap = self.graph.import_map(module)

        def scan(node: ast.AST, cls: Optional[str], top: bool) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    scan(child, child.name, False)
                elif isinstance(child, FunctionNode):
                    self.fn_ctx[child] = _FnCtx(module, cls)
                    if cls is not None:
                        key = (module.relpath, cls)
                        self.class_methods.setdefault(key, {}).setdefault(
                            child.name, child)
                        self.methods.setdefault(child.name, []).append(
                            (module, cls, child))
                    scan(child, cls, False)
                else:
                    if isinstance(child, ast.Assign):
                        self._index_sync_assign(module, imap, child, cls, top)
                    scan(child, cls, top and not isinstance(
                        child, (ast.ClassDef,) + FunctionNode))

        scan(module.tree, None, True)

    def _index_sync_assign(self, module: ModuleInfo, imap: ImportMap,
                           node: ast.Assign, cls: Optional[str],
                           top: bool) -> None:
        if not isinstance(node.value, ast.Call):
            return
        kind = _SYNC_CTORS.get(imap.dotted(node.value.func) or "")
        if kind is None:
            return
        for t in node.targets:
            lock: Optional[LockId] = None
            if (isinstance(t, ast.Attribute) and cls is not None
                    and isinstance(t.value, ast.Name) and t.value.id == "self"):
                lock = (module.relpath, cls, t.attr)
            elif isinstance(t, ast.Name) and cls is None:
                lock = (module.relpath, None, t.id)
            if lock is None:
                continue
            self.syncs[lock] = kind
            if kind == "queue":
                self.queue_bounded[lock] = self._queue_is_bounded(node.value)

    @staticmethod
    def _queue_is_bounded(ctor: ast.Call) -> bool:
        size: Optional[ast.AST] = ctor.args[0] if ctor.args else None
        for kw in ctor.keywords:
            if kw.arg == "maxsize":
                size = kw.value
        if size is None:
            return False  # Queue() defaults to unbounded
        if isinstance(size, ast.Constant) and size.value in (0, None):
            return False
        return True  # positive or unknown -> assume put can block

    # -- resolution --------------------------------------------------------

    def _resolve_sync(self, expr: ast.AST, ctx: _FnCtx) -> Optional[LockId]:
        """A ``with`` item or method receiver -> known sync object."""
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and ctx.cls is not None):
            lock = (ctx.module.relpath, ctx.cls, expr.attr)
            return lock if lock in self.syncs else None
        if isinstance(expr, ast.Name):
            lock = (ctx.module.relpath, None, expr.id)
            if lock in self.syncs:
                return lock
            # imported module-global lock: from pkg.mod import _LOCK
            imap = self.graph.import_map(ctx.module)
            dotted = imap.aliases.get(expr.id)
            if dotted and "." in dotted:
                mod, name = dotted.rsplit(".", 1)
                for m in self.project.all_modules:
                    lock = (m.relpath, None, name)
                    if (lock in self.syncs
                            and mod == _module_name_of(m.relpath)):
                        return lock
        return None

    def _resolve_callees(self, call: ast.Call, ctx: _FnCtx,
                         ) -> List[Tuple[ModuleInfo, ast.AST]]:
        func = call.func
        if isinstance(func, ast.Attribute):
            if (isinstance(func.value, ast.Name) and func.value.id == "self"
                    and ctx.cls is not None):
                meth = self.class_methods.get(
                    (ctx.module.relpath, ctx.cls), {}).get(func.attr)
                if meth is not None:
                    return [(ctx.module, meth)]
                return []
            dotted = self.graph.import_map(ctx.module).dotted(func)
            if dotted is not None:
                hit = self.graph.resolve_dotted(dotted)
                return [hit] if hit else []
            # obj.meth(): unique-method-name heuristic
            if func.attr not in _COMMON_METHODS:
                owners = self.methods.get(func.attr, ())
                if len(owners) == 1:
                    m, _, fn = owners[0]
                    return [(m, fn)]
            return []
        return self.graph.resolve_call(ctx.module, func)

    # -- blocking classification ------------------------------------------

    def _blocking_desc(self, call: ast.Call, ctx: _FnCtx,
                       held: Tuple[LockId, ...]) -> Optional[str]:
        func = call.func
        if isinstance(func, ast.Name):
            if func.id == "open":
                return "open() (file I/O)"
            return None
        imap = self.graph.import_map(ctx.module)
        dotted = imap.dotted(func)
        if dotted in _BLOCKING_DOTTED:
            return _BLOCKING_DOTTED[dotted]
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        if attr == "synchronize" and dotted is None:
            return ".synchronize() (device sync)"
        if attr in _BLOCKING_METHODS:
            return f".{attr}() (socket I/O)"
        receiver = self._resolve_sync(func.value, ctx)
        if attr in ("put", "get"):
            if receiver is None or self.syncs.get(receiver) != "queue":
                return None  # dict.get / registry.put — not a queue
            if _has_timeout(call) or _nonblocking_flag(call):
                return None
            if attr == "put" and not self.queue_bounded.get(receiver, False):
                return None  # unbounded put never blocks
            return f"Queue.{attr}() without timeout on {_fmt(receiver)}"
        if attr in ("wait", "wait_for"):
            if receiver is not None and self.syncs.get(receiver) == "condition":
                # waiting releases the condition it is called on — that is
                # the primitive working as designed, IF it is the held one
                if receiver in held:
                    return None
            if _has_timeout(call):
                return None
            return f".{attr}() without timeout"
        if attr == "acquire" and receiver is not None:
            if _has_timeout(call) or _nonblocking_flag(call):
                return None
            return f"{_fmt(receiver)}.acquire()"
        if attr in ("join", "result") and not call.args and not _has_timeout(call):
            # str.join always takes the iterable argument, so arg-less
            # join() is a thread/process join
            return f".{attr}() without timeout"
        return None

    # -- summaries ---------------------------------------------------------

    def summary(self, fn: ast.AST,
                ) -> Tuple[Set[LockId], List[Tuple[str, str, int]]]:
        """(locks acquired anywhere inside, transitively; blocking calls
        made anywhere inside, transitively, as (desc, relpath, line))."""
        cached = self._summaries.get(fn)
        if cached is not None:
            return cached
        if id(fn) in self._building:  # recursion: fixpoint at bottom
            return set(), []
        self._building.add(id(fn))
        ctx = self.fn_ctx.get(fn)
        acquires: Set[LockId] = set()
        blocks: List[Tuple[str, str, int]] = []
        if ctx is not None:
            for node in self._own_body(fn):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        lock = self._resolve_sync(item.context_expr, ctx)
                        if lock and self.syncs[lock] in _ORDER_KINDS:
                            acquires.add(lock)
                elif isinstance(node, ast.Call):
                    desc = self._blocking_desc(node, ctx, held=())
                    if desc is not None:
                        if ".wait" in desc:
                            continue  # held-set precision needed; see _visit
                        if len(blocks) < 4:
                            blocks.append((desc, ctx.module.relpath,
                                           node.lineno))
                        continue
                    for _, callee in self._resolve_callees(node, ctx):
                        if callee is fn:
                            continue
                        sub_acq, sub_blk = self.summary(callee)
                        acquires |= sub_acq
                        for entry in sub_blk:
                            if len(blocks) < 4 and entry not in blocks:
                                blocks.append(entry)
        self._building.discard(id(fn))
        self._summaries[fn] = (acquires, blocks)
        return acquires, blocks

    @staticmethod
    def _own_body(fn: ast.AST) -> Iterable[ast.AST]:
        """Walk a function without descending into nested defs (they get
        their own summary/walk)."""
        todo: List[ast.AST] = list(fn.body)
        while todo:
            node = todo.pop()
            yield node
            if not isinstance(node, FunctionNode):
                todo.extend(ast.iter_child_nodes(node))

    # -- the direct walk: edges + findings --------------------------------

    def _walk_fn(self, fn: ast.AST, ctx: _FnCtx) -> None:
        for stmt in fn.body:
            self._visit(stmt, (), ctx)

    def _visit(self, node: ast.AST, held: Tuple[LockId, ...],
               ctx: _FnCtx) -> None:
        if isinstance(node, FunctionNode):
            # a nested def runs when called, not here — walk it lock-free
            nested_ctx = self.fn_ctx.get(node, ctx)
            for stmt in node.body:
                self._visit(stmt, (), nested_ctx)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: List[LockId] = []
            for item in node.items:
                self._visit(item.context_expr, held, ctx)
                lock = self._resolve_sync(item.context_expr, ctx)
                if lock is None or self.syncs[lock] not in _ORDER_KINDS:
                    continue
                for h in tuple(held) + tuple(acquired):
                    self.edges.append((h, lock, ctx.module,
                                       item.context_expr))
                acquired.append(lock)
            inner = held + tuple(acquired)
            for stmt in node.body:
                self._visit(stmt, inner, ctx)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, held, ctx)
        for child in ast.iter_child_nodes(node):
            self._visit(child, held, ctx)

    def _visit_call(self, call: ast.Call, held: Tuple[LockId, ...],
                    ctx: _FnCtx) -> None:
        if not held:
            return
        desc = self._blocking_desc(call, ctx, held)
        if desc is not None:
            self.block_hits.append((ctx.module, call, (
                f"{desc} while holding {_fmt(held[-1])} — every thread "
                f"contending on that lock stalls behind this call; move it "
                f"outside the critical section or add a timeout"), ()))
            return
        callees = self._resolve_callees(call, ctx)
        for mod, callee in callees:
            acq, blk = self.summary(callee)
            for lock in acq:
                for h in held:
                    self.edges.append((h, lock, ctx.module, call))
            for bdesc, rel, line in blk[:2]:
                # the (rel, line) hop rides along so SARIF can render the
                # interprocedural path, not just the call site
                self.block_hits.append((ctx.module, call, (
                    f"call into '{callee.name}' ({rel}:{line}) reaches "
                    f"{bdesc} while holding {_fmt(held[-1])} — hoist the "
                    f"slow work out of the critical section"),
                    ((rel, line, f"{bdesc} happens here"),)))

    # -- cycle detection ---------------------------------------------------

    def cycles(self) -> Tuple[Set[LockId], Set[frozenset]]:
        """(locks on some cycle, the SCC lock-sets) over the
        acquired-while-holding graph.  RLock self-edges are legal
        (reentrancy) and excluded."""
        adj: Dict[LockId, Set[LockId]] = {}
        cyclic: Set[LockId] = set()
        for src, dst, _, _ in self.edges:
            if src == dst:
                if self.syncs.get(src) != "rlock":
                    cyclic.add(src)
                continue
            adj.setdefault(src, set()).add(dst)

        # Tarjan SCC, iterative
        index: Dict[LockId, int] = {}
        low: Dict[LockId, int] = {}
        on_stack: Set[LockId] = set()
        stack: List[LockId] = []
        sccs: List[List[LockId]] = []
        counter = [0]

        def strongconnect(root: LockId) -> None:
            work = [(root, iter(sorted(adj.get(root, ()), key=_order_key)))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(adj.get(w, ()),
                                                   key=_order_key))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    if len(comp) > 1:
                        sccs.append(comp)

        for v in sorted(adj, key=_order_key):
            if v not in index:
                strongconnect(v)
        scc_sets = {frozenset(c) for c in sccs}
        for c in scc_sets:
            cyclic |= c
        return cyclic, scc_sets


def get_lock_analysis(project: Project) -> _LockAnalysis:
    analysis = getattr(project, "_dflint_lock_analysis", None)
    if analysis is None:
        analysis = _LockAnalysis(project)
        project._dflint_lock_analysis = analysis
    return analysis


def _module_name_of(relpath: str) -> str:
    from distributed_forecasting_tpu_torch.analysis.callgraph import module_name
    return module_name(relpath)


@register
class LockOrderCycle(Rule):
    name = "lock-order-cycle"
    dir_names = frozenset()  # any module may own a lock

    def check_project(self, project: Project) -> List[Finding]:
        analysis = get_lock_analysis(project)
        cyclic, sccs = analysis.cycles()
        if not cyclic:
            return []
        targets = {m.relpath for m in project.modules}
        out: List[Finding] = []
        seen: Set[Tuple[str, int, str]] = set()
        for src, dst, module, node in analysis.edges:
            if module.relpath not in targets:
                continue
            related: Tuple[Tuple[str, int, str], ...] = ()
            if src == dst and src in cyclic:
                msg = (f"re-acquiring non-reentrant {_fmt(src)} while "
                       f"already holding it deadlocks the thread; use an "
                       f"RLock or restructure the critical section")
            elif any(src in c and dst in c for c in sccs):
                cycle = next(c for c in sccs if src in c and dst in c)
                order = " -> ".join(sorted(_fmt(l) for l in cycle))
                msg = (f"acquiring {_fmt(dst)} while holding {_fmt(src)} "
                       f"participates in a lock-order cycle [{order}]; two "
                       f"threads taking these locks in opposite orders "
                       f"deadlock")
                # the cycle's OTHER acquisition sites, so the SARIF
                # codeFlow shows the full deadlock loop
                hops = []
                for s2, d2, mod2, node2 in analysis.edges:
                    if (s2, d2) == (src, dst) or s2 == d2:
                        continue
                    if s2 in cycle and d2 in cycle:
                        hops.append((mod2.relpath, node2.lineno,
                                     f"acquires {_fmt(d2)} while holding "
                                     f"{_fmt(s2)}"))
                related = tuple(dict.fromkeys(hops))[:6]
            else:
                continue
            key = (module.relpath, node.lineno, msg)
            if key not in seen:
                seen.add(key)
                out.append(self.finding(module, node, msg,
                                        related=related))
        return out


@register
class BlockingUnderLock(Rule):
    name = "blocking-under-lock"
    dir_names = frozenset()

    def check_project(self, project: Project) -> List[Finding]:
        analysis = get_lock_analysis(project)
        targets = {m.relpath for m in project.modules}
        out: List[Finding] = []
        seen: Set[Tuple[str, int, str]] = set()
        for module, node, msg, related in analysis.block_hits:
            if module.relpath not in targets:
                continue
            key = (module.relpath, node.lineno, msg)
            if key not in seen:
                seen.add(key)
                out.append(self.finding(module, node, msg,
                                        related=related))
        return out
