"""dfproto layer 2: interprocedural propagation-taint rules.

Three cross-cutting invariants of the serving fleet that no unit test can
hold still long enough to check — each is a *propagation* property: a
value (deadline budget, trace context, failure count) must survive a hop
(an outbound socket leg, a thread/pool submission, an except edge), and
losing it fails silently at runtime.

* **deadline-propagation** — a function holding a request deadline (a
  ``deadline`` parameter/local, or one it derived via
  ``deadline_from_headers`` / ``request_deadline``) must not make or
  reach an outbound HTTP leg that ignores the remaining budget: direct
  legs must derive their socket timeout (``remaining_ms`` /
  ``leg_timeout_s``) *and* forward the shrunken ``X-Deadline-Ms``
  header; calls into deadline-aware callees must actually pass the
  deadline; calls into deadline-blind callees must not transitively
  reach a raw leg.
* **trace-context-loss** — a ``threading.Thread`` / executor ``submit``
  reachable from a span scope must capture the current
  :class:`TraceContext` (``tracer.current()`` / ``tracer.context(...)``
  / a ``trace_ctx`` handoff) or every span opened on the new thread
  silently detaches from the request trace.
* **error-path-accounting** — an ``except`` edge guarding a
  failpoint-armed call (directly or one/two calls deep) must re-raise or
  account (a counter ``inc``/``observe``, a supervisor ``note_*`` /
  ``report_failure`` / ``breaker_failure``), otherwise chaos scenarios
  can "pass" while the failure disappears into a swallowed handler.

All three share the lock-order pass's function index and callee
resolution (one build per project) and attach source→sink hop lists to
their findings, rendered as SARIF codeFlows.  Pure AST + stdlib.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from distributed_forecasting_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Project,
    Rule,
    register,
)
from distributed_forecasting_tpu_torch.analysis.rules_lockorder import (
    get_lock_analysis,
)
from distributed_forecasting_tpu_torch.analysis.rules_drift import (
    _is_test_module,
    _tracer_receiver,
)

#: calls that mint a request deadline inside a function body
_DEADLINE_SOURCES = frozenset({
    "deadline_from_headers", "parse_deadline_header", "request_deadline",
})

#: budget-derivation evidence for an outbound leg
_BUDGET_CALLS = frozenset({"remaining_ms", "leg_timeout_s"})

_DEADLINE_HEADER = "X-Deadline-Ms"

#: accounting verbs an except edge may use instead of re-raising
_ACCOUNT_ATTRS = frozenset({
    "inc", "observe", "record_failure", "report_failure",
    "breaker_failure", "exception",
})

#: exception types failpoint injection can surface as — only handlers
#: catching these owe the accounting invariant
_FAILPOINT_CATCHES = frozenset({
    "Exception", "BaseException", "OSError", "IOError", "EnvironmentError",
    "TimeoutError", "HTTPException", "ConnectionError", "RuntimeError",
})


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _own_walk(fn: ast.AST):
    """Function body without nested defs/lambdas (they run elsewhere)."""
    todo: List[ast.AST] = list(fn.body)
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            todo.extend(ast.iter_child_nodes(node))


def _hop(module: ModuleInfo, node: ast.AST, message: str,
         ) -> Tuple[str, int, str]:
    return (module.relpath, getattr(node, "lineno", 1), message)


def _narrow(project: Project, out: List[Finding]) -> List[Finding]:
    """The analysis walks ``all_modules`` (the propagation model must be
    whole-world); findings are reported only for the lint targets so
    ``--changed-only`` scopes like every other rule."""
    targets = {m.relpath for m in project.modules}
    return [f for f in out if f.path in targets]


class _PropagationAnalysis:
    """Shared pass: reuses the lock analysis' function index, class-method
    maps and callee resolution so lint builds the AST/callgraph once."""

    def __init__(self, project: Project):
        self.project = project
        self.lock = get_lock_analysis(project)
        self.graph = self.lock.graph
        self._outbound_memo: Dict[int, Optional[List[Tuple[str, int, str]]]] = {}
        self._fires_memo: Dict[int, Optional[List[Tuple[str, int, str]]]] = {}

    # -- scoping helpers ---------------------------------------------------
    def in_scope(self, module: ModuleInfo) -> bool:
        if module.tree is None or _is_test_module(module):
            return False
        # the analysis package's own pattern tables mention these idioms
        return "analysis" not in module.segments[:-1]

    def fns(self):
        for fn, ctx in self.lock.fn_ctx.items():
            if self.in_scope(ctx.module):
                yield fn, ctx

    # -- deadline ----------------------------------------------------------
    @staticmethod
    def params_of(fn) -> List[str]:
        return [a.arg for a in fn.args.args]

    def deadline_scoped(self, fn) -> bool:
        if "deadline" in self.params_of(fn):
            return True
        references = False
        local_bind = False
        for node in _own_walk(fn):
            if isinstance(node, ast.Call) \
                    and _call_name(node) in _DEADLINE_SOURCES:
                return True
            if isinstance(node, ast.Name) and node.id == "deadline":
                references = True
            # a local `deadline = time.monotonic() + x` is a wait-loop
            # bound (bench/chaos idiom), not an HTTP request budget — only
            # deadlines minted by the sources above (or closed over from a
            # scoped enclosing fn) carry the propagation obligation
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == "deadline"
                            for t in node.targets) \
                    and not (isinstance(node.value, ast.Call)
                             and _call_name(node.value)
                             in _DEADLINE_SOURCES):
                local_bind = True
        return references and not local_bind

    @staticmethod
    def outbound_site(call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == "request" \
                and len(call.args) >= 2:
            return True
        return _call_name(call) == "pooled_get"

    def budget_evidence(self, fn) -> Tuple[bool, bool]:
        derives = forwards = False
        for node in _own_walk(fn):
            if isinstance(node, ast.Call) \
                    and _call_name(node) in _BUDGET_CALLS:
                derives = True
            if isinstance(node, ast.Constant) \
                    and node.value == _DEADLINE_HEADER:
                forwards = True
        return derives, forwards

    def passes_deadline(self, call: ast.Call, callee) -> bool:
        params = self.params_of(callee)
        if "deadline" not in params:
            return True  # nothing to pass
        if any(kw.arg == "deadline" for kw in call.keywords):
            return True
        idx = params.index("deadline")
        if params and params[0] == "self":
            idx -= 1
        if len(call.args) > idx:
            return True
        return any(isinstance(a, ast.Name) and a.id == "deadline"
                   for a in call.args)

    def unbudgeted_outbound(self, fn, ctx, depth: int = 0,
                            ) -> Optional[List[Tuple[str, int, str]]]:
        """For a deadline-*blind* function: a hop chain to a raw outbound
        leg it (transitively) performs, or None.  Stops at deadline-aware
        callees — they are checked at their own call sites."""
        key = id(fn)
        if key in self._outbound_memo:
            return self._outbound_memo[key]
        self._outbound_memo[key] = None  # cycle guard
        result: Optional[List[Tuple[str, int, str]]] = None
        for node in _own_walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if self.outbound_site(node):
                result = [_hop(ctx.module, node,
                               f"raw outbound leg in {fn.name}() — no "
                               f"deadline parameter reaches here")]
                break
            if depth >= 3:
                continue
            for cm, callee in self.lock._resolve_callees(node, ctx):
                cctx = self.lock.fn_ctx.get(callee)
                if cctx is None or not self.in_scope(cctx.module):
                    continue
                if "deadline" in self.params_of(callee):
                    continue  # deadline-aware boundary
                sub = self.unbudgeted_outbound(callee, cctx, depth + 1)
                if sub:
                    result = [_hop(ctx.module, node,
                                   f"{fn.name}() calls "
                                   f"{callee.name}()")] + sub
                    break
            if result:
                break
        self._outbound_memo[key] = result
        return result

    # -- trace context -----------------------------------------------------
    def span_fns(self) -> Dict[ast.AST, Tuple[ModuleInfo, ast.AST]]:
        """fn -> (module, span-call node) for every span-opening fn."""
        out: Dict[ast.AST, Tuple[ModuleInfo, ast.AST]] = {}
        for fn, ctx in self.fns():
            if ctx.module.relpath.endswith("monitoring/trace.py"):
                continue
            for node in _own_walk(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ("span", "root_span") \
                        and _tracer_receiver(node.func.value):
                    out[fn] = (ctx.module, node)
                    break
        return out

    def span_reachable(self, roots) -> Dict[ast.AST, List[Tuple[str, int, str]]]:
        """BFS over calls from span-opening fns; fn -> hop chain from the
        span that reaches it."""
        reach: Dict[ast.AST, List[Tuple[str, int, str]]] = {}
        todo: List[ast.AST] = []
        for fn, (module, span_node) in roots.items():
            reach[fn] = [_hop(module, span_node,
                              f"span scope opens in {fn.name}()")]
            todo.append(fn)
        while todo:
            fn = todo.pop()
            ctx = self.lock.fn_ctx.get(fn)
            if ctx is None:
                continue
            for node in _own_walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                for cm, callee in self.lock._resolve_callees(node, ctx):
                    if callee in reach:
                        continue
                    cctx = self.lock.fn_ctx.get(callee)
                    if cctx is None or not self.in_scope(cctx.module):
                        continue
                    if len(reach[fn]) >= 5:
                        continue  # keep hop chains readable
                    reach[callee] = reach[fn] + [_hop(
                        ctx.module, node,
                        f"{fn.name}() calls {callee.name}()")]
                    todo.append(callee)
        return reach

    @staticmethod
    def captures_context(fn) -> bool:
        """Whole-subtree evidence (nested legs included) that the function
        hands a TraceContext across the thread boundary: an explicit
        capture/adopt, a ``trace_ctx`` handoff, or a ``ctx=`` keyword on a
        tracer span call (the executor writer-thread idiom)."""
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and _tracer_receiver(node.func.value):
                if node.func.attr in ("current", "context"):
                    return True
                if any(kw.arg in ("ctx", "trace_ctx")
                       for kw in node.keywords):
                    return True
            if isinstance(node, ast.Attribute) and node.attr == "trace_ctx":
                return True
            if isinstance(node, ast.Name) and node.id == "trace_ctx":
                return True
            if isinstance(node, ast.keyword) and node.arg == "trace_ctx":
                return True
        return False

    def thread_target_captures(self, call: ast.Call, fn, ctx) -> bool:
        """``Thread(target=self._drain)`` is safe when the target function
        itself adopts a context per unit of work."""
        target: Optional[ast.AST] = None
        for kw in call.keywords:
            if kw.arg == "target":
                target = kw.value
        if target is None and call.args:
            target = call.args[0]
        resolved: Optional[ast.AST] = None
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self" and ctx.cls is not None:
            resolved = self.lock.class_methods.get(
                (ctx.module.relpath, ctx.cls), {}).get(target.attr)
        elif isinstance(target, ast.Name):
            for node in ast.walk(fn):  # nested defs in the spawning fn
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node.name == target.id:
                    resolved = node
                    break
        return resolved is not None and self.captures_context(resolved)

    def executor_submit_captures(self) -> bool:
        """True when the project's Executor.submit itself captures the
        context (the engine idiom) — then ``*executor*.submit(...)`` sites
        are safe regardless of the caller."""
        for name, owners in self.lock.methods.items():
            if name != "submit":
                continue
            for module, cls, fn in owners:
                if "executor" in cls.lower() and self.captures_context(fn):
                    return True
        return False

    # -- failpoints --------------------------------------------------------
    def fires_failpoint(self, fn, ctx, depth: int = 0,
                        ) -> Optional[List[Tuple[str, int, str]]]:
        key = id(fn)
        if key in self._fires_memo:
            return self._fires_memo[key]
        self._fires_memo[key] = None  # cycle guard
        result: Optional[List[Tuple[str, int, str]]] = None
        for node in _own_walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name in ("failpoint", "failpoint_data"):
                result = [_hop(ctx.module, node,
                               f"failpoint armed in {fn.name}()")]
                break
            if depth >= 2:
                continue
            for cm, callee in self.lock._resolve_callees(node, ctx):
                cctx = self.lock.fn_ctx.get(callee)
                if cctx is None or not self.in_scope(cctx.module) \
                        or cctx.module.relpath.endswith(
                            "monitoring/failpoints.py"):
                    continue
                sub = self.fires_failpoint(callee, cctx, depth + 1)
                if sub:
                    result = [_hop(ctx.module, node,
                                   f"{fn.name}() calls "
                                   f"{callee.name}()")] + sub
                    break
            if result:
                break
        self._fires_memo[key] = result
        return result


def get_propagation_analysis(project: Project) -> _PropagationAnalysis:
    cached = getattr(project, "_dflint_propagation", None)
    if cached is None:
        cached = _PropagationAnalysis(project)
        project._dflint_propagation = cached
    return cached


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@register
class DeadlinePropagation(Rule):
    """An outbound leg under a deadline scope must derive its socket
    timeout from the remaining budget and forward the shrunken
    X-Deadline-Ms header; dropping either turns the deadline machinery
    into dead code for that path."""

    name = "deadline-propagation"

    def check_project(self, project: Project) -> List[Finding]:
        an = get_propagation_analysis(project)
        out: List[Finding] = []
        for fn, ctx in an.fns():
            if not an.deadline_scoped(fn):
                continue
            derives, forwards = an.budget_evidence(fn)
            for node in _own_walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if an.outbound_site(node):
                    if not derives or not forwards:
                        missing = []
                        if not derives:
                            missing.append("derive the socket timeout from "
                                           "remaining_ms/leg_timeout_s")
                        if not forwards:
                            missing.append("forward a shrunken "
                                           "X-Deadline-Ms header")
                        out.append(self.finding(ctx.module, node, (
                            f"{fn.name}() holds a request deadline but "
                            f"this outbound leg does not "
                            f"{' or '.join(missing)} — the budget dies "
                            f"on this hop")))
                    continue
                for cm, callee in an.lock._resolve_callees(node, ctx):
                    cctx = an.lock.fn_ctx.get(callee)
                    if cctx is None or not an.in_scope(cctx.module):
                        continue
                    if "deadline" in an.params_of(callee):
                        if not an.passes_deadline(node, callee):
                            out.append(self.finding(ctx.module, node, (
                                f"{fn.name}() holds a request deadline "
                                f"but calls deadline-aware "
                                f"{callee.name}() without passing it — "
                                f"the callee's legs fall back to default "
                                f"timeouts"),
                                related=[_hop(cm, callee,
                                              f"{callee.name}() accepts a "
                                              f"deadline parameter")]))
                        continue
                    chain = an.unbudgeted_outbound(callee, cctx)
                    if chain:
                        out.append(self.finding(ctx.module, node, (
                            f"{fn.name}() holds a request deadline but "
                            f"calls {callee.name}(), which reaches an "
                            f"outbound leg with no deadline handoff — "
                            f"the leg runs on a budget-blind timeout"),
                            related=chain))
        return _narrow(project, out)


@register
class TraceContextLoss(Rule):
    """Thread/pool submissions reachable from a span scope must capture
    the TraceContext — otherwise every span opened on the worker thread
    detaches from the request trace and the hop disappears from
    /debug/trace."""

    name = "trace-context-loss"

    def check_project(self, project: Project) -> List[Finding]:
        an = get_propagation_analysis(project)
        reach = an.span_reachable(an.span_fns())
        submit_safe = an.executor_submit_captures()
        out: List[Finding] = []
        for fn, chain in reach.items():
            ctx = an.lock.fn_ctx.get(fn)
            if ctx is None or not an.in_scope(ctx.module) \
                    or ctx.module.relpath.endswith("monitoring/trace.py"):
                continue
            if an.captures_context(fn):
                continue
            for node in _own_walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                is_thread = (isinstance(f, ast.Attribute)
                             and f.attr == "Thread") or \
                    (isinstance(f, ast.Name) and f.id == "Thread")
                is_submit = (isinstance(f, ast.Attribute)
                             and f.attr == "submit"
                             and not submit_safe
                             and self._executor_receiver(f.value))
                if not (is_thread or is_submit):
                    continue
                if is_thread and an.thread_target_captures(node, fn, ctx):
                    continue
                kind = "threading.Thread" if is_thread else "executor submit"
                out.append(self.finding(ctx.module, node, (
                    f"{kind} in {fn.name}() is reachable from a span "
                    f"scope but nothing captures the TraceContext "
                    f"(tracer.current() / tracer.context(...)) — spans on "
                    f"the new thread silently detach from the request "
                    f"trace"), related=chain))
        return _narrow(project, out)

    @staticmethod
    def _executor_receiver(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return "executor" in expr.id.lower() or expr.id in ("ex", "pool")
        if isinstance(expr, ast.Attribute):
            return "executor" in expr.attr.lower()
        return False


@register
class ErrorPathAccounting(Rule):
    """An except edge guarding a failpoint-armed call must re-raise or
    account the failure (counter inc/observe, supervisor note_*/
    report_failure) — a swallowed failure makes chaos invariants pass
    vacuously."""

    name = "error-path-accounting"

    def check_project(self, project: Project) -> List[Finding]:
        an = get_propagation_analysis(project)
        out: List[Finding] = []
        for fn, ctx in an.fns():
            if ctx.module.relpath.endswith("monitoring/failpoints.py"):
                continue
            for node in _own_walk(fn):
                if not isinstance(node, ast.Try):
                    continue
                chain = self._try_fires(an, node, ctx)
                if not chain:
                    continue
                for handler in node.handlers:
                    if not self._catches_failpoint(handler):
                        continue
                    if self._accounts(handler):
                        continue
                    out.append(self.finding(ctx.module, handler, (
                        f"except path in {fn.name}() guards a "
                        f"failpoint-armed call but neither re-raises nor "
                        f"accounts the failure (counter inc/observe or "
                        f"supervisor note_*/report_failure) — injected "
                        f"faults vanish here and the chaos invariant "
                        f"passes vacuously"), related=chain))
        return _narrow(project, out)

    def _try_fires(self, an: _PropagationAnalysis, try_node: ast.Try,
                   ctx) -> Optional[List[Tuple[str, int, str]]]:
        todo: List[ast.AST] = list(try_node.body)
        while todo:
            node = todo.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.Try)):
                continue
            if isinstance(node, ast.Call):
                name = _call_name(node)
                if name in ("failpoint", "failpoint_data"):
                    return [_hop(ctx.module, node, "failpoint armed here")]
                for cm, callee in an.lock._resolve_callees(node, ctx):
                    cctx = an.lock.fn_ctx.get(callee)
                    if cctx is None or not an.in_scope(cctx.module) \
                            or cctx.module.relpath.endswith(
                                "monitoring/failpoints.py"):
                        continue
                    sub = an.fires_failpoint(callee, cctx, depth=1)
                    if sub:
                        return [_hop(ctx.module, node,
                                     f"call into {callee.name}()")] + sub
            todo.extend(ast.iter_child_nodes(node))
        return None

    @staticmethod
    def _catches_failpoint(handler: ast.ExceptHandler) -> bool:
        if handler.type is None:
            return True
        types = handler.type.elts \
            if isinstance(handler.type, ast.Tuple) else [handler.type]
        for t in types:
            name = t.attr if isinstance(t, ast.Attribute) else (
                t.id if isinstance(t, ast.Name) else "")
            if name in _FAILPOINT_CATCHES:
                return True
        return False

    @staticmethod
    def _accounts(handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.AugAssign):
                return True
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in _ACCOUNT_ATTRS or attr.startswith("note_"):
                    return True
        return False
