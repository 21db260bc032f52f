"""dfproto layer 1: cross-process HTTP protocol-contract extraction.

The serving surface is a multi-process fleet — front door, replicas, a
dozen endpoints, deadline/trace/shard headers, Retry-After ladders — and
every one of those contracts is maintained by hand in parallel across
handler classes, forwarding legs, the dataplane pool, and the bench/chaos
/smoke scripts.  This module recovers both sides of the contract from the
ASTs and cross-checks them:

* **server side** — every ``BaseHTTPRequestHandler`` subclass (a class
  with ``do_*`` methods) outside ``scripts/`` is walked with a symbolic
  route environment: ``self.path`` / ``urlsplit(self.path).path``
  comparisons split the walk into per-route branches, send-helper calls
  (``_send`` / ``_send_json`` / raw ``send_response``) record the status
  codes, written headers (including conditional ``extra_headers`` arms)
  and top-level JSON payload fields reachable on each route, and
  ``self.headers.get(...)`` (directly or via a helper such as
  ``deadline_from_headers`` that receives ``self.headers``) records the
  headers each route reads;
* **client side** — every in-repo call site of the HTTP primitives
  (``conn.request`` / ``putrequest`` / ``pooled_get``) plus any wrapper
  whose path argument is a parameter (``_fetch``, script ``_post``
  helpers, ...) records the route each client hits, the status codes it
  compares against, and the headers it sends and reads (tests exempt).

Five rules consume the shared extraction (built once per project, like
the lock-order analysis): ``proto-unserved-route``,
``proto-status-drift``, ``proto-header-drift``, ``proto-retry-after``
and ``proto-endpoint-table-drift`` (the docs/serving.md table must match
the extracted contract bitwise, both directions).

Pure AST + stdlib like the rest of the analysis package.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from distributed_forecasting_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Project,
    Rule,
    register,
)
from distributed_forecasting_tpu_torch.analysis.callgraph import (
    get_callgraph,
    module_name,
)
from distributed_forecasting_tpu_torch.analysis.rules_drift import (
    _doc_snippet,
    _is_test_module,
    _literal_str,
)

#: hop-by-hop / entity headers every HTTP client and server exchanges —
#: exempt from both the drift cross-check and the endpoint table, which
#: document only the *application* contract
STANDARD_HEADERS = frozenset({
    "Content-Type", "Content-Length", "Connection", "Host", "Accept",
    "User-Agent", "Accept-Encoding", "Keep-Alive", "Transfer-Encoding",
})

#: statuses that MUST carry a Retry-After so clients can back off sanely
_RETRYABLE = frozenset({429, 503})

#: the catch-all pseudo-route: emissions not gated on a path comparison
CATCH_ALL = "*"


# ---------------------------------------------------------------------------
# shared small parsers
# ---------------------------------------------------------------------------

def _str_values(node: ast.AST) -> FrozenSet[str]:
    """``"/x"`` or ``("/x", "/y")`` -> the set of string literals."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return frozenset({node.value})
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = set()
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                vals.add(elt.value)
            else:
                return frozenset()
        return frozenset(vals)
    return frozenset()


def _status_set(node: ast.AST) -> FrozenSet[int]:
    """Literal status codes an expression can evaluate to (dynamic -> {})."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return frozenset({node.value})
    if isinstance(node, ast.IfExp):
        return _status_set(node.body) | _status_set(node.orelse)
    return frozenset()


def _header_names(node: Optional[ast.AST]) -> FrozenSet[str]:
    """Header names in an ``extra_headers`` expression: a tuple/list of
    ``(name, value)`` pairs, possibly behind an ``IfExp`` (conditional
    headers count as may-write)."""
    if node is None:
        return frozenset()
    if isinstance(node, ast.IfExp):
        return _header_names(node.body) | _header_names(node.orelse)
    names: Set[str] = set()
    if isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            if isinstance(elt, (ast.Tuple, ast.List)) and elt.elts:
                name = _literal_str(elt.elts[0])
                if name:
                    names.add(name)
    return frozenset(names)


def _dict_fields(call: ast.Call) -> FrozenSet[str]:
    """Top-level string keys of any dict-literal argument (the JSON
    response body shape)."""
    fields: Set[str] = set()
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(arg, ast.Dict):
            for key in arg.keys:
                if isinstance(key, ast.Constant) and isinstance(key.value, str):
                    fields.add(key.value)
    return frozenset(fields)


def _is_self_headers(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "headers"
            and isinstance(node.value, ast.Name) and node.value.id == "self")


def _terminates(stmts: Sequence[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(stmts[-1], (ast.Return, ast.Raise,
                                                  ast.Continue, ast.Break))


def _own_walk(fn: ast.AST):
    """Walk a function body without descending into nested defs/classes."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# the route environment: which paths can a statement be reached under?
# ---------------------------------------------------------------------------

#: (base, excluded, excluded_prefixes): base=None means "any route of the
#: method" minus the exclusions; an explicit base set came from a positive
#: path comparison on the dominating branch.
RouteEnv = Tuple[Optional[FrozenSet[str]], FrozenSet[str], Tuple[str, ...]]

_TOP_ENV: RouteEnv = (None, frozenset(), ())


def _env_intersect(env: RouteEnv, vals: FrozenSet[str]) -> RouteEnv:
    base, exc, pref = env
    return (vals if base is None else (base & vals), exc, pref)


def _env_exclude(env: RouteEnv, vals: FrozenSet[str]) -> RouteEnv:
    base, exc, pref = env
    return (base, exc | vals, pref)


def _env_exclude_prefix(env: RouteEnv, prefix: str) -> RouteEnv:
    base, exc, pref = env
    return (base, exc, pref + (prefix,))


# ---------------------------------------------------------------------------
# extraction result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RouteContract:
    path: str
    methods: Set[str] = dataclasses.field(default_factory=set)
    statuses: Set[int] = dataclasses.field(default_factory=set)
    headers_read: Set[str] = dataclasses.field(default_factory=set)
    headers_written: Set[str] = dataclasses.field(default_factory=set)
    fields: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class Emission:
    """One server send site with its statically-known statuses/headers."""
    module: ModuleInfo
    node: ast.AST
    method: str
    env: RouteEnv
    statuses: FrozenSet[int]
    headers: FrozenSet[str]
    fields: FrozenSet[str]


@dataclasses.dataclass
class ClientRoute:
    module: ModuleInfo
    node: ast.AST
    path: str
    method: Optional[str]


# ---------------------------------------------------------------------------
# server-side extraction: one walker per handler class
# ---------------------------------------------------------------------------

class _HandlerWalker:
    def __init__(self, analysis: "ProtocolAnalysis", module: ModuleInfo,
                 cls: ast.ClassDef):
        self.analysis = analysis
        self.module = module
        self.cls = cls
        self.methods: Dict[str, ast.AST] = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.helpers: Dict[str, FrozenSet[str]] = self._find_helpers()
        # discovered per HTTP method during the walk
        self.method_routes: Dict[str, Set[str]] = {}
        self.emissions: List[Emission] = []
        #: (header, method, env, node) read/write events, distributed later
        self.reads: List[Tuple[str, str, RouteEnv, ast.AST]] = []
        self.writes: List[Tuple[str, str, RouteEnv, ast.AST]] = []
        self._emitted: Set[Tuple[int, RouteEnv]] = set()
        self.current_method = ""
        #: locally built ``[(name, value), ...]`` header lists, so
        #: ``extra_headers=tuple(headers)`` resolves (may-write union
        #: across the class — good enough for contract extraction)
        self.header_lists: Dict[str, Set[str]] = {}

    # -- send-helper discovery ---------------------------------------------
    def _first_param(self, fn: ast.AST) -> Optional[str]:
        args = [a.arg for a in fn.args.args]
        args = args[1:] if args and args[0] == "self" else args
        return args[0] if args else None

    def _find_helpers(self) -> Dict[str, FrozenSet[str]]:
        """Methods that forward their first (status) parameter into
        ``send_response`` — directly or through another helper.  Maps the
        helper name to the header names it always/conditionally writes via
        its own ``send_header`` calls (transitively)."""
        helpers: Dict[str, FrozenSet[str]] = {}
        changed = True
        while changed:
            changed = False
            for name, fn in self.methods.items():
                if name in helpers or name.startswith("do_"):
                    continue
                status_param = self._first_param(fn)
                if status_param is None:
                    continue
                base: Set[str] = set()
                is_helper = False
                for node in _own_walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    f = node.func
                    if not (isinstance(f, ast.Attribute)
                            and isinstance(f.value, ast.Name)
                            and f.value.id == "self"):
                        continue
                    if f.attr == "send_header" and node.args:
                        lit = _literal_str(node.args[0])
                        if lit:
                            base.add(lit)
                    passes_status = bool(
                        node.args and isinstance(node.args[0], ast.Name)
                        and node.args[0].id == status_param)
                    if passes_status and (f.attr == "send_response"
                                          or f.attr in helpers):
                        is_helper = True
                        base |= helpers.get(f.attr, frozenset())
                if is_helper and name not in helpers:
                    helpers[name] = frozenset(base)
                    changed = True
        return helpers

    def _extra_headers_expr(self, helper: str,
                            call: ast.Call) -> Optional[ast.AST]:
        for kw in call.keywords:
            if kw.arg == "extra_headers":
                return kw.value
        fn = self.methods.get(helper)
        if fn is not None:
            params = [a.arg for a in fn.args.args]
            params = params[1:] if params and params[0] == "self" else params
            if "extra_headers" in params:
                idx = params.index("extra_headers")
                if len(call.args) > idx:
                    return call.args[idx]
        return None

    # -- the walk ----------------------------------------------------------
    def run(self) -> None:
        for name, fn in self.methods.items():
            if name.startswith("do_") and len(name) > 3:
                self.current_method = name[3:]
                self.method_routes.setdefault(self.current_method, set())
                self._walk(fn.body, _TOP_ENV, {}, {name})

    def _discover(self, routes: FrozenSet[str]) -> None:
        self.method_routes.setdefault(self.current_method, set()).update(routes)

    def _is_path_expr(self, node: ast.AST, aliases: Dict[str, str]) -> bool:
        if isinstance(node, ast.Name):
            return aliases.get(node.id) == "str"
        if isinstance(node, ast.Attribute) and node.attr == "path":
            v = node.value
            if isinstance(v, ast.Name):
                return v.id == "self" or aliases.get(v.id) == "url"
        return False

    def _route_test(self, test: ast.AST, aliases: Dict[str, str]):
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and self._is_path_expr(test.left, aliases):
            op, comp = test.ops[0], test.comparators[0]
            vals = _str_values(comp)
            if vals and isinstance(op, (ast.Eq, ast.In)):
                return ("eq", vals)
            if vals and isinstance(op, (ast.NotEq, ast.NotIn)):
                return ("neq", vals)
        if isinstance(test, ast.Call) and isinstance(test.func, ast.Attribute) \
                and test.func.attr == "startswith" and test.args \
                and self._is_path_expr(test.func.value, aliases):
            prefix = _literal_str(test.args[0])
            if prefix:
                return ("prefix", prefix)
        return None

    def _track_alias(self, st: ast.Assign, aliases: Dict[str, str]) -> None:
        if len(st.targets) != 1 or not isinstance(st.targets[0], ast.Name):
            return
        name = st.targets[0].id
        v = st.value
        if isinstance(v, (ast.Tuple, ast.List)):
            hdrs = _header_names(v)
            if hdrs:
                self.header_lists.setdefault(name, set()).update(hdrs)
        if isinstance(v, ast.Call):
            f = v.func
            fname = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            if fname in ("urlsplit", "urlparse") and v.args \
                    and self._is_path_expr(v.args[0], aliases):
                aliases[name] = "url"
                return
        if self._is_path_expr(v, aliases):
            aliases[name] = "str"

    def _walk(self, stmts: Sequence[ast.stmt], env: RouteEnv,
              aliases: Dict[str, str], stack: Set[str]) -> None:
        for st in stmts:
            if isinstance(st, ast.If):
                t = self._route_test(st.test, aliases)
                if t and t[0] == "eq":
                    self._discover(t[1])
                    self._walk(st.body, _env_intersect(env, t[1]),
                               dict(aliases), stack)
                    self._walk(st.orelse, _env_exclude(env, t[1]),
                               dict(aliases), stack)
                    if _terminates(st.body):
                        env = _env_exclude(env, t[1])
                elif t and t[0] == "neq":
                    self._discover(t[1])
                    self._walk(st.body, _env_exclude(env, t[1]),
                               dict(aliases), stack)
                    self._walk(st.orelse, _env_intersect(env, t[1]),
                               dict(aliases), stack)
                    if _terminates(st.body):
                        env = _env_intersect(env, t[1])
                elif t and t[0] == "prefix":
                    self._walk(st.body, env, dict(aliases), stack)
                    self._walk(st.orelse, env, dict(aliases), stack)
                    if _terminates(st.body):
                        env = _env_exclude_prefix(env, t[1])
                else:
                    self._scan_expr(st.test, env, aliases, stack)
                    self._walk(st.body, env, dict(aliases), stack)
                    self._walk(st.orelse, env, dict(aliases), stack)
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                self._scan_expr(st.iter, env, aliases, stack)
                self._walk(st.body, env, dict(aliases), stack)
                self._walk(st.orelse, env, dict(aliases), stack)
            elif isinstance(st, ast.While):
                self._scan_expr(st.test, env, aliases, stack)
                self._walk(st.body, env, dict(aliases), stack)
                self._walk(st.orelse, env, dict(aliases), stack)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    self._scan_expr(item.context_expr, env, aliases, stack)
                self._walk(st.body, env, aliases, stack)
            elif isinstance(st, ast.Try):
                self._walk(st.body, env, dict(aliases), stack)
                for handler in st.handlers:
                    self._walk(handler.body, env, dict(aliases), stack)
                self._walk(st.orelse, env, dict(aliases), stack)
                self._walk(st.finalbody, env, dict(aliases), stack)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested closures (scatter legs, hedge legs) inherit the
                # enclosing route environment
                self._walk(st.body, env, dict(aliases), stack)
            elif isinstance(st, ast.Assign):
                self._scan_expr(st.value, env, aliases, stack)
                self._track_alias(st, aliases)
            elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
                if st.value is not None:
                    self._scan_expr(st.value, env, aliases, stack)
            elif isinstance(st, ast.Return):
                if st.value is not None:
                    self._scan_expr(st.value, env, aliases, stack)
            elif isinstance(st, ast.Expr):
                self._scan_expr(st.value, env, aliases, stack)
            elif isinstance(st, (ast.Raise, ast.Assert)):
                for child in ast.iter_child_nodes(st):
                    self._scan_expr(child, env, aliases, stack)

    def _emit(self, node: ast.AST, env: RouteEnv, statuses: FrozenSet[int],
              headers: FrozenSet[str], fields: FrozenSet[str]) -> None:
        key = (id(node), env)
        if key in self._emitted:
            return
        self._emitted.add(key)
        self.emissions.append(Emission(
            module=self.module, node=node, method=self.current_method,
            env=env, statuses=statuses, headers=headers, fields=fields))

    def _scan_expr(self, expr: ast.AST, env: RouteEnv,
                   aliases: Dict[str, str], stack: Set[str]) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Subscript) and \
                    _is_self_headers(node.value):
                lit = _literal_str(node.slice)
                if lit:
                    self.reads.append((lit, self.current_method, env, node))
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            # headers.append(("Retry-After", "1")) on a tracked local list
            if isinstance(f, ast.Attribute) and f.attr == "append" \
                    and isinstance(f.value, ast.Name) and node.args \
                    and isinstance(node.args[0], (ast.Tuple, ast.List)) \
                    and node.args[0].elts:
                lit = _literal_str(node.args[0].elts[0])
                if lit:
                    self.header_lists.setdefault(
                        f.value.id, set()).add(lit)
            # self.headers.get("X-...") — direct request-header read
            if isinstance(f, ast.Attribute) and f.attr == "get" \
                    and _is_self_headers(f.value) and node.args:
                lit = _literal_str(node.args[0])
                if lit:
                    self.reads.append((lit, self.current_method, env, node))
                continue
            # any call handed self.headers reads whatever its (transitive)
            # header-param summary reads — deadline_from_headers et al.
            if any(_is_self_headers(a) for a in node.args):
                callee = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else "")
                for hdr in self.analysis.helper_header_reads.get(callee, ()):
                    self.reads.append(
                        (hdr, self.current_method, env, node))
            if not (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"):
                continue
            name = f.attr
            if name == "send_response" and node.args:
                self._emit(node, env, _status_set(node.args[0]),
                           frozenset(), frozenset())
            elif name == "send_header" and node.args:
                lit = _literal_str(node.args[0])
                if lit:
                    self.writes.append(
                        (lit, self.current_method, env, node))
            elif name in self.helpers:
                statuses = _status_set(node.args[0]) if node.args \
                    else frozenset()
                extra = self._header_names_resolved(
                    self._extra_headers_expr(name, node))
                self._emit(node, env, statuses,
                           extra | self.helpers[name], _dict_fields(node))
            elif name in self.methods and name not in stack:
                callee = self.methods[name]
                callee_aliases = self._callee_aliases(callee, node, aliases)
                self._walk(callee.body, env, callee_aliases, stack | {name})

    def _header_names_resolved(self, node: Optional[ast.AST]) -> FrozenSet[str]:
        """Like :func:`_header_names`, but also resolves
        ``extra_headers=headers`` / ``extra_headers=tuple(headers)`` where
        ``headers`` is a locally built list of pairs (scatter's
        conditionally-appended Retry-After idiom)."""
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "tuple" and node.args:
            node = node.args[0]
        if isinstance(node, ast.Name):
            return frozenset(self.header_lists.get(node.id, ()))
        return _header_names(node)

    def _callee_aliases(self, callee: ast.AST, call: ast.Call,
                        aliases: Dict[str, str]) -> Dict[str, str]:
        """Propagate path/urlsplit aliasing through self-method calls:
        ``self._debug(parsed)`` makes the callee's ``parsed`` a url alias."""
        params = [a.arg for a in callee.args.args]
        params = params[1:] if params and params[0] == "self" else params
        out: Dict[str, str] = {}
        for idx, arg in enumerate(call.args):
            if idx >= len(params):
                break
            if isinstance(arg, ast.Name) and arg.id in aliases:
                out[params[idx]] = aliases[arg.id]
            elif self._is_path_expr(arg, aliases):
                out[params[idx]] = "str"
        return out

    # -- distribution ------------------------------------------------------
    def routes_for(self, method: str, env: RouteEnv) -> List[str]:
        base, exc, prefixes = env
        if base is not None:
            return sorted(base - exc)
        discovered = self.method_routes.get(method, set())
        out = [r for r in sorted(discovered)
               if r not in exc and not any(r.startswith(p) for p in prefixes)]
        out.append(CATCH_ALL)
        return out


# ---------------------------------------------------------------------------
# the shared, memoized project analysis
# ---------------------------------------------------------------------------

class ProtocolAnalysis:
    def __init__(self, project: Project):
        self.project = project
        self.graph = get_callgraph(project)
        #: per-module flattened AST, walked ONCE and shared by every
        #: extraction pass below (the walks dominate the analysis cost)
        self._node_cache: Dict[str, List[ast.AST]] = {}
        self.helper_header_reads = self._build_helper_reads()
        # server side
        self.routes: Dict[str, RouteContract] = {}
        self.emissions: List[Emission] = []
        self.server_reads: Dict[str, Tuple[ModuleInfo, ast.AST]] = {}
        self.server_writes: Dict[str, Tuple[ModuleInfo, ast.AST]] = {}
        # client side
        self.client_routes: List[ClientRoute] = []
        self.client_statuses: List[Tuple[ModuleInfo, ast.AST, int]] = []
        self.client_sends: Dict[str, Tuple[ModuleInfo, ast.AST]] = {}
        self.client_reads: Dict[str, Tuple[ModuleInfo, ast.AST]] = {}
        self._extract_servers()
        self._extract_clients()
        self._node_cache.clear()  # extraction done; free the flat ASTs

    def _nodes(self, mod: ModuleInfo) -> List[ast.AST]:
        cached = self._node_cache.get(mod.relpath)
        if cached is None:
            cached = list(ast.walk(mod.tree))
            self._node_cache[mod.relpath] = cached
        return cached

    # -- header-param helper summaries -------------------------------------
    def _build_helper_reads(self) -> Dict[str, FrozenSet[str]]:
        """For every function taking a header-ish parameter, which header
        names does it (transitively) read from it?  Keyed by bare function
        name; lets the handler walk see through ``sup.request_deadline(
        self.headers)`` -> ``deadline_from_headers(headers, ...)``."""
        reads: Dict[str, Set[str]] = {}
        passes: Dict[str, Set[str]] = {}
        for mod in self.project.all_modules:
            if mod.tree is None or _is_test_module(mod) \
                    or mod.segments[0] == "scripts":
                continue
            for fn in self._nodes(mod):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                params = {a.arg for a in fn.args.args
                          if "header" in a.arg.lower()}
                if not params:
                    continue
                mine = reads.setdefault(fn.name, set())
                onward = passes.setdefault(fn.name, set())
                for node in _own_walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    f = node.func
                    if isinstance(f, ast.Attribute) and f.attr == "get" \
                            and isinstance(f.value, ast.Name) \
                            and f.value.id in params and node.args:
                        lit = _literal_str(node.args[0])
                        if lit:
                            mine.add(lit)
                    elif any(isinstance(a, ast.Name) and a.id in params
                             for a in node.args):
                        callee = f.attr if isinstance(f, ast.Attribute) \
                            else (f.id if isinstance(f, ast.Name) else "")
                        if callee:
                            onward.add(callee)
        for _ in range(3):  # transitive closure, short chains in practice
            changed = False
            for name, callees in passes.items():
                for callee in callees:
                    extra = reads.get(callee, set()) - reads.get(name, set())
                    if extra:
                        reads.setdefault(name, set()).update(extra)
                        changed = True
            if not changed:
                break
        return {k: frozenset(v) for k, v in reads.items() if v}

    # -- server ------------------------------------------------------------
    def _extract_servers(self) -> None:
        # the whole world, not just the lint targets: a --changed-only run
        # over one client file must still see the handler's contract
        for mod in self.project.all_modules:
            if mod.tree is None or _is_test_module(mod) \
                    or mod.segments[0] == "scripts":
                continue
            for node in self._nodes(mod):
                if not isinstance(node, ast.ClassDef):
                    continue
                has_do = any(
                    isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and n.name.startswith("do_") and len(n.name) > 3
                    for n in node.body)
                if not has_do:
                    continue
                walker = _HandlerWalker(self, mod, node)
                walker.run()
                self._merge(walker)

    def _merge(self, walker: _HandlerWalker) -> None:
        self.emissions.extend(walker.emissions)
        for method, routes in walker.method_routes.items():
            for r in routes:
                self._contract(r).methods.add(method)
        for em in walker.emissions:
            for r in walker.routes_for(em.method, em.env):
                c = self._contract(r)
                c.methods.add(em.method)
                c.statuses.update(em.statuses)
                c.headers_written.update(em.headers)
                c.fields.update(em.fields)
        for hdr, method, env, node in walker.reads:
            self.server_reads.setdefault(hdr, (walker.module, node))
            for r in walker.routes_for(method, env):
                c = self._contract(r)
                c.methods.add(method)
                c.headers_read.add(hdr)
        for hdr, method, env, node in walker.writes:
            self.server_writes.setdefault(hdr, (walker.module, node))
            for r in walker.routes_for(method, env):
                c = self._contract(r)
                c.methods.add(method)
                c.headers_written.add(hdr)
        for em in walker.emissions:
            for hdr in em.headers:
                self.server_writes.setdefault(hdr, (em.module, em.node))

    def _contract(self, path: str) -> RouteContract:
        if path not in self.routes:
            self.routes[path] = RouteContract(path=path)
        return self.routes[path]

    # -- client ------------------------------------------------------------
    def _extract_clients(self) -> None:
        #: wrapper fns whose path argument is a parameter:
        #: key -> (param index among positional args, method or None)
        wrappers: Dict[Tuple[str, str], Tuple[int, Optional[str]]] = {}
        #: every (module, fn-or-None) pair we scan calls in
        scopes: List[Tuple[ModuleInfo, Optional[ast.AST]]] = []
        for mod in self.project.all_modules:
            if mod.tree is None or _is_test_module(mod):
                continue
            scopes.append((mod, None))
            for fn in self._nodes(mod):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scopes.append((mod, fn))

        def params_of(fn) -> List[str]:
            names = [a.arg for a in fn.args.args]
            return names[1:] if names and names[0] == "self" else names

        def wrapper_keys(mod: ModuleInfo, fn) -> List[Tuple[str, str]]:
            dotted = f"{module_name(mod.relpath)}.{fn.name}"
            return [(mod.relpath, fn.name), ("", dotted), ("bare", fn.name)]

        def record(mod, call, path_expr, method, fn) -> bool:
            """Classify one primitive/wrapper path argument.  Returns True
            when the site was fully classified."""
            lit = _literal_str(path_expr)
            if lit is not None:
                if lit.startswith("/"):
                    path = lit.split("?", 1)[0]
                    self.client_routes.append(
                        ClientRoute(mod, call, path, method))
                return True
            if fn is not None and isinstance(path_expr, ast.Name):
                names = params_of(fn)
                if path_expr.id in names:
                    idx = names.index(path_expr.id)
                    for key in wrapper_keys(mod, fn):
                        wrappers.setdefault(key, (idx, method))
                    return True
            return False

        def resolve_wrapper(mod: ModuleInfo, call: ast.Call):
            f = call.func
            if isinstance(f, ast.Name):
                hit = wrappers.get((mod.relpath, f.id))
                if hit:
                    return hit
                imap = self.graph.import_map(mod)
                dotted = imap.aliases.get(f.id)
                if dotted and ("", dotted) in wrappers:
                    return wrappers[("", dotted)]
            elif isinstance(f, ast.Attribute):
                imap = self.graph.import_map(mod)
                dotted = imap.dotted(f)
                if dotted and ("", dotted) in wrappers:
                    return wrappers[("", dotted)]
                return wrappers.get(("bare", f.attr))
            return None

        # walk each scope ONCE and keep its call sites: the fixpoint below
        # revisits every scope up to 4x, and re-walking the ASTs each round
        # is the single hottest loop in the analysis
        scope_calls: List[Tuple[ModuleInfo, Optional[ast.AST],
                                List[ast.Call]]] = []
        for mod, fn in scopes:
            body = fn if fn is not None else mod.tree
            calls = [n for n in _own_walk(body) if isinstance(n, ast.Call)]
            if calls:
                scope_calls.append((mod, fn, calls))
        classified: Set[int] = set()

        def scan(primitives_only: bool) -> None:
            for mod, fn, calls in scope_calls:
                for node in calls:
                    if id(node) in classified:
                        continue
                    f = node.func
                    attr = f.attr if isinstance(f, ast.Attribute) else None
                    name = f.id if isinstance(f, ast.Name) else attr
                    if attr in ("request", "putrequest") \
                            and len(node.args) >= 2:
                        method = _literal_str(node.args[0])
                        if record(mod, node, node.args[1], method, fn):
                            classified.add(id(node))
                    elif name == "pooled_get":
                        path_expr = None
                        if len(node.args) >= 4:
                            path_expr = node.args[3]
                        for kw in node.keywords:
                            if kw.arg == "path":
                                path_expr = kw.value
                        if path_expr is not None and \
                                record(mod, node, path_expr, "GET", fn):
                            classified.add(id(node))
                    elif not primitives_only:
                        hit = resolve_wrapper(mod, node)
                        if hit is not None:
                            idx, method = hit
                            path_expr = None
                            if len(node.args) > idx:
                                path_expr = node.args[idx]
                            if path_expr is not None and \
                                    record(mod, node, path_expr, method, fn):
                                classified.add(id(node))

        scan(primitives_only=True)
        for _ in range(3):  # wrapper-of-wrapper fixpoint
            before = len(wrappers), len(self.client_routes)
            scan(primitives_only=False)
            if (len(wrappers), len(self.client_routes)) == before:
                break
        self._scan_client_statuses_and_headers()

    def _scan_client_statuses_and_headers(self) -> None:
        for mod in self.project.all_modules:
            if mod.tree is None or _is_test_module(mod):
                continue
            in_scripts = mod.segments[0] == "scripts"
            # names assigned from dict(resp.getheaders()) — their .get()
            # calls are client-side response-header reads
            derived: Set[str] = set()
            nodes = self._nodes(mod)
            for node in nodes:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Call):
                    v = node.value
                    if isinstance(v.func, ast.Name) and v.func.id == "dict" \
                            and v.args and isinstance(v.args[0], ast.Call) \
                            and isinstance(v.args[0].func, ast.Attribute) \
                            and v.args[0].func.attr == "getheaders":
                        derived.add(node.targets[0].id)
            for node in nodes:
                if isinstance(node, ast.Compare) and len(node.ops) == 1 \
                        and isinstance(node.ops[0], (ast.Eq, ast.In)):
                    left = node.left
                    is_status = (
                        (isinstance(left, ast.Attribute)
                         and left.attr in ("status", "code"))
                        or (isinstance(left, ast.Name)
                            and (left.id in ("status", "code")
                                 or left.id.endswith("_status"))))
                    if is_status:
                        for val in _status_values(node.comparators[0]):
                            self.client_statuses.append((mod, node, val))
                if not isinstance(node, ast.Call):
                    if isinstance(node, ast.Assign) and len(node.targets) == 1:
                        tgt = node.targets[0]
                        if isinstance(tgt, ast.Subscript) \
                                and isinstance(tgt.value, ast.Name) \
                                and "header" in tgt.value.id.lower():
                            lit = _literal_str(tgt.slice)
                            if lit:
                                self.client_sends.setdefault(lit, (mod, tgt))
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "getheader" \
                        and node.args:
                    lit = _literal_str(node.args[0])
                    if lit:
                        self.client_reads.setdefault(lit, (mod, node))
                if isinstance(f, ast.Attribute) and f.attr == "get" \
                        and isinstance(f.value, ast.Name) \
                        and (f.value.id in derived
                             or (in_scripts
                                 and "header" in f.value.id.lower())) \
                        and node.args:
                    lit = _literal_str(node.args[0])
                    if lit:
                        self.client_reads.setdefault(lit, (mod, node))
                if isinstance(f, ast.Attribute) and f.attr == "putheader" \
                        and node.args:
                    lit = _literal_str(node.args[0])
                    if lit:
                        self.client_sends.setdefault(lit, (mod, node))
                for kw in node.keywords:
                    if kw.arg == "headers" and isinstance(kw.value, ast.Dict):
                        for key in kw.value.keys:
                            if isinstance(key, ast.Constant) \
                                    and isinstance(key.value, str):
                                self.client_sends.setdefault(
                                    key.value, (mod, node))


def _status_values(node: ast.AST) -> List[int]:
    out: List[int] = []
    nodes = node.elts if isinstance(node, (ast.Tuple, ast.List,
                                           ast.Set)) else [node]
    for n in nodes:
        if isinstance(n, ast.Constant) and isinstance(n.value, int) \
                and not isinstance(n.value, bool) and 100 <= n.value <= 599:
            out.append(n.value)
    return out


def get_protocol_analysis(project: Project) -> ProtocolAnalysis:
    cached = getattr(project, "_dflint_protocol", None)
    if cached is None:
        cached = ProtocolAnalysis(project)
        project._dflint_protocol = cached
    return cached


# ---------------------------------------------------------------------------
# the generated-format endpoint table (docs/serving.md)
# ---------------------------------------------------------------------------

ENDPOINT_DOC = "docs/serving.md"
ENDPOINT_SECTION = "## Endpoint contract"

_TABLE_HEADER = ("| route | methods | statuses | reads | writes |",
                 "| --- | --- | --- | --- | --- |")


def render_endpoint_table(routes: Dict[str, RouteContract]) -> List[str]:
    """The canonical table: one format, generated from the extraction, so
    the docs can be regenerated with ``python -m
    distributed_forecasting_tpu_torch.analysis.protocol`` and the drift rule
    can compare bitwise."""
    lines = list(_TABLE_HEADER)
    for path in sorted(routes, key=lambda p: (p == CATCH_ALL, p)):
        c = routes[path]
        methods = ", ".join(sorted(c.methods)) or "—"
        statuses = ", ".join(str(s) for s in sorted(c.statuses)) or "—"
        reads = ", ".join(
            f"`{h}`" for h in sorted(c.headers_read - STANDARD_HEADERS)) \
            or "—"
        writes = ", ".join(
            f"`{h}`" for h in sorted(c.headers_written - STANDARD_HEADERS)) \
            or "—"
        lines.append(
            f"| `{path}` | {methods} | {statuses} | {reads} | {writes} |")
    return lines


def _doc_table_rows(project: Project, relpath: str,
                    section: str):
    """(doc_exists, section_line, [(line_no, row_text), ...])."""
    lines = project.read_lines(relpath)
    if lines is None:
        return (False, None, [])
    in_section = False
    section_line = None
    rows: List[Tuple[int, str]] = []
    for i, raw in enumerate(lines, 1):
        s = raw.strip()
        if s.startswith("## "):
            if in_section:
                break
            if s == section:
                in_section = True
                section_line = i
            continue
        if in_section and s.startswith("|"):
            rows.append((i, s))
    return (True, section_line, rows)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

class _ProtoRule(Rule):
    """Base: out of scope (no findings) when the project has no handler
    classes — fixture trees for other rule families stay clean.

    Extraction covers ``all_modules``; findings are then narrowed to the
    lint targets (plus doc-anchored findings, which have no module), so
    ``--changed-only`` reports only the files actually touched while the
    cross-process model stays whole-world."""

    def check_project(self, project: Project) -> List[Finding]:
        analysis = get_protocol_analysis(project)
        if not analysis.routes:
            return []
        targets = {m.relpath for m in project.modules}
        return [f for f in self._check(project, analysis)
                if f.path in targets or not f.path.endswith(".py")]

    def _check(self, project: Project,
               analysis: ProtocolAnalysis) -> List[Finding]:
        raise NotImplementedError


@register
class UnservedRoute(_ProtoRule):
    """A client hits a (path, method) no handler serves — a typo'd route
    or an endpoint that was renamed server-side without updating the
    callers; the request can only ever 404."""

    name = "proto-unserved-route"

    def _check(self, project, analysis) -> List[Finding]:
        out: List[Finding] = []
        served = {p for p in analysis.routes if p != CATCH_ALL}
        for cr in analysis.client_routes:
            if cr.path in served:
                contract = analysis.routes[cr.path]
                if cr.method and cr.method not in contract.methods:
                    out.append(self.finding(cr.module, cr.node, (
                        f"client sends {cr.method} to {cr.path!r} but the "
                        f"extracted contract serves it only for "
                        f"{sorted(contract.methods)}")))
                continue
            sample = ", ".join(sorted(served)[:8])
            out.append(self.finding(cr.module, cr.node, (
                f"client targets route {cr.path!r} which no handler "
                f"serves — served routes include: {sample}")))
        return out


@register
class StatusDrift(_ProtoRule):
    """A client compares a response status against a code no handler can
    emit — the branch is dead (or the server lost a status the client
    still depends on)."""

    name = "proto-status-drift"

    def _check(self, project, analysis) -> List[Finding]:
        emitted: Set[int] = set()
        for c in analysis.routes.values():
            emitted.update(c.statuses)
        out: List[Finding] = []
        for mod, node, status in analysis.client_statuses:
            if status not in emitted:
                out.append(self.finding(mod, node, (
                    f"client branches on HTTP status {status}, which no "
                    f"handler emission can produce (extracted statuses: "
                    f"{sorted(emitted)})")))
        return out


@register
class HeaderDrift(_ProtoRule):
    """A custom header flows in only one direction: written but never
    read, read but never sent (and the two converse directions).  Each is
    either dead weight or a silently-broken propagation — e.g. a forward
    leg that drops ``X-Deadline-Ms``."""

    name = "proto-header-drift"

    def _check(self, project, analysis) -> List[Finding]:
        out: List[Finding] = []
        s_reads = set(analysis.server_reads) - STANDARD_HEADERS
        s_writes = set(analysis.server_writes) - STANDARD_HEADERS
        c_sends = set(analysis.client_sends) - STANDARD_HEADERS
        c_reads = set(analysis.client_reads) - STANDARD_HEADERS
        for hdr in sorted(s_reads - c_sends):
            mod, node = analysis.server_reads[hdr]
            out.append(self.finding(mod, node, (
                f"handler reads request header {hdr!r} but no in-repo "
                f"client ever sends it — the branch is dead in every "
                f"in-repo flow (or a forwarding leg dropped the header)")))
        for hdr in sorted(s_writes - c_reads):
            mod, node = analysis.server_writes[hdr]
            out.append(self.finding(mod, node, (
                f"handler writes response header {hdr!r} but no in-repo "
                f"client or harness ever reads it — untested contract "
                f"surface; read it in bench/chaos or drop it")))
        for hdr in sorted(c_sends - s_reads):
            mod, node = analysis.client_sends[hdr]
            out.append(self.finding(mod, node, (
                f"client sends request header {hdr!r} but no handler "
                f"reads it — silently ignored on every route")))
        for hdr in sorted(c_reads - s_writes):
            mod, node = analysis.client_reads[hdr]
            out.append(self.finding(mod, node, (
                f"client reads response header {hdr!r} but no handler "
                f"writes it — the lookup can only miss")))
        return out


@register
class RetryAfter(_ProtoRule):
    """Every 503/429 emission must carry Retry-After: the resilience
    layer's clients (and any external load balancer) key their backoff on
    it, and a shed without it turns graceful degradation into a retry
    storm."""

    name = "proto-retry-after"

    def _check(self, project, analysis) -> List[Finding]:
        out: List[Finding] = []
        for em in analysis.emissions:
            retryable = em.statuses & _RETRYABLE
            if retryable and "Retry-After" not in em.headers:
                codes = ", ".join(str(s) for s in sorted(retryable))
                out.append(self.finding(em.module, em.node, (
                    f"emission can answer {codes} without a Retry-After "
                    f"header — backoff-capable statuses must tell clients "
                    f"when to come back (pass extra_headers)")))
        return out


@register
class EndpointTableDrift(_ProtoRule):
    """docs/serving.md '## Endpoint contract' must equal the extracted
    contract bitwise, both directions — same generated format, so a new
    endpoint (or a status/header change) cannot land undocumented and a
    stale row cannot outlive its route."""

    name = "proto-endpoint-table-drift"
    doc_path = ENDPOINT_DOC
    section = ENDPOINT_SECTION

    def _check(self, project, analysis) -> List[Finding]:
        doc_exists, section_line, rows = _doc_table_rows(
            project, self.doc_path, self.section)
        if not doc_exists:
            return []  # out-of-scope tree (fixtures): nothing to drift
        expected = render_endpoint_table(analysis.routes)
        out: List[Finding] = []
        if section_line is None:
            mod, node = self._anchor(analysis)
            out.append(self.finding(mod, node, (
                f"{self.doc_path} has no '{self.section}' section but the "
                f"tree serves {len(analysis.routes)} routes — regenerate "
                f"the table with `python -m "
                f"distributed_forecasting_tpu_torch.analysis.protocol`")))
            return out
        actual = [text for _, text in rows]
        actual_lines = {text: line for line, text in rows}
        for row in expected:
            if row not in actual_lines:
                out.append(Finding(
                    rule=self.name, severity=self.default_severity,
                    path=self.doc_path, line=section_line,
                    message=(f"{self.doc_path} endpoint table is missing "
                             f"the generated row: {row}"),
                    snippet=_doc_snippet(project, self.doc_path,
                                         section_line)))
        expected_set = set(expected)
        for line, text in rows:
            if text not in expected_set:
                out.append(Finding(
                    rule=self.name, severity=self.default_severity,
                    path=self.doc_path, line=line,
                    message=(f"{self.doc_path} endpoint table row does not "
                             f"match the extracted contract — stale or "
                             f"hand-edited; regenerate with `python -m "
                             f"distributed_forecasting_tpu_torch.analysis"
                             f".protocol`"),
                    snippet=_doc_snippet(project, self.doc_path, line)))
        if not out and actual != expected:
            out.append(Finding(
                rule=self.name, severity=self.default_severity,
                path=self.doc_path, line=section_line,
                message=(f"{self.doc_path} endpoint table rows are out of "
                         f"order relative to the generated format — "
                         f"regenerate to keep the diff-free guarantee"),
                snippet=_doc_snippet(project, self.doc_path, section_line)))
        return out

    def _anchor(self, analysis) -> Tuple[ModuleInfo, ast.AST]:
        em = analysis.emissions[0]
        return em.module, em.node


if __name__ == "__main__":  # pragma: no cover — table regeneration helper
    import os
    import sys

    from distributed_forecasting_tpu_torch.analysis.core import build_project

    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.getcwd())
    proj = build_project(root, [root])
    table = render_endpoint_table(get_protocol_analysis(proj).routes)
    print("\n".join(table))
