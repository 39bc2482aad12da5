"""AST lint for threading discipline (CONC/LOOP/LOCK/THRD families).

The runtime's concurrency correctness rests on invariants that used to
live only in prose: callbacks fire OUTSIDE locks, the event-loop
thread never blocks, daemon threads have a shutdown path. This
pass makes them machine-checked. It builds, per module, a lock-scope
model (``with self._lock:`` blocks and explicit ``acquire()``..
``release()`` regions, lock identity by attribute path — ``self._lock``
inside ``Foo`` is the lock ``Foo._lock``) and a name-resolved call
graph, then reports:

- ``LOCK001`` lock-order inversion — two locks acquired in both orders
  anywhere in the static call graph (transitively: holding A and calling
  a function whose closure acquires B counts as A→B).
- ``LOCK002`` callback fired under a lock — a user-supplied callback,
  ``Responder.respond``, or listener invocation reachable while a lock
  is held. The fix is always snapshot-then-fire: collect under the lock,
  invoke after release.
- ``LOOP001`` blocking call in event-loop context — ``time.sleep``,
  ``urllib``/``requests`` I/O, untimed ``Lock.acquire()``, blocking
  ``queue.Queue.get/put``, ``Event``/``Condition.wait``, blocking
  socket ops (``sendall``/``connect``/``create_connection``), and torch
  host reads (``torch.cuda.synchronize``, an event's or stream's
  ``synchronize()``, ``.item()``/``.cpu()``/``.tolist()``/``.numpy()`` of
  a torch expression, ``to_host``) reachable from loop-context seeds. Seeds: methods of the reactor
  classes (``EventLoop``/``HttpConnection``/``EventLoopHttpServer``),
  anything scheduled via ``call_soon``/``call_later``/``register``, and
  the handler passed to an ``EventLoopHttpServer(...)`` constructor.
  Thread hand-offs (``Thread(target=...)``, pool ``submit``) break
  reachability — work queued to another thread is off the loop.
- ``THRD001`` daemon thread without a shutdown path — a class that
  starts a daemon thread but contains no stop ``threading.Event()``, no
  queue ``put(None)`` sentinel, and no timer ``.cancel()``.
- ``CONC001`` blocking call while holding a lock — the same blocking
  set as LOOP001 executed inside a lock region (serializes unrelated
  callers behind slow I/O; the PR that added this check fixed
  ``SpoolWriter.finish`` doing network I/O under its finish lock).

Static analysis over dynamic dispatch is necessarily approximate: call
edges resolve ``self.m()`` within the class, bare names within the
module, ``Class.m()`` by class name, and otherwise by method name only
when that name is defined exactly once in the scanned tree. Violations
ride the shared harness — ``# lint: ignore[RULE]`` line suppressions
and the checked-in ``baseline.json`` (every baselined entry carries a
written justification in its ``notes``). The dynamic complement is
``lockdep.py``: a runtime lock-order validator armed under
``TT_LOCKDEP=1`` that catches what static resolution cannot see.
"""

from __future__ import annotations

import ast
import dataclasses
import re
import sys
from pathlib import Path
from typing import Iterable, Optional

from trino_tpu_torch.lint.jit_safety import (
    REPO_ROOT,
    Violation,
    _rel,
    node_span,
    parse_file,
    tensor_reads,
)

RULES = {
    "CONC000": "unparseable module",
    "CONC001": "blocking call while holding a lock serializes unrelated "
    "callers behind slow work; move it outside the lock region",
    "LOCK001": "lock-order inversion: the same two locks are acquired in "
    "both orders, a potential deadlock",
    "LOCK002": "callback/listener fired while a lock is held; snapshot "
    "under the lock, fire after release",
    "LOOP001": "blocking call reachable from event-loop context; the loop "
    "thread must never block",
    "THRD001": "daemon thread started without a shutdown sentinel or stop "
    "event in the enclosing class",
}

# reactor classes whose methods run on (or marshal onto) the loop thread
_LOOP_CLASSES = frozenset({"EventLoop", "HttpConnection", "EventLoopHttpServer"})

# attribute names whose invocation means "user-supplied callback fires"
_CALLBACK_ATTRS = frozenset({"callback", "respond"})
_CALLBACK_NAME_RE = re.compile(
    r"^(cb|fn|callback|listener|handler)$|(_cb|_callback|_listener|_fn|_hook)$"
)
# receivers that look like a queue.Queue for the get/put blocking checks
_QUEUE_NAME_RE = re.compile(r"(^|_)(q|queue)s?$", re.IGNORECASE)
# lock-ish context managers: with self._lock: / with entry["lock"]:
_LOCKISH_RE = re.compile(r"lock|mutex|cond", re.IGNORECASE)

# blocking device-to-host reads: the port's Batch.to_host, and a wait
# for the card (``torch.cuda.synchronize``, ``event.synchronize()``,
# ``stream.synchronize()``); a tensor's ``.item()``/``.cpu()``/
# ``.tolist()``/``.numpy()`` are found by the jit lint's torch tracking
_TORCH_READS = frozenset({"to_host", "synchronize"})
_SOCKET_BLOCKING = frozenset({"sendall", "create_connection", "getaddrinfo"})


@dataclasses.dataclass
class _Event:
    """A point of interest inside one function body."""

    lineno: int
    label: str
    held: tuple[str, ...]  # lock ids held at this point


@dataclasses.dataclass
class _CallSite:
    targets: tuple[str, ...]  # symbolic resolution candidates (L:/M:/C:/U:)
    label: str  # rendered callee, for report paths
    lineno: int
    held: tuple[str, ...]


@dataclasses.dataclass
class _FnInfo:
    path: str
    qualname: str
    lineno: int
    acquires: list[_Event] = dataclasses.field(default_factory=list)
    pairs: list[tuple[str, str, int]] = dataclasses.field(default_factory=list)
    calls: list[_CallSite] = dataclasses.field(default_factory=list)
    fires: list[_Event] = dataclasses.field(default_factory=list)
    blocking: list[_Event] = dataclasses.field(default_factory=list)
    daemon_threads: list[int] = dataclasses.field(default_factory=list)
    cls: Optional[str] = None

    @property
    def key(self) -> str:
        return f"{self.path}::{self.qualname}"


@dataclasses.dataclass
class _Module:
    path: str
    lines: list[str]
    fns: dict[str, _FnInfo]  # qualname -> info
    classes: set[str]
    # classes with a shutdown mechanism: Event() attr, put(None) sentinel,
    # or timer .cancel() anywhere in the class body
    shutdown_ok: set[str]
    seeds: set[str]  # symbolic targets scheduled onto the loop


def _attr_path(node: ast.expr) -> Optional[str]:
    """Dotted path of an attribute chain rooted at a Name ('self._lock')."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last_name(node: ast.expr) -> Optional[str]:
    """Trailing identifier of a receiver expression, for name heuristics."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _is_const(node: Optional[ast.expr], value) -> bool:
    return isinstance(node, ast.Constant) and node.value is value


class _Visitor(ast.NodeVisitor):
    """Phase 1: per-module collection of function summaries and seeds."""

    def __init__(self, path: str, lines: list[str],
                 reads: Optional[dict[tuple[int, int, int, int], str]] = None):
        self.path = path
        self.lines = lines
        self.reads = reads or {}  # node_span -> tensor read
        self.class_stack: list[str] = []
        self.fn_stack: list[_FnInfo] = []
        self.name_stack: list[str] = []
        # lock ids held at the current point, per function scope (a nested
        # def's body does NOT run under the enclosing with-block)
        self.held_stack: list[list[str]] = []
        self.fns: dict[str, _FnInfo] = {}
        self.classes: set[str] = set()
        self.shutdown_ok: set[str] = set()
        self.seeds: set[str] = set()

    # --- identity helpers -------------------------------------------------

    def _cls(self) -> Optional[str]:
        return self.class_stack[-1] if self.class_stack else None

    def _fn(self) -> Optional[_FnInfo]:
        return self.fn_stack[-1] if self.fn_stack else None

    def _held(self) -> tuple[str, ...]:
        return tuple(self.held_stack[-1]) if self.held_stack else ()

    def _lock_id(self, expr: ast.expr) -> Optional[str]:
        """Stable identity for a lock expression, by attribute path."""
        try:
            text = ast.unparse(expr)
        except Exception:  # pragma: no cover - defensive
            return None
        if not _LOCKISH_RE.search(text):
            return None
        path = _attr_path(expr)
        cls = self._cls()
        if path is not None and path.startswith("self.") and cls:
            return f"{cls}.{path[5:]}"
        if path is not None and "." not in path:
            # bare local/param lock: scope it to the enclosing function
            fn = self._fn()
            scope = fn.qualname if fn else "<module>"
            return f"{self.path}::{scope}.{path}"
        return path or f"{self.path}::<expr>{text}"

    def _callee_targets(self, fn_expr: ast.expr) -> tuple[tuple[str, ...], str]:
        """Symbolic resolution candidates for a call/scheduled target."""
        if isinstance(fn_expr, ast.Lambda):
            # dig one level: call_later(d, lambda: self._poll(x))
            body = fn_expr.body
            if isinstance(body, ast.Call):
                return self._callee_targets(body.func)
            return (), "<lambda>"
        if isinstance(fn_expr, ast.Name):
            return (f"M:{fn_expr.id}",), fn_expr.id
        if isinstance(fn_expr, ast.Attribute):
            recv = fn_expr.value
            m = fn_expr.attr
            if isinstance(recv, ast.Name):
                if recv.id == "self" and self._cls():
                    return (f"L:{self._cls()}.{m}", f"U:{m}"), f"self.{m}"
                if recv.id == "cls" and self._cls():
                    return (f"L:{self._cls()}.{m}", f"U:{m}"), f"cls.{m}"
                # Class.m() or module.m() — try class-method then unique
                return (f"C:{recv.id}.{m}", f"U:{m}"), f"{recv.id}.{m}"
            # obj.attr.m(): unique-method fallback only
            return (f"U:{m}",), f"…{m}"
        return (), "<dynamic>"

    # --- scope tracking ---------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        self.classes.add(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_fn(self, node) -> None:
        self.name_stack.append(node.name)
        # qualname = Class.outer.inner / outer.inner / name
        qual = ".".join(
            ([self.class_stack[-1]] if self.class_stack else [])
            + self.name_stack
        )
        info = _FnInfo(self.path, qual, node.lineno, cls=self._cls())
        self.fns[qual] = info
        self.fn_stack.append(info)
        self.held_stack.append([])  # fresh: body doesn't run under caller's locks
        for stmt in node.body:
            self.visit(stmt)
        self.held_stack.pop()
        self.fn_stack.pop()
        self.name_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # a lambda body runs later, not under the current lock scope; its
        # events are out of scope for this static pass
        return

    def visit_With(self, node: ast.With) -> None:
        fn = self._fn()
        ids: list[str] = []
        for item in node.items:
            expr = item.context_expr
            # `with self._lock:` — a bare lock/condition context manager
            if isinstance(expr, (ast.Attribute, ast.Name, ast.Subscript)):
                lock_id = self._lock_id(expr)
                if lock_id is not None:
                    ids.append(lock_id)
            else:
                self.visit(expr)
        held = self.held_stack[-1] if self.held_stack else []
        if fn is not None:
            for lock_id in ids:
                for outer in held:
                    if outer != lock_id:
                        fn.pairs.append((outer, lock_id, node.lineno))
                fn.acquires.append(_Event(node.lineno, lock_id, tuple(held)))
        held.extend(ids)
        for stmt in node.body:
            self.visit(stmt)
        for lock_id in reversed(ids):
            for i in range(len(held) - 1, -1, -1):
                if held[i] == lock_id:
                    del held[i]
                    break

    def visit_Assign(self, node: ast.Assign) -> None:
        # `t.daemon = True` marks the thread daemon post-construction
        for t in node.targets:
            if (
                isinstance(t, ast.Attribute)
                and t.attr == "daemon"
                and _is_const(node.value, True)
            ):
                fn = self._fn()
                if fn is not None:
                    fn.daemon_threads.append(node.lineno)
        self.generic_visit(node)

    # --- calls ------------------------------------------------------------

    def _record_blocking(self, node: ast.Call, label: str) -> None:
        fn = self._fn()
        if fn is not None:
            fn.blocking.append(_Event(node.lineno, label, self._held()))

    def _maybe_schedule_seed(self, node: ast.Call, attr: str) -> None:
        """Targets of call_soon/call_later/register become loop seeds."""
        idx = {"call_soon": 0, "call_later": 1, "register": 2}.get(attr)
        if idx is None or len(node.args) <= idx:
            return
        targets, _ = self._callee_targets(node.args[idx])
        self.seeds.update(targets)

    def visit_Call(self, node: ast.Call) -> None:  # noqa: C901 — rule dispatch
        fn_info = self._fn()
        fn = node.func
        attr = fn.attr if isinstance(fn, ast.Attribute) else None
        name = fn.id if isinstance(fn, ast.Name) else None
        recv = fn.value if isinstance(fn, ast.Attribute) else None
        recv_name = _last_name(recv) if recv is not None else None
        held = self._held()
        dotted = _attr_path(fn) or ""

        # --- loop seeds and shutdown markers (module/class level facts)
        if attr in ("call_soon", "call_later", "register"):
            self._maybe_schedule_seed(node, attr)
        if name == "EventLoopHttpServer" or attr == "EventLoopHttpServer":
            for a in node.args:
                targets, _ = self._callee_targets(a)
                self.seeds.update(targets)
        cls = self._cls()
        if cls:
            # shutdown mechanisms: a stop Event, a queue None-sentinel, a
            # timer cancel, or joining the thread (bounded hand-off)
            if (name == "Event" or attr == "Event") and not node.args:
                self.shutdown_ok.add(cls)
            if attr in ("put", "put_nowait") and node.args and _is_const(
                node.args[0], None
            ):
                self.shutdown_ok.add(cls)
            if attr == "cancel" and not node.args:
                self.shutdown_ok.add(cls)
            # thread join (possibly deadline-bounded) — receiver must look
            # like a thread, so str.join/os.path.join don't count
            if (
                attr == "join"
                and len(node.args) <= 1
                and recv_name is not None
                and re.search(r"^t$|thread|_t$|worker", recv_name)
            ):
                self.shutdown_ok.add(cls)

        # --- THRD001: daemon thread construction
        if (name == "Thread" or attr in ("Thread", "Timer")) and _is_const(
            _kw(node, "daemon"), True
        ):
            if fn_info is not None:
                fn_info.daemon_threads.append(node.lineno)

        # --- explicit acquire()/release() regions
        if attr == "acquire" and recv is not None:
            lock_id = self._lock_id(recv)
            if lock_id is not None and fn_info is not None:
                nonblocking = _is_const(_kw(node, "blocking"), False) or (
                    node.args and _is_const(node.args[0], False)
                )
                timed = _kw(node, "timeout") is not None or len(node.args) >= 2
                for outer in held:
                    if outer != lock_id:
                        fn_info.pairs.append((outer, lock_id, node.lineno))
                fn_info.acquires.append(_Event(node.lineno, lock_id, held))
                if not nonblocking and not timed:
                    self._record_blocking(node, "untimed Lock.acquire()")
                if not nonblocking:
                    self.held_stack[-1].append(lock_id)
        elif attr == "release" and recv is not None:
            lock_id = self._lock_id(recv)
            if lock_id is not None and self.held_stack and lock_id in self.held_stack[-1]:
                self.held_stack[-1].remove(lock_id)

        # --- blocking-op catalogue (LOOP001 / CONC001 inputs)
        if dotted.endswith("time.sleep") or dotted == "sleep":
            self._record_blocking(node, "time.sleep")
        elif attr == "urlopen" or dotted.endswith("urllib.request.urlopen"):
            self._record_blocking(node, "urllib urlopen")
        elif dotted.startswith("requests.") and attr in (
            "get", "post", "put", "delete", "request", "head",
        ):
            self._record_blocking(node, f"requests.{attr}")
        elif attr in _SOCKET_BLOCKING:
            self._record_blocking(node, f"socket {attr}")
        elif attr == "connect" and recv_name and "sock" in recv_name.lower():
            self._record_blocking(node, "socket connect")
        elif attr in _TORCH_READS or name in _TORCH_READS:
            self._record_blocking(node, f"torch host read ({attr or name})")
        elif node_span(node) in self.reads:
            self._record_blocking(node, f"torch host read ({self.reads[node_span(node)]})")
        elif attr == "wait" and recv is not None:
            # Event.wait blocks the calling thread. Condition.wait is the
            # one legitimate wait-under-lock (it releases the lock), so a
            # lockish receiver (self._cond, self._lock-as-Condition) is
            # exempt; a constant-zero timeout is a non-blocking poll.
            arg = node.args[0] if node.args else _kw(node, "timeout")
            zero = isinstance(arg, ast.Constant) and arg.value in (0, 0.0)
            lockish = recv_name is not None and _LOCKISH_RE.search(recv_name)
            if not zero and not lockish:
                self._record_blocking(node, f"{recv_name or '?'}.wait")
        elif (
            attr in ("get", "put")
            and recv_name is not None
            and _QUEUE_NAME_RE.search(recv_name)
        ):
            if attr == "get":
                # Queue.get() / get(True) / get(timeout=...) block; a
                # non-bool first positional is dict-style get(key, default)
                blocking = (
                    not node.args or _is_const(node.args[0], True)
                ) and not _is_const(_kw(node, "block"), False)
            else:
                blocking = not (
                    _is_const(_kw(node, "block"), False)
                    or (len(node.args) > 1 and _is_const(node.args[1], False))
                )
            if blocking:
                self._record_blocking(
                    node, f"Queue.{attr} without block=False"
                )

        # --- LOCK002 inputs: callback fires
        fired = None
        if attr in _CALLBACK_ATTRS:
            fired = f"{recv_name or '?'}.{attr}()"
        elif name is not None and _CALLBACK_NAME_RE.search(name):
            fired = f"{name}()"
        if fired is not None and fn_info is not None:
            fn_info.fires.append(_Event(node.lineno, fired, held))

        # --- call-graph edge (skip pure hand-offs: Thread targets and
        # scheduled callbacks run on another thread / later on the loop)
        if fn_info is not None and attr not in (
            "call_soon", "call_later", "register",
        ) and name != "Thread" and attr != "Thread":
            targets, label = self._callee_targets(fn)
            if targets:
                fn_info.calls.append(
                    _CallSite(targets, label, node.lineno, held)
                )
        # visit the receiver chain (nested calls like get_registry().x())
        # and argument expressions; Lambda bodies stay skipped (deferred)
        if isinstance(fn, ast.Attribute):
            self.visit(fn.value)
        for a in node.args:
            self.visit(a)
        for k in node.keywords:
            self.visit(k.value)


def scan_file(path: Path) -> _Module | Violation:
    try:
        source, tree = parse_file(path)
    except (SyntaxError, UnicodeDecodeError, OSError) as e:
        return Violation(_rel(path), "CONC000", "<module>", 0, f"unparseable: {e}")
    v = _Visitor(_rel(path), source.splitlines(), tensor_reads(path))
    v.visit(tree)
    return _Module(
        path=v.path,
        lines=v.lines,
        fns=v.fns,
        classes=v.classes,
        shutdown_ok=v.shutdown_ok,
        seeds=v.seeds,
    )


# === phase 2: whole-package analysis ========================================


class _Index:
    """Resolves symbolic call targets against every scanned module."""

    def __init__(self, modules: list[_Module]):
        self.modules = modules
        self.by_key: dict[str, _FnInfo] = {}
        self.by_qual: dict[str, list[_FnInfo]] = {}
        self.by_method: dict[str, list[_FnInfo]] = {}
        self.classes: set[str] = set()
        self._resolved: dict[tuple[str, tuple[str, ...]], list[_FnInfo]] = {}
        for m in modules:
            self.classes |= m.classes
            for info in m.fns.values():
                self.by_key[info.key] = info
                self.by_qual.setdefault(info.qualname, []).append(info)
                tail = info.qualname.rsplit(".", 1)[-1]
                self.by_method.setdefault(tail, []).append(info)

    def resolve(self, site_path: str, target: str) -> list[_FnInfo]:
        kind, _, rest = target.partition(":")
        if kind == "L":  # same-file Class.method
            info = self.by_key.get(f"{site_path}::{rest}")
            if info is not None:
                return [info]
            # fall through to unique-method via the U: candidate
            return []
        if kind == "M":  # same-file function (incl. nested closures)
            out = [
                i
                for i in self.by_qual.get(rest, [])
                if i.path == site_path
            ]
            if out:
                return out
            return [
                i
                for m in self.modules
                if m.path == site_path
                for i in m.fns.values()
                if i.qualname.endswith(f".{rest}")
            ]
        if kind == "C":  # Class.method anywhere, when the class is known
            cls = rest.split(".", 1)[0]
            if cls in self.classes:
                return self.by_qual.get(rest, [])
            return []
        if kind == "U":  # unique method name anywhere
            infos = [
                i for i in self.by_method.get(rest, []) if i.cls is not None
            ]
            return infos if len(infos) == 1 else []
        return []

    def resolve_site(self, site_path: str, targets: tuple[str, ...]) -> list[_FnInfo]:
        key = (site_path, targets)
        hit = self._resolved.get(key)
        if hit is not None:
            return hit
        out: list[_FnInfo] = []
        for t in targets:
            out = self.resolve(site_path, t)
            if out:
                break
        # the fixpoint and the rules resolve every site many times
        self._resolved[key] = out
        return out


@dataclasses.dataclass
class _Closure:
    """Transitive facts about a function: everything its call tree does."""

    locks: dict[str, tuple[str, int, str]]  # lock_id -> (path, lineno, via)
    fires: dict[str, tuple[str, int, str]]  # label -> (path, lineno, via)
    blocking: dict[str, tuple[str, int, str]]  # label -> (path, lineno, via)


def _closures(index: _Index) -> dict[str, _Closure]:
    """Fixpoint of per-function transitive lock/fire/blocking facts."""
    out: dict[str, _Closure] = {
        k: _Closure(
            locks={
                e.label: (f.path, e.lineno, f.qualname)
                for e in f.acquires
            },
            fires={
                e.label: (f.path, e.lineno, f.qualname) for e in f.fires
            },
            blocking={
                e.label: (f.path, e.lineno, f.qualname)
                for e in f.blocking
            },
        )
        for k, f in index.by_key.items()
    }
    changed = True
    while changed:
        changed = False
        for key, info in index.by_key.items():
            mine = out[key]
            for site in info.calls:
                for callee in index.resolve_site(info.path, site.targets):
                    theirs = out[callee.key]
                    for field in ("locks", "fires", "blocking"):
                        src: dict = getattr(theirs, field)
                        dst: dict = getattr(mine, field)
                        for label, wit in src.items():
                            if label not in dst:
                                dst[label] = wit
                                changed = True
    return out


def _suppressed(module: _Module, lineno: int, rule: str) -> bool:
    if 1 <= lineno <= len(module.lines):
        line = module.lines[lineno - 1]
        return f"lint: ignore[{rule}]" in line or "lint: ignore-all" in line
    return False


def _loop_reachable(index: _Index, modules: list[_Module]) -> dict[str, str]:
    """fn key -> human-readable seed chain, BFS over resolved call edges."""
    from collections import deque

    reached: dict[str, str] = {}
    queue: deque[str] = deque()

    def seed(info: _FnInfo, why: str) -> None:
        if info.key not in reached:
            reached[info.key] = why
            queue.append(info.key)

    for m in modules:
        for info in m.fns.values():
            if info.cls in _LOOP_CLASSES:
                seed(info, f"loop class {info.cls}")
        for target in m.seeds:
            for info in index.resolve(m.path, target):
                seed(info, "scheduled on loop")
    while queue:
        key = queue.popleft()
        info = index.by_key[key]
        for site in info.calls:
            for callee in index.resolve_site(info.path, site.targets):
                if callee.key not in reached:
                    reached[callee.key] = f"{reached[key]} → {info.qualname}"
                    queue.append(callee.key)
    return reached


def analyze(modules: list[_Module]) -> list[Violation]:
    index = _Index(modules)
    closures = _closures(index)
    reached = _loop_reachable(index, modules)
    by_path = {m.path: m for m in modules}
    out: list[Violation] = []

    def flag(
        info: _FnInfo, lineno: int, rule: str, detail: str
    ) -> None:
        module = by_path[info.path]
        if _suppressed(module, lineno, rule):
            return
        out.append(
            Violation(
                info.path, rule, info.qualname, lineno,
                RULES[rule] + (f" ({detail})" if detail else ""),
            )
        )

    # --- LOCK001: collect ordered pairs (intra-fn + via call graph) -------
    pairs: dict[tuple[str, str], tuple[_FnInfo, int, str]] = {}
    for info in index.by_key.values():
        for outer, inner, lineno in info.pairs:
            pairs.setdefault((outer, inner), (info, lineno, "direct"))
        for site in info.calls:
            if not site.held:
                continue
            for callee in index.resolve_site(info.path, site.targets):
                for lock_id, wit in closures[callee.key].locks.items():
                    for outer in site.held:
                        if outer != lock_id:
                            pairs.setdefault(
                                (outer, lock_id),
                                (info, site.lineno, f"via {site.label}"),
                            )
    for (a, b), (info, lineno, how) in sorted(
        pairs.items(), key=lambda kv: (kv[1][0].path, kv[1][1])
    ):
        if (b, a) in pairs and a < b:  # report each inverted pair once
            other = pairs[(b, a)]
            flag(
                info, lineno, "LOCK001",
                f"{b} acquired under {a} here [{how}]; inverse order at "
                f"{other[0].path}:{other[1]}",
            )
            flag(
                other[0], other[1], "LOCK001",
                f"{a} acquired under {b} here [{other[2]}]; inverse order "
                f"at {info.path}:{lineno}",
            )

    # --- LOCK002 / CONC001: events under a held lock ----------------------
    for info in index.by_key.values():
        for e in info.fires:
            if e.held:
                flag(
                    info, e.lineno, "LOCK002",
                    f"{e.label} under {e.held[-1]}",
                )
        for e in info.blocking:
            if e.held:
                flag(
                    info, e.lineno, "CONC001",
                    f"{e.label} under {e.held[-1]}",
                )
        for site in info.calls:
            if not site.held:
                continue
            for callee in index.resolve_site(info.path, site.targets):
                cl = closures[callee.key]
                for label, (_, _, via) in cl.fires.items():
                    flag(
                        info, site.lineno, "LOCK002",
                        f"{site.label}() fires {label} in {via} under "
                        f"{site.held[-1]}",
                    )
                for label, (_, _, via) in cl.blocking.items():
                    flag(
                        info, site.lineno, "CONC001",
                        f"{site.label}() blocks on {label} in {via} under "
                        f"{site.held[-1]}",
                    )

    # --- LOOP001: blocking ops in loop-reachable functions ----------------
    for key, why in reached.items():
        info = index.by_key[key]
        for e in info.blocking:
            flag(
                info, e.lineno, "LOOP001",
                f"{e.label}; loop context: {why}",
            )

    # --- THRD001: daemon threads without a class shutdown path ------------
    shutdown_ok: set[str] = set()
    for m in modules:
        shutdown_ok |= m.shutdown_ok
    for info in index.by_key.values():
        if info.cls is None or info.cls in shutdown_ok:
            continue
        for lineno in info.daemon_threads:
            flag(
                info, lineno, "THRD001",
                f"class {info.cls} has no stop Event/sentinel/cancel",
            )

    return sorted(out, key=lambda v: (v.path, v.lineno, v.rule))


def lint_paths(paths: Iterable[str | Path]) -> list[Violation]:
    modules: list[_Module] = []
    errors: list[Violation] = []
    for p in paths:
        p = Path(p)
        if not p.is_absolute() and not p.exists():
            p = REPO_ROOT / p
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            scanned = scan_file(f)
            if isinstance(scanned, Violation):
                errors.append(scanned)
            else:
                modules.append(scanned)
    return sorted(
        errors + analyze(modules), key=lambda v: (v.path, v.lineno, v.rule)
    )


def main(argv: Optional[list[str]] = None) -> int:  # pragma: no cover
    from trino_tpu_torch.lint.cli import main as cli_main

    return cli_main(["--only", "concurrency"] + list(argv or []))


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main(sys.argv[1:]))
