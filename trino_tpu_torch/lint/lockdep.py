"""Runtime lock-order validator (lockdep), the dynamic complement to
``concurrency.py``'s static pass.

Armed by a caller with :func:`install` (``chip_smoke.py`` arms it
before it boots the port's coordinator) and read with :func:`report`.
When installed, ``threading.Lock``/``threading.RLock`` construction
returns a tracked wrapper that:

- records the per-thread held-set at every acquire and adds an edge
  ``outer → inner`` to a global lock-order graph, keyed by each lock's
  *creation site* (``file:line``) so all instances born at one site —
  e.g. every ``Counter._lock`` — collapse into one node;
- keeps the acquisition stacks that first witnessed each edge, so a
  cycle report shows *both* nestings with full context (cf. Linux
  lockdep's "possible circular locking dependency" splat);
- detects loop-thread lock *waits*: a blocking acquire on a registered
  event-loop thread that is still unsatisfied after a short grace
  period (50ms — long enough to filter scheduler-level contention on
  short critical sections, short enough to catch locks held across
  I/O or sleeps) is recorded with the waiter's stack and the owner's
  acquisition site.

:func:`report` returns the cycles (potential deadlocks — two locks
taken in both orders on different threads) and loop-thread waits; a
caller fails its run if any exist.

Reentrant acquires of the *same lock object* (RLock) add no edges, and
self-edges between two instances from one creation site are skipped
(indistinguishable from reentrancy at site granularity).

When NOT installed this module costs nothing: ``threading.Lock`` is
whatever it was before (tests assert identity), and the
register/unregister hooks are set-ops on a module-level set.

The real factories are the interpreter's own (``_thread.allocate_lock``
and the C ``RLock``), never whatever ``threading.Lock`` is at import:
another validator may already have replaced it. :func:`uninstall`
restores the factories that :func:`install` replaced, so installing over
another validator and uninstalling again leaves that one in place.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
import traceback
from typing import Any, Optional

_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = threading._CRLock or threading._PyRLock  # type: ignore[attr-defined]

_installed = False
# the (Lock, RLock) factories install() replaced, restored by uninstall()
_replaced: Optional[tuple[Any, Any]] = None
_STATE_LOCK = _REAL_LOCK()  # guards the graph/report state, never tracked

# (outer_site, inner_site) -> (outer_stack, inner_stack) at first witness
_edges: dict[tuple[str, str], tuple[str, str]] = {}
# loop-thread blocking waits: (site, waiter_stack, owner_stack)
_loop_waits: list[tuple[str, str, str]] = []
_LOOP_THREADS: set[int] = set()

_tls = threading.local()

# frames from these files are plumbing, not the interesting creation site
_SKIP_FRAMES = (os.sep + "lockdep.py", os.sep + "threading.py", os.sep + "queue.py")
_OWN_FILE = __file__


_WAIT_GRACE_S = 0.05


def _creation_site() -> str:
    # cheap frame walk (no source-line lookup): lock creation can be hot
    f = sys._getframe(1)
    while f is not None and any(
        s in f.f_code.co_filename for s in _SKIP_FRAMES
    ):
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


def _fmt_site(site) -> str:
    if isinstance(site, tuple):
        return f"{site[0]}:{site[1]}"
    return str(site)


def _stack(limit: int = 12) -> str:
    frames = [
        f
        for f in traceback.extract_stack()[:-2]
        if os.sep + "lockdep.py" not in f.filename
    ]
    return "".join(traceback.format_list(frames[-limit:]))


class _TrackedLock:
    """Wrapper over a real Lock/RLock recording order and wait events."""

    def __init__(self, inner: Any, reentrant: bool) -> None:
        self._inner = inner
        self._reentrant = reentrant
        self._site = _creation_site()
        self._owner_site: Any = "<never acquired>"  # (file, line) per acquire
        self._owner_stack: Optional[str] = None  # full, only when edges form

    # --- bookkeeping ------------------------------------------------------

    def _record_edges(self, held: list) -> None:
        new_edges = []
        for other in held:
            if other is self:
                if self._reentrant:
                    break  # reentrant re-acquire: no new ordering fact
                continue
            if other._site == self._site:
                # site-level self-edge: indistinguishable from reentry
                continue
            key = (other._site, self._site)
            if key not in _edges:
                new_edges.append((key, other))
        if new_edges:
            # full stacks are expensive; capture only when a new
            # ordering fact is actually being recorded
            stack = _stack()
            self._owner_stack = stack
            with _STATE_LOCK:
                for key, other in new_edges:
                    if key not in _edges:
                        outer = other._owner_stack or (
                            f"  (acquired at {_fmt_site(other._owner_site)})\n"
                        )
                        _edges[key] = (outer, stack)

    def _acquire_blocked(self, timeout: float) -> bool:
        """Contended blocking acquire (the try-probe already failed)."""
        if threading.get_ident() in _LOOP_THREADS:
            # grace probe: brief contention on a short critical section
            # is not a discipline violation; a wait that outlives the
            # grace window is
            if 0 <= timeout <= _WAIT_GRACE_S:
                return self._inner.acquire(True, timeout)
            if self._inner.acquire(True, _WAIT_GRACE_S):
                return True
            owner = self._owner_stack or (
                f"  (acquired at {_fmt_site(self._owner_site)})\n"
            )
            with _STATE_LOCK:
                _loop_waits.append((self._site, _stack(), owner))
            rem = -1 if timeout < 0 else max(0.0, timeout - _WAIT_GRACE_S)
            return self._inner.acquire(True, rem)
        return self._inner.acquire(True, timeout)

    # --- Lock protocol ----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(False)
        if not got and blocking:
            got = self._acquire_blocked(timeout)
        if got:
            try:
                held = _tls.held
            except AttributeError:
                held = _tls.held = []
            f = sys._getframe(1)
            if f.f_code.co_filename == _OWN_FILE:  # entered via ``with``
                f = f.f_back or f
            self._owner_site = (f.f_code.co_filename, f.f_lineno)
            self._owner_stack = None  # stale full stack is worse than the site
            if held:
                self._record_edges(held)
            held.append(self)
        return got

    def release(self) -> None:
        self._inner.release()
        try:
            held = _tls.held
        except AttributeError:
            return
        if held and held[-1] is self:
            held.pop()
            return
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                return

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<TrackedLock {self._site} over {self._inner!r}>"

    def __getattr__(self, name: str) -> Any:
        # Condition() integration: delegate _is_owned/_release_save/
        # _acquire_restore/_at_fork_reinit (and anything else) to the
        # real lock. RLock wait/notify semantics stay correct; the held
        # tracking is briefly stale while a Condition.wait parks, which
        # cannot create edges (the parked thread acquires nothing).
        return getattr(self._inner, name)


_only_paths: tuple[str, ...] = ()


def _track_here(site: str) -> bool:
    if not _only_paths:
        return True
    return any(site.startswith(p) for p in _only_paths)


def _tracked_lock():
    lock = _TrackedLock(_REAL_LOCK(), reentrant=False)
    if not _track_here(lock._site):
        return lock._inner  # third-party creation site: hand back the real lock
    return lock


def _tracked_rlock():
    lock = _TrackedLock(_REAL_RLOCK(), reentrant=True)
    if not _track_here(lock._site):
        return lock._inner
    return lock


# === lifecycle ==============================================================


def install(only_paths: tuple[str, ...] = ()) -> bool:
    """Swap threading.Lock/RLock for tracked factories. Idempotent.

    ``only_paths``: when non-empty, only locks whose creation site lives
    under one of these path prefixes are tracked; everything else gets a
    plain lock. Callers pass the repo root so the validator watches the
    runtime's discipline, not torch/stdlib internals.
    """
    global _installed, _only_paths, _replaced
    if _installed:
        return False
    _only_paths = tuple(only_paths)
    _replaced = (threading.Lock, threading.RLock)
    threading.Lock = _tracked_lock  # type: ignore[assignment]
    threading.RLock = _tracked_rlock  # type: ignore[assignment]
    _installed = True
    return True


def uninstall() -> bool:
    """Put back the factories :func:`install` replaced."""
    global _installed, _replaced
    if not _installed:
        return False
    threading.Lock, threading.RLock = _replaced  # type: ignore[assignment,misc]
    _replaced = None
    _installed = False
    return True


def installed() -> bool:
    return _installed


def reset() -> None:
    """Clear recorded state (unit tests)."""
    with _STATE_LOCK:
        _edges.clear()
        _loop_waits.clear()


def register_loop_thread(ident: int) -> None:
    _LOOP_THREADS.add(ident)


def unregister_loop_thread(ident: int) -> None:
    _LOOP_THREADS.discard(ident)


# === reporting ==============================================================


def _find_cycles(edges: dict[tuple[str, str], tuple[str, str]]) -> list[list[str]]:
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles: list[list[str]] = []
    seen_sets: set[frozenset] = set()
    for start in sorted(graph):
        # DFS looking for a path back to `start`
        stack: list[tuple[str, list[str]]] = [(start, [start])]
        visited: set[str] = set()
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen_sets:
                        seen_sets.add(key)
                        cycles.append(path + [start])
                elif nxt not in visited and nxt not in path:
                    visited.add(nxt)
                    stack.append((nxt, path + [nxt]))
    return cycles


def report() -> list[str]:
    """Human-readable problem list: lock-order cycles and loop waits."""
    with _STATE_LOCK:
        edges = dict(_edges)
        waits = list(_loop_waits)
    out: list[str] = []
    for cycle in _find_cycles(edges):
        lines = [
            "lock-order cycle (potential deadlock): "
            + " -> ".join(cycle)
        ]
        for a, b in zip(cycle, cycle[1:]):
            outer_stack, inner_stack = edges.get((a, b), ("", ""))
            lines.append(f"  edge {a} -> {b}")
            if outer_stack:
                lines.append("    outer held at:\n" + _indent(outer_stack, 6))
            lines.append("    inner acquired at:\n" + _indent(inner_stack, 6))
        out.append("\n".join(lines))
    for site, waiter, owner in waits:
        out.append(
            f"event-loop thread blocked acquiring lock created at {site}\n"
            "  loop thread waiting at:\n" + _indent(waiter, 4)
            + "  lock owner acquired at:\n" + _indent(owner, 4)
        )
    return out


def _indent(text: str, n: int) -> str:
    pad = " " * n
    return "".join(
        pad + line + "\n" for line in text.rstrip("\n").splitlines()
    )


def edge_count() -> int:
    with _STATE_LOCK:
        return len(_edges)
