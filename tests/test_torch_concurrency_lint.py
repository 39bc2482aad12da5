"""The port's concurrency static analysis and runtime lockdep
(``trino_tpu_torch/lint``), the cases of ``tests/test_concurrency_lint.py``
on the port's lint, lockdep and server modules.

Malformed-corpus tests prove each static rule fires on a seeded bad
pattern (and stays quiet on the corrected version); lockdep unit tests
exercise the port's runtime validator, installed over the repository's
(``tests/conftest.py``) and uninstalled again — cycle detection, RLock
reentrancy, loop-thread waits, and the factories put back. Parity cases
run the same corpora, and the port's package, through both packages'
``concurrency`` and ``obs`` families.
"""

import textwrap
import threading
import time

import pytest

from trino_tpu_torch.lint import (
    compare_to_baseline,
    lint_all,
    load_baseline,
    lockdep,
    main,
)
from trino_tpu_torch.lint import concurrency, obs_metrics


def _lint_source(tmp_path, source: str, name: str = "seeded.py"):
    mod = tmp_path / name
    mod.write_text(textwrap.dedent(source))
    return concurrency.lint_paths([mod])


def _rules(violations):
    return {v.rule for v in violations}


# === whole-package gate =====================================================


def test_repo_is_clean_against_baseline():
    """CI gate, all families: new violations only."""
    violations = lint_all(["trino_tpu_torch"])
    new, _stale = compare_to_baseline(violations, load_baseline())
    assert not new, "new lint violations:\n" + "\n".join(
        v.render() for v in new
    )


def test_cli_only_and_stats(tmp_path, capsys):
    assert main(["--only", "concurrency", "trino_tpu_torch"]) == 0
    capsys.readouterr()
    assert main(["--only", "concurrency", "--stats", "--no-baseline",
                 "trino_tpu_torch"]) != 0
    out = capsys.readouterr().out
    assert "total:" in out


# === LOCK001: lock-order inversion ==========================================


def test_lock_order_inversion_fires(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import threading

        class S:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()

            def forward(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            def backward(self):
                with self._b_lock:
                    with self._a_lock:
                        pass
        """,
    )
    assert "LOCK001" in _rules(vs)


def test_lock_order_inversion_via_call_graph(tmp_path):
    """Holding A and calling a function that takes B counts as A->B."""
    vs = _lint_source(
        tmp_path,
        """
        import threading

        class S:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()

            def inner_b(self):
                with self._b_lock:
                    pass

            def forward(self):
                with self._a_lock:
                    self.inner_b()

            def backward(self):
                with self._b_lock:
                    with self._a_lock:
                        pass
        """,
    )
    assert "LOCK001" in _rules(vs)


def test_consistent_lock_order_is_clean(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import threading

        class S:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()

            def one(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            def two(self):
                with self._a_lock:
                    with self._b_lock:
                        pass
        """,
    )
    assert "LOCK001" not in _rules(vs)


# === LOCK002: callback fired under a lock ===================================


def test_callback_under_lock_fires(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._listeners = []

            def fire(self, event):
                with self._lock:
                    for cb in self._listeners:
                        cb(event)
        """,
    )
    assert "LOCK002" in _rules(vs)


def test_snapshot_then_fire_is_clean(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._listeners = []

            def fire(self, event):
                with self._lock:
                    snapshot = list(self._listeners)
                for cb in snapshot:
                    cb(event)
        """,
    )
    assert "LOCK002" not in _rules(vs)


# === CONC001: blocking call under a lock ====================================


def test_blocking_under_lock_fires(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import threading
        import time

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def slow(self):
                with self._lock:
                    time.sleep(1.0)
        """,
    )
    assert "CONC001" in _rules(vs)


# === LOOP001: blocking call reachable from the event loop ==================


def test_sleep_in_loop_callback_fires(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import time

        class Handler:
            def __init__(self, loop):
                self.loop = loop

            def kick(self):
                self.loop.call_soon(self.on_tick)

            def on_tick(self):
                time.sleep(0.5)
        """,
    )
    loop_vs = [v for v in vs if v.rule == "LOOP001"]
    assert loop_vs, [v.render() for v in vs]
    # the message carries the reachability chain, not just the site
    assert "scheduled on loop" in loop_vs[0].message


def test_thread_handoff_breaks_loop_reachability(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import threading
        import time

        class Handler:
            def __init__(self, loop):
                self.loop = loop

            def kick(self):
                self.loop.call_soon(self.on_tick)

            def on_tick(self):
                threading.Thread(target=self.blocking_work, daemon=True).start()

            def blocking_work(self):
                time.sleep(0.5)
        """,
    )
    assert "LOOP001" not in _rules(vs)


# === THRD001: daemon thread without shutdown path ===========================


def test_sentinelless_daemon_thread_fires(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import threading
        import time

        class S:
            def start(self):
                t = threading.Thread(target=self._run, daemon=True)
                t.start()

            def _run(self):
                while True:
                    time.sleep(1)
        """,
    )
    assert "THRD001" in _rules(vs)


def test_daemon_thread_with_stop_event_is_clean(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import threading

        class S:
            def __init__(self):
                self._stop = threading.Event()

            def start(self):
                t = threading.Thread(target=self._run, daemon=True)
                t.start()

            def _run(self):
                while not self._stop.is_set():
                    self._stop.wait(1)

            def stop(self):
                self._stop.set()
        """,
    )
    assert "THRD001" not in _rules(vs)


# === inline suppression =====================================================


def test_inline_ignore_suppresses(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import threading
        import time

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def slow(self):
                with self._lock:
                    time.sleep(1.0)  # lint: ignore[CONC001]
        """,
    )
    assert "CONC001" not in _rules(vs)


# === lockdep: runtime validator =============================================


@pytest.fixture
def armed_lockdep():
    was_installed = lockdep.installed()
    if not was_installed:
        lockdep.install()
    lockdep.reset()
    yield lockdep
    lockdep.reset()
    if not was_installed:
        lockdep.uninstall()


def test_lockdep_off_is_zero_overhead():
    """Not installed, the port's lockdep leaves the factories alone (the
    repository's validator may hold them) and keeps the interpreter's own
    as its real ones."""
    import _thread

    assert not lockdep.installed()
    assert threading.Lock is not lockdep._tracked_lock
    assert threading.RLock is not lockdep._tracked_rlock
    assert lockdep._REAL_LOCK is _thread.allocate_lock
    assert lockdep._REAL_RLOCK().__class__.__module__ in ("_thread", "threading")


def test_lockdep_detects_inversion(armed_lockdep):
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass

    def backward():
        with b:
            with a:
                pass

    t = threading.Thread(target=backward)
    t.start()
    t.join()
    rep = armed_lockdep.report()
    cycles = [r for r in rep if "lock-order cycle" in r]
    assert cycles, rep
    # report names both edges with acquisition context
    assert "edge" in cycles[0] and "inner acquired at" in cycles[0]
    armed_lockdep.reset()
    assert armed_lockdep.report() == []


def test_lockdep_consistent_order_is_clean(armed_lockdep):
    a = threading.Lock()
    b = threading.Lock()
    for _ in range(3):
        with a:
            with b:
                pass
    assert armed_lockdep.report() == []


def test_lockdep_rlock_reentrancy_exempt(armed_lockdep):
    r = threading.RLock()
    with r:
        with r:
            with r:
                pass
    assert armed_lockdep.report() == []


def test_lockdep_loop_thread_wait_detected(armed_lockdep):
    lock = threading.Lock()
    held = threading.Event()
    release = threading.Event()

    def holder():
        with lock:
            held.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5)
    armed_lockdep.register_loop_thread(threading.get_ident())
    try:
        timer = threading.Timer(0.2, release.set)
        timer.start()
        with lock:  # blocks past the grace window -> recorded
            pass
        timer.join()
    finally:
        armed_lockdep.unregister_loop_thread(threading.get_ident())
    t.join()
    rep = armed_lockdep.report()
    waits = [r for r in rep if "event-loop thread blocked" in r]
    assert waits, rep
    assert "loop thread waiting at" in waits[0]


def test_lockdep_non_loop_wait_not_flagged(armed_lockdep):
    lock = threading.Lock()
    held = threading.Event()
    release = threading.Event()

    def holder():
        with lock:
            held.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5)
    timer = threading.Timer(0.2, release.set)
    timer.start()
    with lock:
        pass
    timer.join()
    t.join()
    assert armed_lockdep.report() == []


def test_lockdep_condition_and_queue_interop(armed_lockdep):
    import queue

    q = queue.Queue()
    q.put(1)
    assert q.get() == 1
    cond = threading.Condition()
    with cond:
        cond.notify_all()
    rcond = threading.Condition(threading.RLock())
    with rcond:
        rcond.notify_all()
    evt = threading.Event()
    evt.set()
    assert evt.wait(1)


# === regression tests for findings fixed in this PR =========================


def test_spool_finish_does_not_hold_lock_while_blocking(monkeypatch):
    """SpoolWriter.finish used to hold _finish_lock across the drain wait
    and the manifest PUT; now the lock only claims the attempt."""
    from trino_tpu_torch.exchange.spool import SpoolWriter

    w = SpoolWriter.__new__(SpoolWriter)
    w._finish_lock = threading.Lock()
    w._finishing = False
    w._finish_wave = threading.Event()
    w.completed = False
    w._aborted = False
    w.failed = False
    w.uri = "http://spool.invalid/q"
    w.query_id = "q"
    w._counts = {}

    import queue as _q

    w._q = _q.Queue()
    w._drained = threading.Event()

    in_request = threading.Event()
    unblock = threading.Event()

    def slow_request(*a, **k):
        in_request.set()
        unblock.wait(5)
        return {"complete": True}

    w._request = slow_request
    w._drained.set()

    t = threading.Thread(target=lambda: w.finish(timeout=5))
    t.start()
    assert in_request.wait(5)
    # mid-finish: the claim lock must be free (network I/O is outside it)
    assert w._finish_lock.acquire(blocking=False)
    w._finish_lock.release()
    unblock.set()
    t.join(5)
    assert not t.is_alive()
    assert w.completed


def test_announce_thread_stops_promptly():
    """TrinoTpuServer._announce_loop waits on a stop event, not a bare
    sleep, so stop() no longer leaves it parked for a full period."""
    from trino_tpu_torch.server.http import TrinoTpuServer

    srv = TrinoTpuServer.__new__(TrinoTpuServer)
    srv.state = "ACTIVE"
    srv._announce_stop = threading.Event()
    srv.discovery_uri = ""  # no coordinator: loop idles on the 2s wait

    t = threading.Thread(target=srv._announce_loop, daemon=True)
    t.start()
    time.sleep(0.1)
    start = time.monotonic()
    srv.state = "STOPPED"
    srv._announce_stop.set()
    t.join(2)
    assert not t.is_alive(), "announce loop did not exit on stop event"
    # the stop event interrupts the wait; a bare sleep would take ~2s
    assert time.monotonic() - start < 1.0


def test_dispatch_pool_submit_is_nonblocking():
    """_DispatchPool.submit uses put_nowait: safe from the loop thread."""
    import inspect

    from trino_tpu_torch.server.querymanager import _DispatchPool

    src = inspect.getsource(_DispatchPool.submit)
    assert "put_nowait" in src


# === loop-thread assertion helpers ==========================================


def test_assert_not_loop_thread_raises_under_pytest():
    from trino_tpu_torch.server import eventloop

    ident = threading.get_ident()
    eventloop._LOOP_THREAD_IDS.add(ident)
    try:
        with pytest.raises(RuntimeError, match="loop-thread discipline"):
            eventloop.assert_not_loop_thread("test blocking call")
    finally:
        eventloop._LOOP_THREAD_IDS.discard(ident)
    # off the loop thread it is a no-op returning True
    assert eventloop.assert_not_loop_thread("test blocking call")


def test_loop_thread_violation_counts_when_not_strict(monkeypatch):
    from trino_tpu_torch.server import eventloop
    from trino_tpu_torch.obs.metrics import get_registry

    monkeypatch.setenv("TT_LOOP_ASSERTS", "count")
    ident = threading.get_ident()
    eventloop._LOOP_THREAD_IDS.add(ident)
    try:
        counter = get_registry().counter("trino_tpu_loop_thread_violations_total")
        before = counter.value
        assert not eventloop.assert_not_loop_thread("prod-mode check")
        assert counter.value == before + 1
    finally:
        eventloop._LOOP_THREAD_IDS.discard(ident)


# === torch host reads ========================================================


def test_torch_host_reads_block(tmp_path):
    """``.item()`` of a tensor under a lock and ``torch.cuda.synchronize``
    on the loop are blocking host reads; ``.item()`` of a numpy value is
    none."""
    vs = _lint_source(
        tmp_path,
        """
        import threading

        import numpy as np
        import torch

        class S:
            def __init__(self, loop):
                self._lock = threading.Lock()
                self.loop = loop

            def total(self, x: torch.Tensor):
                with self._lock:
                    return x.sum().item()

            def host_total(self, values):
                with self._lock:
                    return np.asarray(values).sum().item()

            def kick(self):
                self.loop.call_soon(self.on_tick)

            def on_tick(self):
                torch.cuda.synchronize()
        """,
    )
    got = {(v.rule, v.func) for v in vs}
    assert got == {("CONC001", "S.total"), ("LOOP001", "S.on_tick")}, got
    assert all("torch host read" in v.message for v in vs)


# === parity with the repository's lint =======================================

# seeded corpora, each through both packages' concurrency and obs families
OBS_CORPORA = {
    "obs_label_fstring": """
        def record(reg, query_id, state):
            reg.counter("trino_tpu_queries_total", state=state).inc()
            reg.counter("trino_tpu_query_rows_total", query=f"q-{query_id}").inc()
            reg.gauge("trino_tpu_query_gauge", qid=query_id).set(1)
        """,
    "obs_dynamic_name": """
        def record(reg, key, val):
            reg.counter(f"trino_tpu_exchange_{key}_total").inc(val)
            reg.histogram("trino_tpu_%s_ms" % key).observe(val)
            reg.counter("trino_tpu_fixed_total", kind="scan").inc()  # clean
        """,
    "obs_suppressed": """
        def record(reg, key):
            reg.counter(f"trino_tpu_{key}_total").inc()  # lint: ignore[OBS002]
        """,
}


def _corpora():
    """The seeded sources of this module's concurrency cases."""
    import ast
    import inspect
    import sys

    tree = ast.parse(inspect.getsource(sys.modules[__name__]))
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "_lint_source"
                    and len(node.args) > 1 and isinstance(node.args[1], ast.Constant)):
                out[fn.name] = node.args[1].value
    return out


def _key(violations):
    return {(v.rule, v.lineno, v.func) for v in violations}


@pytest.mark.parametrize("name", sorted(OBS_CORPORA))
def test_obs_rules_fire_as_the_repositorys(tmp_path, name):
    from trino_tpu.lint import obs_metrics as ref_obs

    mod = tmp_path / "seeded.py"
    mod.write_text(textwrap.dedent(OBS_CORPORA[name]))
    port, ref = obs_metrics.lint_paths([mod]), ref_obs.lint_paths([mod])
    assert _key(port) == _key(ref)
    want = {"obs_label_fstring": {"OBS001"}, "obs_dynamic_name": {"OBS002"},
            "obs_suppressed": set()}[name]
    assert {v.rule for v in port} == want
    if name == "obs_label_fstring":
        assert len(port) == 2  # the f-string and the identity name, not state=


def test_concurrency_corpora_find_what_the_repositorys_finds(tmp_path):
    """Every seeded corpus of this module through both packages'
    concurrency family: the same (rule, line, function) findings."""
    from trino_tpu.lint import concurrency as ref_conc

    corpora = _corpora()
    assert len(corpora) == 12  # 11 cases of the repository's and the torch one
    fired = 0
    for name, source in corpora.items():
        mod = tmp_path / f"{name}.py"
        mod.write_text(textwrap.dedent(source))
        port, ref = concurrency.lint_paths([mod]), ref_conc.lint_paths([mod])
        if name == "test_torch_host_reads_block":
            # the repository's lint knows no torch host read
            assert not ref and len(port) == 2
            continue
        assert _key(port) == _key(ref), name
        assert [v.message for v in port] == [v.message for v in ref], name
        fired += bool(port)
    assert fired >= 7


def test_package_findings_equal_the_repositorys():
    """Over ``trino_tpu_torch`` the obs findings of both packages are
    equal and empty, and the concurrency findings equal but for the
    wording of the host reads: a site the repository's lint reports as a
    jax host pull the port's reports as a torch host read, once for each
    kind of read its callees make."""
    from trino_tpu.lint import concurrency as ref_conc
    from trino_tpu.lint import obs_metrics as ref_obs

    assert obs_metrics.lint_paths(["trino_tpu_torch"]) == []
    assert ref_obs.lint_paths(["trino_tpu_torch"]) == []
    port = concurrency.lint_paths(["trino_tpu_torch"])
    ref = ref_conc.lint_paths(["trino_tpu_torch"])
    assert _key(port) == _key(ref)
    assert len(_key(port)) == 5  # batching CONC001 x3 and LOCK002, THRD001
    ref_msgs = {v.message.replace("jax host pull", "torch host read") for v in ref}
    port_msgs = {v.message for v in port}
    assert ref_msgs <= port_msgs
    assert all("torch host read" in m for m in port_msgs - ref_msgs)


# === lockdep over the repository's =========================================


def test_lockdep_install_over_the_conftests_is_lifo():
    """Installing the port's lockdep over whatever holds the factories
    (the repository's lockdep under tests/conftest.py) and uninstalling
    it puts that back; the port's locks wrap the interpreter's own."""
    import _thread

    from trino_tpu.lint import lockdep as ref_lockdep

    before = (threading.Lock, threading.RLock)
    if ref_lockdep.installed():
        assert threading.Lock is ref_lockdep._tracked_lock
    assert lockdep.install()
    try:
        assert threading.Lock is lockdep._tracked_lock
        lock = threading.Lock()
        assert isinstance(lock, lockdep._TrackedLock)
        assert isinstance(lock._inner, _thread.LockType)
        with lock:
            pass
    finally:
        assert lockdep.uninstall()
    assert (threading.Lock, threading.RLock) == before
    assert not lockdep.uninstall()  # idempotent
    if ref_lockdep.installed():
        assert threading.Lock is ref_lockdep._tracked_lock
        assert isinstance(threading.Lock(), ref_lockdep._TrackedLock)


def test_port_loop_thread_is_registered_with_the_ports_lockdep():
    """The port's event loop registers its thread with the port's lockdep
    while it runs, as the reference's registers with its own."""
    from trino_tpu_torch.server.eventloop import EventLoop

    loop = EventLoop()
    t = threading.Thread(target=loop.run, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 5
        while t.ident not in lockdep._LOOP_THREADS and time.monotonic() < deadline:
            time.sleep(0.01)
        assert t.ident in lockdep._LOOP_THREADS
    finally:
        loop.stop()
        t.join(5)
    assert t.ident not in lockdep._LOOP_THREADS
