"""Fault-tolerant execution: deterministic injection, retry policies,
failure-detector hygiene, and chaos runs over a real cluster.

Reference tier: Trino's fault-tolerant-execution tests
(``testing/trino-faulttolerant-tests``) — task/query retry under a
``FailureInjector`` must produce bit-identical results; here the
injector is seed-deterministic so every chaos scenario replays exactly.

The reference's ``tests/test_fault_tolerance.py`` run against
trino_tpu_torch (its classes, and its cluster of CPU processes), with the
port's own cases at the end: the injector's draws and the retry classes
equal the reference's, a node death with spooling and a drain on the
port's cluster keep the rows, and ``test_speculation.py``'s slow-worker
chaos runs on the same cluster.
"""

import threading
import time
import urllib.error

import pytest

from trino_tpu_torch.ft.injection import FaultInjector, InjectedFault, task_site
from trino_tpu_torch.ft.retry import (
    Backoff,
    RetryPolicy,
    TaskFailure,
    TaskRetriesExhausted,
    is_retryable,
)
from trino_tpu_torch.server.failuredetector import (
    HeartbeatFailureDetector,
    NodeState,
)


# === unit: failure detector ==============================================


class TestNodeStateDecay:
    def test_first_observation_fully_weighted(self):
        n = NodeState("n", "uri", decay_seconds=30.0)
        n.record(success=False, now=100.0)
        assert n.failure_ratio == 1.0
        assert n.known

    def test_exponential_decay_half_life(self):
        # alpha = 2^(-dt/decay): one decay period halves the old ratio
        # timestamps start >0: last_update==0.0 is the never-pinged mark
        n = NodeState("n", "uri", decay_seconds=30.0)
        n.record(success=False, now=100.0)
        n.record(success=True, now=130.0)
        assert n.failure_ratio == pytest.approx(0.5)
        n.record(success=True, now=160.0)
        assert n.failure_ratio == pytest.approx(0.25)

    def test_failure_after_success_rises(self):
        n = NodeState("n", "uri", decay_seconds=30.0)
        n.record(success=True, now=100.0)
        n.record(success=False, now=130.0)
        # 0.5 * 0.0 + 0.5 * 1.0
        assert n.failure_ratio == pytest.approx(0.5)
        assert n.consecutive_failures == 1

    def test_never_pinged_is_unknown(self):
        n = NodeState("n", "uri")
        assert not n.known
        assert n.failure_ratio == 0.0


class TestFailureDetector:
    def _detector(self, ping, **kw):
        kw.setdefault("interval", 0.01)
        return HeartbeatFailureDetector(ping, **kw)

    def test_never_pinged_node_not_active(self):
        d = self._detector(lambda uri: True)
        d.register("w1", "http://w1")
        # zero initial failure_ratio must not read as healthy
        assert d.active_nodes() == []
        assert not d.is_failed("w1")  # ...but no positive evidence either

    def test_blacklist_and_recovery_via_active_nodes(self):
        healthy = {"ok": True}
        d = self._detector(lambda uri: healthy["ok"], decay_seconds=0.001)
        d.register("w1", "http://w1")
        d.ping_all()
        assert d.active_nodes() == ["w1"]
        healthy["ok"] = False
        time.sleep(0.01)
        d.ping_all()
        assert d.is_failed("w1")
        assert d.active_nodes() == []
        healthy["ok"] = True
        time.sleep(0.01)
        d.ping_all()  # tiny decay horizon: one good ping recovers
        assert d.active_nodes() == ["w1"]

    def test_restart_after_stop_pings_again(self):
        # regression: a restarted detector must clear the stop event, or
        # the new loop exits before its first ping
        pings = []
        d = self._detector(lambda uri: pings.append(uri) or True)
        d.register("w1", "http://w1")
        d.start()
        time.sleep(0.05)
        d.stop()
        assert pings, "first run never pinged"
        n_before = len(pings)
        d.start()
        time.sleep(0.05)
        d.stop()
        assert len(pings) > n_before, "restarted detector never pinged"

    def test_start_twice_is_one_thread(self):
        d = self._detector(lambda uri: True)
        d.start()
        t1 = d._thread
        d.start()
        assert d._thread is t1
        d.stop()


# === unit: fault injector ================================================


class TestFaultInjector:
    def test_draw_is_deterministic_across_instances(self):
        a = FaultInjector(seed=42, task_crash_p=0.5)
        b = FaultInjector(seed=42, task_crash_p=0.5)
        for site in ("task:1.0", "task:2.3r1", "http:start:0.1:t2"):
            assert a.draw(site) == b.draw(site)

    def test_different_sites_and_seeds_differ(self):
        inj = FaultInjector(seed=1)
        assert inj.draw("task:1.0") != inj.draw("task:1.1")
        assert FaultInjector(seed=2).draw("task:1.0") != inj.draw("task:1.0")

    def test_salt_gives_fresh_draws(self):
        # QUERY retry sets fault_attempt_salt so attempt 2 is not doomed
        # to replay attempt 1's faults
        a = FaultInjector(seed=7, salt=0)
        b = FaultInjector(seed=7, salt=2)
        assert a.draw("task:1.0") != b.draw("task:1.0")

    def test_p_zero_never_fires(self):
        inj = FaultInjector(seed=1, task_crash_p=0.0, http_drop_p=0.0)
        for i in range(50):
            inj.maybe_crash_task(f"task:1.{i}")
            inj.maybe_drop_http(f"http:start:1.{i}:t1")
        assert inj.total_injected == 0

    def test_p_one_always_fires_and_logs(self):
        inj = FaultInjector(seed=1, task_crash_p=1.0)
        with pytest.raises(InjectedFault) as ei:
            inj.maybe_crash_task("task:3.0")
        assert ei.value.retryable
        assert ei.value.site == "task:3.0"
        assert inj.counts == {"task-crash": 1}
        assert inj.events[0]["site"] == "task:3.0"
        assert inj.events[0]["kind"] == "task-crash"

    def test_from_session_none_when_disabled(self):
        from trino_tpu_torch.config import Session

        assert FaultInjector.from_session(Session()) is None
        s = Session(properties={"fault_task_crash_p": "0.3",
                                "fault_injection_seed": "9"})
        inj = FaultInjector.from_session(s)
        assert inj is not None and inj.seed == 9
        assert inj.task_crash_p == pytest.approx(0.3)

    def test_task_site_strips_query_counter(self):
        assert task_site("cq7.3.0") == "task:3.0"
        assert task_site("cq7.3.0r2") == "task:3.0r2"
        assert task_site("cq12345.3.0") == task_site("cq1.3.0")


# === unit: backoff + classification ======================================


class TestBackoff:
    def test_growth_and_cap(self):
        b = Backoff(initial_ms=100, max_ms=400, seed=0)
        d = [b.delay(a) for a in (1, 2, 3, 4, 5)]
        # base: 100, 200, 400, 400, 400 (ms); jitter in [0.5, 1.0]
        assert 0.05 <= d[0] <= 0.1
        assert 0.1 <= d[1] <= 0.2
        for later in d[2:]:
            assert 0.2 <= later <= 0.4

    def test_deterministic_jitter(self):
        assert Backoff(seed=3).delay(2) == Backoff(seed=3).delay(2)
        assert Backoff(seed=3).delay(2) != Backoff(seed=4).delay(2)

    def test_zero_initial_disables_sleep(self):
        assert Backoff(initial_ms=0).delay(5) == 0.0


class TestRetryableClassification:
    def test_injected_fault_retryable(self):
        assert is_retryable(InjectedFault("task:1.0", 0.1, "task-crash"))

    def test_network_errors_retryable(self):
        assert is_retryable(urllib.error.URLError("connection refused"))
        assert is_retryable(TimeoutError("exchange timed out"))
        assert is_retryable(ConnectionResetError())

    def test_plain_errors_fatal(self):
        assert not is_retryable(ValueError("bad plan"))
        assert not is_retryable(KeyError("col"))

    def test_task_failure_carries_classification(self):
        assert is_retryable(TaskFailure("cq1.2.0", "w1", "boom", True))
        assert not is_retryable(TaskFailure("cq1.2.0", "w1", "boom", False))
        assert not is_retryable(
            TaskRetriesExhausted("cq1.2.0", "w1", "boom", attempts=4)
        )

    def test_capacity_retry_exceeded_fatal_with_context(self):
        from trino_tpu_torch.exec.fragments import CapacityRetryExceeded

        e = CapacityRetryExceeded(
            "traced-program", fragment_id=3,
            capacities={"rows": 4096}, attempts=5,
        )
        assert not is_retryable(e)  # same data => same growth on any node
        assert e.fragment_id == 3
        assert e.capacities == {"rows": 4096}
        assert e.attempts == 5
        msg = str(e)
        assert "fragment=3" in msg and "attempts=5" in msg
        assert "rows=4096" in msg

    def test_memory_limit_retryable(self):
        from trino_tpu_torch.memory import ExceededMemoryLimitError

        assert is_retryable(ExceededMemoryLimitError("node pool exhausted"))


class TestRetryPolicy:
    def test_of_normalizes_and_validates(self):
        assert RetryPolicy.of("task") == RetryPolicy.TASK
        assert RetryPolicy.of(None) == RetryPolicy.NONE
        with pytest.raises(ValueError):
            RetryPolicy.of("SOMETIMES")

    def test_from_session(self):
        from trino_tpu_torch.config import Session

        assert RetryPolicy.from_session(Session()) == RetryPolicy.NONE
        s = Session(properties={"retry_policy": "QUERY"})
        assert RetryPolicy.from_session(s) == RetryPolicy.QUERY


# === unit: retained output buffer ========================================


class TestOutputBufferRetain:
    def _fill(self, buf, pages):
        for p in pages:
            buf.enqueue(0, p)
        buf.set_complete()

    def test_retained_pages_survive_ack_and_rewind(self):
        from trino_tpu_torch.server.task import OutputBuffer

        buf = OutputBuffer(1, retain=True)
        self._fill(buf, [b"a", b"b", b"c"])
        pages, token, complete = buf.get(0, 0, max_wait=0)
        assert pages == [b"a", b"b", b"c"] and token == 3 and complete
        # the final ack a consumer sends on completion...
        buf.get(0, 3, max_wait=0)
        # ...must not free anything: a retried consumer re-pulls from 0
        pages2, token2, _ = buf.get(0, 0, max_wait=0)
        assert pages2 == [b"a", b"b", b"c"] and token2 == 3

    def test_unretained_ack_frees(self):
        from trino_tpu_torch.server.task import OutputBuffer

        buf = OutputBuffer(1)
        self._fill(buf, [b"a", b"b"])
        buf.get(0, 0, max_wait=0)
        buf.get(0, 2, max_wait=0)  # ack both
        pages, _, _ = buf.get(0, 0, max_wait=0)
        assert pages == []  # freed

    def test_retain_skips_backpressure(self):
        from trino_tpu_torch.server.task import OutputBuffer

        buf = OutputBuffer(1, max_buffered_bytes=4, retain=True)
        done = threading.Event()

        def produce():
            for _ in range(16):
                buf.enqueue(0, b"xxxx")  # 16x over the cap
            done.set()

        threading.Thread(target=produce, daemon=True).start()
        assert done.wait(timeout=5.0), (
            "retained buffer applied backpressure with no consumer — "
            "stage-barrier scheduling would deadlock here"
        )


# === unit: in-process task crash + HTTP retry ============================


def _values_fragment_payload(properties):
    """Self-contained single fragment (Values scan) for SqlTask tests."""
    from trino_tpu_torch.planner.fragmenter import fragment_plan
    from trino_tpu_torch.planner.serde import fragment_to_json
    from trino_tpu_torch.testing import LocalQueryRunner

    r = LocalQueryRunner(device="cpu")
    r.session.set("execution_mode", "distributed")
    plan = r.plan("select x + 1 from (values (1),(2),(3)) t(x)")
    sub = fragment_plan(plan)
    return r.engine, {
        "fragment": fragment_to_json(sub.fragment),
        "splits": {},
        "sources": {},
        "session": {"properties": properties},
    }


class TestTaskCrashInjection:
    def test_crash_p_one_fails_task_retryable(self):
        from trino_tpu_torch.server.task import SqlTask

        engine, payload = _values_fragment_payload(
            {"fault_task_crash_p": 1.0, "fault_injection_seed": 1}
        )
        task = SqlTask("cq1.0.0", engine, payload)
        task._thread.join(timeout=30)
        assert task.state == "FAILED"
        assert task.retryable is True
        assert "injected" in (task.error or "")
        info = task.info()
        assert info["retryable"] is True
        assert info["stats"].get("faults_injected", 0) >= 1

    def test_crash_p_zero_unaffected(self):
        from trino_tpu_torch.server.task import SqlTask

        engine, payload = _values_fragment_payload({})
        task = SqlTask("cq1.0.0", engine, payload)
        task._thread.join(timeout=30)
        assert task.state == "FINISHED", task.error
        assert task.retryable is None
        assert task.injector is None  # zero overhead when disabled


class TestFragmentInjection:
    def test_fragment_site_crashes_distributed_execution(self):
        from trino_tpu_torch.testing import LocalQueryRunner

        r = LocalQueryRunner(device="cpu")
        r.session.set("execution_mode", "distributed")
        r.session.set("fault_task_crash_p", 1.0)
        r.session.set("fault_injection_seed", 1)
        with pytest.raises(InjectedFault) as ei:
            r.execute("select count(*) from lineitem")
        assert ei.value.site.startswith("frag:")


class TestHttpRemoteTaskRetry:
    def test_injected_drops_retried_then_exhausted(self):
        from trino_tpu_torch.server.cluster import HttpRemoteTask, WorkerNode

        inj = FaultInjector(seed=1, http_drop_p=1.0)
        task = HttpRemoteTask(
            WorkerNode("w1", "http://127.0.0.1:1"),  # never reached
            "cq9.2.0",
            {},
            http_retries=3,
            injector=inj,
            backoff=Backoff(initial_ms=1, max_ms=2),
        )
        with pytest.raises(InjectedFault):
            task.start()
        # one drop per attempt, at attempt-distinct sites
        sites = [e["site"] for e in inj.events]
        assert sites == [
            "http:start:2.0:t1",
            "http:start:2.0:t2",
            "http:start:2.0:t3",
        ]


# === unit: QUERY retry in the query manager ==============================


class _FlakyEngine:
    """execute_statement fails ``failures`` times, then succeeds."""

    def __init__(self, failures, exc_factory):
        self.failures = failures
        self.exc_factory = exc_factory
        self.calls = 0
        self.salts = []

    def execute_statement(self, sql, session):
        from trino_tpu_torch.engine import StatementResult

        self.calls += 1
        self.salts.append(session.properties.get("fault_attempt_salt"))
        if self.calls <= self.failures:
            raise self.exc_factory()
        return StatementResult([(1,)], ["x"], [])


class TestQueryRetryPolicy:
    def _run(self, engine, properties):
        from trino_tpu_torch.config import Session
        from trino_tpu_torch.server.querymanager import ManagedQuery

        q = ManagedQuery("select 1", Session(properties=properties))
        q.run(engine)
        return q

    def test_retryable_failures_rerun_with_fresh_salt(self):
        eng = _FlakyEngine(
            2, lambda: InjectedFault("task:1.0", 0.1, "task-crash")
        )
        q = self._run(eng, {
            "retry_policy": "QUERY",
            "query_retry_attempts": 3,
            "retry_initial_delay_ms": 1,
            "retry_max_delay_ms": 2,
        })
        assert q.error is None, q.error and q.error.message
        assert eng.calls == 3
        assert q.query_attempts == 3
        # attempt 2+ re-key the injector so faults are not replayed
        assert eng.salts == [None, 2, 3]
        assert q.info()["queryAttempts"] == 3

    def test_budget_exhausted_fails_with_retryable_error(self):
        eng = _FlakyEngine(
            99, lambda: InjectedFault("task:1.0", 0.1, "task-crash")
        )
        q = self._run(eng, {
            "retry_policy": "QUERY",
            "query_retry_attempts": 2,
            "retry_initial_delay_ms": 1,
            "retry_max_delay_ms": 2,
        })
        assert eng.calls == 2
        assert q.error is not None and q.error.retryable
        assert q.info()["error"]["retryable"] is True

    def test_fatal_error_not_retried(self):
        eng = _FlakyEngine(99, lambda: ValueError("semantic-ish"))
        q = self._run(eng, {
            "retry_policy": "QUERY",
            "query_retry_attempts": 3,
            "retry_initial_delay_ms": 1,
        })
        assert eng.calls == 1
        assert q.error is not None and not q.error.retryable

    def test_policy_none_never_retries(self):
        eng = _FlakyEngine(
            1, lambda: InjectedFault("task:1.0", 0.1, "task-crash")
        )
        q = self._run(eng, {})
        assert eng.calls == 1
        assert q.error is not None and q.error.retryable


# === chaos: real cluster under injected faults ===========================

TPCH_CHAOS_QUERIES = [
    # Q1-flavored aggregation
    """select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
              sum(l_extendedprice) as sum_base_price, count(*) as count_order
       from lineitem where l_shipdate <= date '1998-09-02'
       group by l_returnflag, l_linestatus
       order by l_returnflag, l_linestatus""",
    # Q6
    """select sum(l_extendedprice * l_discount) as revenue from lineitem
       where l_shipdate >= date '1994-01-01'
         and l_shipdate < date '1995-01-01'
         and l_discount between 0.05 and 0.07 and l_quantity < 24""",
    # Q3-flavored join + group + topn
    """select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue
       from customer, orders, lineitem
       where c_mktsegment = 'BUILDING'
         and c_custkey = o_custkey and l_orderkey = o_orderkey
         and o_orderdate < date '1995-03-15'
         and l_shipdate > date '1995-03-15'
       group by l_orderkey order by revenue desc, l_orderkey limit 10""",
    # distributed join + distinct-ish grouping
    """select o_orderpriority, count(*) as order_count from orders
       where o_orderdate >= date '1993-07-01'
         and o_orderdate < date '1993-10-01'
       group by o_orderpriority order by o_orderpriority""",
    # broadcast join
    """select n_name, count(*) from supplier, nation
       where s_nationkey = n_nationkey group by n_name order by n_name""",
]

CHAOS = {
    "retry_policy": "TASK",
    "task_retry_attempts": 8,
    "fault_injection_seed": 7,
    "fault_task_crash_p": 0.3,
    "retry_initial_delay_ms": 20,
    "retry_max_delay_ms": 200,
}


@pytest.fixture(scope="module")
def chaos_cluster():
    from trino_tpu_torch.testing import MultiProcessQueryRunner

    with MultiProcessQueryRunner(n_workers=2, device="cpu") as runner:
        yield runner


def _query_infos(runner):
    import json
    import urllib.request

    with urllib.request.urlopen(
        f"{runner.coordinator_uri}/v1/query", timeout=10
    ) as r:
        return json.loads(r.read().decode())


@pytest.mark.faults
class TestTaskRetryChaos:
    def test_tpch_bit_identical_under_crashes(self, chaos_cluster):
        """Acceptance: >=5 TPC-H queries at crash_p=0.3 with
        retry_policy=TASK return bit-identical rows, with non-zero retry
        counters overall."""
        for sql in TPCH_CHAOS_QUERIES:
            clean, _ = chaos_cluster.execute(sql)
            chaotic, _ = chaos_cluster.execute(sql, session_properties=CHAOS)
            assert chaotic == clean, f"diverged under chaos: {sql[:60]}"
        retries = [q.get("taskRetries", 0) for q in _query_infos(chaos_cluster)]
        assert sum(retries) > 0, (
            "crash_p=0.3 over 5 queries should have injected at least one "
            f"task crash (retry counters: {retries})"
        )

    def test_retry_policy_none_fails_closed_and_classified(self, chaos_cluster):
        """Acceptance: with retry_policy=NONE the same injection
        reproducibly fails the query with a *retryable*-classified error."""
        from trino_tpu_torch.client import QueryFailure

        props = {
            "fault_injection_seed": 7,
            "fault_task_crash_p": 1.0,  # every task crashes: deterministic
        }
        errors = []
        for _ in range(2):
            with pytest.raises(QueryFailure) as ei:
                chaos_cluster.execute(
                    TPCH_CHAOS_QUERIES[1], session_properties=props
                )
            errors.append(ei.value.error)
        assert all(e.get("retryable") is True for e in errors)
        # the query ID differs per run by design (task ids embed it:
        # {yyyyMMdd_HHmmss_index_coord}.{stage}.{task}, or cq{n} for
        # direct scheduler calls); the injected fault (site, draw,
        # failing fragment.partition) must replay exactly
        import re

        normalized = [
            re.sub(
                r"\d{8}_\d{6}_\d{5}_\w+|cq\d+", "qid#", e["message"]
            )
            for e in errors
        ]
        assert normalized[0] == normalized[1], (
            "same seed must reproduce the same failure"
        )
        assert "injected" in errors[0]["message"]

    def test_query_retry_policy_reruns_statement(self, chaos_cluster):
        """retry_policy=QUERY survives a crashing first attempt: the
        re-run gets a fresh attempt salt, so the same seed that kills
        attempt 1 spares a later one."""
        props = {
            "retry_policy": "QUERY",
            "query_retry_attempts": 6,
            "fault_injection_seed": 7,
            "fault_task_crash_p": 0.3,
            "retry_initial_delay_ms": 20,
            "retry_max_delay_ms": 200,
        }
        sql = TPCH_CHAOS_QUERIES[4]
        clean, _ = chaos_cluster.execute(sql)
        chaotic, _ = chaos_cluster.execute(sql, session_properties=props)
        assert chaotic == clean


@pytest.mark.faults
@pytest.mark.slow
class TestHttpDropChaos:
    def test_drop_matrix_bit_identical(self, chaos_cluster):
        """HTTP-level chaos: dropped task dispatch/status/exchange calls
        are absorbed by per-request retries (token-addressed reads are
        idempotent) under both NONE and TASK policies."""
        sql = TPCH_CHAOS_QUERIES[0]
        clean, _ = chaos_cluster.execute(sql)
        for policy in ("NONE", "TASK"):
            for seed in (3, 11):
                props = {
                    "retry_policy": policy,
                    "task_retry_attempts": 8,
                    "fault_injection_seed": seed,
                    "fault_http_drop_p": 0.1,
                    "http_retry_attempts": 6,
                    "retry_initial_delay_ms": 10,
                    "retry_max_delay_ms": 100,
                }
                chaotic, _ = chaos_cluster.execute(
                    sql, session_properties=props
                )
                assert chaotic == clean, f"{policy} seed={seed} diverged"


# === the port's own: parity with the reference, node death and drain ====

SITES = [task_site(t) for t in ("20240101_000000_00001_x.2.0", "q7.1.1", "q7.1.1r2",
                                "q9.3.0s1", "cq1.0.0")] + [
    "frag:0", "frag:3", "http:results:2.0.p0.k0:t1", "http:task:1.1:t2"]


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_injector_draws_equal_the_reference(seed):
    """For the same seed, salt and sites, the port's draws, crash and
    drop decisions and worker-exit verdicts equal the reference's."""
    from trino_tpu.ft.injection import FaultInjector as RefInjector
    from trino_tpu.ft.injection import InjectedFault as RefFault
    from trino_tpu.ft.injection import task_site as ref_task_site

    def decisions(cls, fault):
        out = []
        for salt in (0, 1, "q2"):
            inj = cls(seed=seed, task_crash_p=0.3, http_drop_p=0.2, salt=salt,
                      slow_workers="worker-1", worker_exit_site="2.0")
            for site in SITES:
                row = [round(inj.draw(site), 12), inj.is_slow_node("worker-1"),
                       inj.is_slow_node("worker-0"),
                       inj.should_exit_worker(site, "worker-0")]
                for fn in (inj.maybe_crash_task, inj.maybe_drop_http):
                    try:
                        fn(site)
                        row.append(None)
                    except fault as e:
                        row.append((e.site, e.kind, round(e.draw, 12)))
                out.append(row)
            out.append(dict(inj.counts))
        return out

    assert decisions(FaultInjector, InjectedFault) == decisions(RefInjector, RefFault)
    assert [task_site(s) for s in ("a.b.1.2", "q1.0.0r3")] == [
        ref_task_site(s) for s in ("a.b.1.2", "q1.0.0r3")]


def test_retry_classes_equal_the_reference():
    """``is_retryable``, ``Backoff`` and ``RetryPolicy`` answer as the
    reference's on the same inputs (the port's own error classes — a
    kernel error, a CUDA error — are not retryable)."""
    import socket
    import urllib.error

    from trino_tpu.ft import retry as R
    from trino_tpu_torch import _kernels

    errs = [InjectedFault("task:1.0", 0.1, "task-crash"), ConnectionError("x"),
            TimeoutError("x"), socket.timeout("x"), OSError("x"),
            urllib.error.URLError("x"), ValueError("x"), RuntimeError("x"), KeyError("x")]
    assert [is_retryable(e) for e in errs] == [R.is_retryable(e) for e in errs]
    assert not is_retryable(_kernels.KernelError("dense_join_build: CUDA launch failed"))
    for b, rb in ((Backoff(), R.Backoff()), (Backoff(50, 400, 9), R.Backoff(50, 400, 9))):
        assert [b.delay(a) for a in range(1, 9)] == [rb.delay(a) for a in range(1, 9)]
    for p in ("none", "TASK", "query"):
        assert RetryPolicy.of(p) == R.RetryPolicy.of(p)


def test_node_death_with_spooling_and_drain(chaos_cluster):
    """The chaos script's node-death and drain scenarios on the port's
    cluster: the worker that ran Q1's scan task dies after it finished,
    and the rows stay equal through spooled output or lineage recovery
    (``recoveredTasks`` >= 1, ``spooledBytes`` > 0); a graceful drain then
    a restart of a worker keep them too."""
    from torch_cluster_fixtures import query_info_for

    death = {"retry_policy": "TASK", "exchange_spooling": True,
             "worker_execution": "per_fragment", "task_retry_attempts": 8,
             "retry_initial_delay_ms": 20, "retry_max_delay_ms": 200,
             "fault_worker_exit_site": "2.0", "fault_worker_exit_delay_ms": 300,
             "fault_task_stall_ms": 1000}
    from trino_tpu_torch.benchmarks.tpch import queries

    sql = queries("tpch.tiny")[1].replace("sum_qty", "death_probe")
    assert "death_probe" in sql
    clean, _ = chaos_cluster.execute(sql)
    try:
        died, _ = chaos_cluster.execute(sql, session_properties=death)
        assert died == clean
        info = query_info_for(chaos_cluster, "death_probe")
        assert info["recoveredTasks"] >= 1 and info["spooledBytes"] > 0
        assert info["queryAttempts"] == 1
    finally:
        for i, p in enumerate(chaos_cluster._worker_procs):
            if p.poll() is not None:
                chaos_cluster.restart_worker(i)
    chaos_cluster.drain_worker(0)
    drained, _ = chaos_cluster.execute(sql)
    chaos_cluster.restart_worker(0)
    restarted, _ = chaos_cluster.execute(sql)
    assert drained == restarted == clean


# --- the slow-worker chaos of the reference's tests/test_speculation.py,
# on this file's cluster (one cluster boot fewer)

from test_torch_speculation import Q1 as SPEC_Q1  # noqa: E402
from test_torch_speculation import SLOW_WORKER_PROPS, _query_infos  # noqa: E402

@pytest.mark.faults
class TestSlowWorkerChaos:
    def test_bit_identical_with_hedge_win(self, chaos_cluster):
        clean, _ = chaos_cluster.execute(SPEC_Q1)
        hedged, _ = chaos_cluster.execute(
            SPEC_Q1, session_properties=SLOW_WORKER_PROPS
        )
        assert hedged == clean
        infos = _query_infos(chaos_cluster)
        attempts = max(q.get("speculativeAttempts", 0) for q in infos)
        wins = max(q.get("speculativeWins", 0) for q in infos)
        assert attempts >= 1, "straggler was never flagged"
        assert wins >= 1, "hedge never won against a 10x-slowed primary"

    def test_speculation_off_still_bit_identical(self, chaos_cluster):
        clean, _ = chaos_cluster.execute(SPEC_Q1)
        off = {**SLOW_WORKER_PROPS, "speculation": False}
        slowed, _ = chaos_cluster.execute(SPEC_Q1, session_properties=off)
        assert slowed == clean


