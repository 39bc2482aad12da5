"""Serving-edge tests against trino_tpu_torch's front door.

The cases of ``tests/test_front_door.py`` on the port's event loop,
pager, resource groups and server (``device="cpu"``; the sleepy engine
subclasses the port's ``Engine``), with the reference's timing margins.
The reference's docstring follows.


Covers the overload layer on top of the statement protocol: maxWait
parsing, token-bucket shedding with Retry-After, slowloris read
timeouts, client-abandonment reaping (cancel + admission slot release),
byte-budgeted streaming result pages, deterministic resource-group
waiter expiry, and graceful drain under load with zero dropped in-flight
queries.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from trino_tpu_torch.client import ClientSession, Connection
from trino_tpu_torch.config import ServerConfig
from trino_tpu_torch.engine import Engine
from trino_tpu_torch.server.eventloop import (
    TenantRateLimiter,
    TokenBucket,
    parse_max_wait,
)

from torch_server_fixtures import port_loop_under_lockdep  # noqa: F401

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# maxWait helper (consolidated parse/clamp/NaN-guard)
# ---------------------------------------------------------------------------


class TestParseMaxWait:
    def test_plain_values_pass_through(self):
        assert parse_max_wait("5") == 5.0
        assert parse_max_wait(2.5) == 2.5
        assert parse_max_wait(0) == 0.0

    def test_clamped_to_bounds(self):
        assert parse_max_wait("99") == 30.0
        assert parse_max_wait("-3") == 0.0
        assert parse_max_wait("1e9") == 30.0

    def test_garbage_falls_back_to_default(self):
        assert parse_max_wait("soon", default=1.0) == 1.0
        assert parse_max_wait(None, default=2.0) == 2.0
        assert parse_max_wait("", default=1.0) == 1.0

    def test_nan_and_inf_guard(self):
        # a malicious maxWait=nan must never wedge a poll loop
        assert parse_max_wait("nan", default=1.0) == 1.0
        assert parse_max_wait(float("nan"), default=1.0) == 1.0
        assert parse_max_wait("inf", default=1.0) == 1.0
        assert parse_max_wait("-inf", default=1.0) == 1.0

    def test_custom_bounds(self):
        assert parse_max_wait("0.5", default=0.0, lo=1.0, hi=10.0) == 1.0
        assert parse_max_wait("20", default=0.0, lo=1.0, hi=10.0) == 10.0


# ---------------------------------------------------------------------------
# token buckets
# ---------------------------------------------------------------------------


class TestTokenBucket:
    def test_burst_then_shed(self):
        b = TokenBucket(rate=1.0, burst=2.0)
        assert b.try_acquire(now=100.0) == 0.0
        assert b.try_acquire(now=100.0) == 0.0
        wait = b.try_acquire(now=100.0)
        assert wait > 0.0  # bucket empty: hint until next token

    def test_refills_over_time(self):
        b = TokenBucket(rate=10.0, burst=1.0)
        assert b.try_acquire(now=50.0) == 0.0
        assert b.try_acquire(now=50.0) > 0.0
        assert b.try_acquire(now=50.2) == 0.0  # 0.2s * 10/s = 2 tokens

    def test_tenant_isolation(self):
        lim = TenantRateLimiter(qps=0.001, burst=1.0)
        assert lim.try_acquire("alice") == 0.0
        assert lim.try_acquire("alice") > 0.0  # alice exhausted her burst
        assert lim.try_acquire("bob") == 0.0   # bob unaffected

    def test_disabled_when_qps_zero(self):
        lim = TenantRateLimiter(qps=0.0, burst=1.0)
        for _ in range(100):
            assert lim.try_acquire("anyone") == 0.0


# ---------------------------------------------------------------------------
# deterministic resource-group waiter expiry
# ---------------------------------------------------------------------------


class TestTimerDrivenReap:
    def test_waiter_expires_without_activity(self):
        """Regression: a queue-timeout waiter must be rejected on time by
        the armed reap timer even when NO other submit/finish activity
        ever happens (previously expiry was only opportunistic)."""
        from trino_tpu_torch.server.resourcegroups import (
            GroupConfig,
            ResourceGroupManager,
            Selector,
        )

        rgm = ResourceGroupManager(max_wait_seconds=0.3)
        rgm.configure(
            [GroupConfig("root", max_queued=10, hard_concurrency_limit=1)],
            [Selector(group="root")],
        )
        # occupy the only slot
        group, admitted = rgm.submit("holder", "", lambda g, e: None)
        assert admitted
        fired = []
        rgm.submit("waiter", "", lambda g, e: fired.append(e))
        # no finish(), no further submit() — only the timer can reap
        deadline = time.monotonic() + 2.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fired, "waiter expiry never fired without activity"
        assert fired[0] is not None  # QueryQueueFullError
        assert rgm.info()[0]["queuedQueries"] == 0

    def test_abandon_frees_queue_slot(self):
        from trino_tpu_torch.server.resourcegroups import (
            GroupConfig,
            ResourceGroupManager,
            Selector,
        )

        rgm = ResourceGroupManager(max_wait_seconds=30.0)
        rgm.configure(
            [GroupConfig("root", max_queued=10, hard_concurrency_limit=1)],
            [Selector(group="root")],
        )
        group, admitted = rgm.submit("holder", "", lambda g, e: None)
        assert admitted
        cb = lambda g, e: None  # noqa: E731
        g2, admitted2 = rgm.submit("waiter", "", cb)
        assert not admitted2
        assert rgm.info()[0]["queuedQueries"] == 1
        assert rgm.abandon(g2, cb)
        assert rgm.info()[0]["queuedQueries"] == 0
        assert not rgm.abandon(g2, cb)  # idempotent


# ---------------------------------------------------------------------------
# streaming result pager
# ---------------------------------------------------------------------------


class TestResultPager:
    def _pager(self, n_rows=1000, budget=2048):
        from trino_tpu_torch.server.querymanager import ResultPager

        rows = [(i, "x" * 20) for i in range(n_rows)]
        return rows, ResultPager(rows, budget, max_rows_per_page=4096)

    def test_pages_cover_all_rows_in_order(self):
        rows, pager = self._pager()
        got, token = [], 0
        while True:
            page, more = pager.page(token)
            if page is not None:
                got.extend(page)
            if not more:
                break
            token += 1
        assert got == rows
        assert pager.pages_produced > 3  # budget forced multiple pages

    def test_buffer_stays_bounded(self):
        _, pager = self._pager(n_rows=5000, budget=1024)
        token = 0
        while True:
            _, more = pager.page(token)
            # at most the served page + the one just produced stay
            # buffered; acked pages are freed as the client advances
            assert pager.buffered_bytes <= 3 * 1024 + 256
            if not more:
                break
            token += 1
        assert pager.pages_produced >= 10
        assert pager.peak_buffered_bytes <= 3 * 1024 + 256

    def test_token_retry_is_idempotent(self):
        _, pager = self._pager()
        first, more1 = pager.page(0)
        again, more2 = pager.page(0)
        assert first == again and more1 == more2

    def test_empty_result(self):
        from trino_tpu_torch.server.querymanager import ResultPager

        pager = ResultPager([], 1024)
        page, more = pager.page(0)
        assert page is None and not more

    @pytest.mark.parametrize("budget,max_rows", [
        (1, 4096), (64, 4096), (700, 4096), (2048, 7), (2048, 4096),
        (8 << 10, 100), (1 << 20, 4096), (1 << 20, 1000),
    ])
    def test_pages_equal_the_reference(self, budget, max_rows):
        """The port cuts a chunk under the budget in one encoding; every
        page, its bytes and the more flag equal the reference's pager,
        row by row, for rows of every kind (DECIMAL, NULL, text, a value
        JSON cannot encode)."""
        from decimal import Decimal

        from trino_tpu.server.querymanager import ResultPager as RefPager
        from trino_tpu_torch.server.querymanager import ResultPager

        rows = [(i, None if i % 5 == 0 else Decimal(i) / 7, "é" * (i % 13),
                 {i} if i % 97 == 0 else i * 1.5) for i in range(3000)]
        for n in (0, 1, 7, 3000):
            ref, port = RefPager(rows[:n], budget, max_rows), ResultPager(rows[:n], budget, max_rows)
            token = 0
            while True:
                got, want = port.page(token), ref.page(token)
                assert got == want, (n, token)
                assert port._page_bytes.get(token) == ref._page_bytes.get(token)
                if not want[1]:
                    break
                token += 1
            assert port.pages_produced == ref.pages_produced
            assert port.peak_buffered_bytes == ref.peak_buffered_bytes


class TestDispatchPool:
    def test_every_queued_item_gets_a_worker(self):
        """Items submitted back to back each start at once, up to the
        pool's width: a worker is spawned for every item that no idle
        worker will take (a batch member parks its worker for the whole
        batching window, so an item queued behind it would wait that
        long). The reference's pool spawns only while no worker is idle
        and can leave items queued behind one waking worker."""
        from trino_tpu_torch.server.querymanager import _DispatchPool

        pool = _DispatchPool(8, name="test")
        barrier = threading.Barrier(8, timeout=5)
        met = []

        def item():
            barrier.wait()
            met.append(1)

        try:
            for _ in range(4):
                pool.submit(lambda: None)
            time.sleep(0.05)  # four idle workers now
            for _ in range(8):
                pool.submit(item)
            deadline = time.monotonic() + 5
            while len(met) < 8 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert len(met) == 8 and not barrier.broken
            assert len(pool._threads) == 8
        finally:
            pool.shutdown()


    def test_concurrent_submitters_each_get_a_worker(self):
        """Stress: 16 threads submit at once, with the interpreter
        switching threads as often as it can; every item starts before any
        ends (a lost count would leave one queued behind the barrier)."""
        import sys

        from trino_tpu_torch.server.querymanager import _DispatchPool

        pool = _DispatchPool(16, name="stress")
        barrier = threading.Barrier(16, timeout=10)
        met = []
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for _ in range(3):  # idle workers left by each round
                barrier.reset()
                met.clear()
                submitters = [threading.Thread(target=pool.submit, args=(
                    lambda: (barrier.wait(), met.append(1)),)) for _ in range(16)]
                for t in submitters:
                    t.start()
                for t in submitters:
                    t.join(10)
                deadline = time.monotonic() + 10
                while len(met) < 16 and time.monotonic() < deadline:
                    time.sleep(0.01)
                assert len(met) == 16 and not barrier.broken
        finally:
            sys.setswitchinterval(switch)
            pool.shutdown()


# ---------------------------------------------------------------------------
# serving edge over real HTTP
# ---------------------------------------------------------------------------


class SleepyEngine(Engine):
    """Engine whose statements take a configurable wall time."""

    def __init__(self, delay_s: float):
        super().__init__(device="cpu")
        self.delay_s = delay_s

    def execute_statement(self, sql, session, query_id=None, fire_events=True):
        time.sleep(self.delay_s)
        return super().execute_statement(
            sql, session, query_id=query_id, fire_events=fire_events
        )


def _post_statement(base_uri: str, sql: str, user: str = "u") -> dict:
    req = urllib.request.Request(
        f"{base_uri}/v1/statement",
        data=sql.encode(),
        method="POST",
        headers={"X-Trino-User": user},
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read().decode())


class TestSlowloris:
    def test_partial_request_times_out(self):
        from trino_tpu_torch.server.http import TrinoTpuServer

        s = TrinoTpuServer(
            device="cpu",
            server_config=ServerConfig(read_timeout_s=0.2)
        ).start()
        try:
            sock = socket.create_connection((s.host, s.port), timeout=5)
            sock.sendall(b"GET /v1/info HTTP/1.1\r\nHost: x")  # never finishes
            sock.settimeout(5)
            data = sock.recv(4096)
            # server must terminate the connection (408 or plain close),
            # not park a thread on it forever
            assert data == b"" or b"408" in data
            sock.close()
            # and keep serving well-formed requests afterwards
            with urllib.request.urlopen(
                f"{s.base_uri}/v1/info", timeout=5
            ) as r:
                assert r.status == 200
        finally:
            s.stop()

    def test_abrupt_disconnect_mid_poll_is_harmless(self):
        from trino_tpu_torch.server.http import TrinoTpuServer

        s = TrinoTpuServer(engine=SleepyEngine(0.5)).start()
        try:
            out = _post_statement(s.base_uri, "select 1")
            next_uri = out["nextUri"]
            path = next_uri[len(s.base_uri):]
            # long-poll the query, then slam the connection shut mid-wait
            sock = socket.create_connection((s.host, s.port), timeout=5)
            sock.sendall(
                f"GET {path} HTTP/1.1\r\nHost: x\r\n"
                "X-Trino-Max-Wait: 10s\r\n\r\n".encode()
            )
            time.sleep(0.1)
            sock.close()  # parked responder becomes a no-op
            # the server keeps serving; the query still completes
            deadline = time.monotonic() + 5
            state = None
            while time.monotonic() < deadline:
                with urllib.request.urlopen(
                    f"{s.base_uri}/v1/query/{out['id']}", timeout=5
                ) as r:
                    state = json.loads(r.read().decode())["state"]
                if state == "FINISHED":
                    break
                time.sleep(0.05)
            assert state == "FINISHED"
        finally:
            s.stop()


class TestShedding:
    def test_tenant_rate_limit_sheds_with_retry_after(self):
        from trino_tpu_torch.server.http import TrinoTpuServer

        s = TrinoTpuServer(
            device="cpu",
            server_config=ServerConfig(
                tenant_rate_limit_qps=2.0, tenant_rate_limit_burst=1.0
            )
        ).start()
        try:
            _post_statement(s.base_uri, "select 1", user="alice")
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post_statement(s.base_uri, "select 2", user="alice")
            assert ei.value.code == 503
            assert ei.value.headers.get("Retry-After") is not None
            # another tenant is unaffected
            out = _post_statement(s.base_uri, "select 3", user="bob")
            assert out["id"]
            # shed counter incremented with the right reason
            with urllib.request.urlopen(
                f"{s.base_uri}/v1/metrics?format=json", timeout=5
            ) as r:
                snap = json.loads(r.read().decode())
            shed = [
                v for k, v in snap.get("counters", {}).items()
                if k.startswith("trino_tpu_requests_shed_total")
                and "tenant_rate_limit" in k
            ]
            assert shed and shed[0] >= 1
        finally:
            s.stop()

    def test_client_retries_after_shed_and_succeeds(self):
        from trino_tpu_torch.server.http import TrinoTpuServer

        s = TrinoTpuServer(
            device="cpu",
            server_config=ServerConfig(
                tenant_rate_limit_qps=2.0, tenant_rate_limit_burst=1.0
            )
        ).start()
        try:
            conn = Connection(
                s.base_uri, ClientSession(user="carol", shed_retry_attempts=4)
            )
            # back-to-back statements: the second is shed at first, and
            # the client's Retry-After backoff carries it through
            assert conn.execute("select 1")[0] == [(1,)]
            assert conn.execute("select 2")[0] == [(2,)]
        finally:
            s.stop()


class TestAbandonedClient:
    def test_unpolled_query_is_canceled_and_slot_freed(self):
        from trino_tpu_torch.server.http import TrinoTpuServer
        from trino_tpu_torch.server.resourcegroups import (
            GroupConfig,
            ResourceGroupManager,
            Selector,
        )

        rgm = ResourceGroupManager(max_wait_seconds=30)
        rgm.configure(
            [GroupConfig("root", max_queued=10, hard_concurrency_limit=1)],
            [Selector(group="root")],
        )
        s = TrinoTpuServer(
            engine=SleepyEngine(1.0),
            resource_groups=rgm,
            server_config=ServerConfig(client_timeout_s=0.3),
        ).start()
        try:
            out = _post_statement(s.base_uri, "select 1")
            qid = out["id"]
            # ... and the client vanishes: no nextUri poll ever happens.
            # within client_timeout_s (+ sweep cadence) the reaper cancels
            deadline = time.monotonic() + 3.0
            state = None
            while time.monotonic() < deadline:
                q = s.query_manager.get(qid)
                state = q.state.get().value if q else None
                if state == "CANCELED":
                    break
                time.sleep(0.05)
            assert state == "CANCELED"
            # the admission slot frees once the engine call unwinds
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline:
                if rgm.info()[0]["runningQueries"] == 0:
                    break
                time.sleep(0.05)
            assert rgm.info()[0]["runningQueries"] == 0
        finally:
            s.stop()

    def test_abandoned_queued_query_frees_queue_slot(self):
        """A canceled query that never got admitted must release its
        waiter so it cannot pin the resource-group queue."""
        from trino_tpu_torch.server.querymanager import QueryManager
        from trino_tpu_torch.server.resourcegroups import (
            GroupConfig,
            ResourceGroupManager,
            Selector,
        )
        from trino_tpu_torch.config import Session

        rgm = ResourceGroupManager(max_wait_seconds=30)
        rgm.configure(
            [GroupConfig("root", max_queued=10, hard_concurrency_limit=1)],
            [Selector(group="root")],
        )
        engine = SleepyEngine(1.0)
        qm = QueryManager(engine, resource_groups=rgm)
        qa = qm.create_query("select 1", Session())
        deadline = time.monotonic() + 2.0
        while (
            rgm.info()[0]["runningQueries"] == 0
            and time.monotonic() < deadline
        ):
            time.sleep(0.02)
        qb = qm.create_query("select 2", Session())
        deadline = time.monotonic() + 2.0
        while (
            rgm.info()[0]["queuedQueries"] == 0
            and time.monotonic() < deadline
        ):
            time.sleep(0.02)
        assert rgm.info()[0]["queuedQueries"] == 1
        qb.cancel()
        assert rgm.info()[0]["queuedQueries"] == 0
        assert qb.state.get().value == "CANCELED"
        qm.shutdown(wait=False)


class TestStreamingResults:
    def test_paged_bit_identical_and_buffer_bounded(self):
        from trino_tpu_torch.server.http import TrinoTpuServer

        budget = 8 << 10  # tiny page budget: forces many pages
        s = TrinoTpuServer(
            device="cpu",
            server_config=ServerConfig(result_page_max_bytes=budget)
        ).start()
        try:
            conn = Connection(s.base_uri)
            rows, _ = conn.execute("select o_orderkey from tpch.tiny.orders")
            assert len(rows) == 15000
            assert sorted(r[0] for r in rows) == sorted(
                set(r[0] for r in rows)
            )  # no dup/dropped rows
            # the pager really cut it into many bounded pages
            qs = [
                q for q in s.query_manager.queries()
                if "o_orderkey" in q.sql
            ]
            pager = qs[-1]._pager
            assert pager is not None
            assert pager.pages_produced >= 10
            assert pager.peak_buffered_bytes <= 3 * budget
        finally:
            s.stop()

    def test_streaming_matches_materialized_path(self):
        from trino_tpu_torch.server.http import TrinoTpuServer

        sql = (
            "select o_orderpriority, count(*) c from tpch.tiny.orders "
            "group by o_orderpriority order by o_orderpriority"
        )
        engine = Engine(device="cpu")
        streamed = TrinoTpuServer(
            engine=engine,
            server_config=ServerConfig(result_page_max_bytes=1 << 10),
        ).start()
        try:
            rows_streamed, _ = Connection(streamed.base_uri).execute(sql)
        finally:
            streamed.stop()
        legacy = TrinoTpuServer(
            engine=engine,
            server_config=ServerConfig(result_page_max_bytes=0),
        ).start()
        try:
            rows_legacy, _ = Connection(legacy.base_uri).execute(sql)
        finally:
            legacy.stop()
        assert rows_streamed == rows_legacy


class TestDrainUnderLoad:
    def test_no_admitted_query_dropped(self):
        """Draining under concurrent load: every query the server
        ACCEPTED (assigned a queryId) completes with its rows; late
        arrivals are refused with 503 — never half-served."""
        from trino_tpu_torch.server.http import TrinoTpuServer

        s = TrinoTpuServer(engine=SleepyEngine(0.2)).start()
        accepted: dict[int, list] = {}
        refused: list[int] = []
        errors: list = []
        lock = threading.Lock()

        def run(i):
            conn = Connection(
                s.base_uri, ClientSession(shed_retry_attempts=1)
            )
            try:
                rows, _ = conn.execute(f"select {i}")
                with lock:
                    accepted[i] = rows
            except urllib.error.HTTPError as e:
                with lock:
                    if e.code == 503:
                        refused.append(i)
                    else:
                        errors.append((i, e))
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append((i, e))

        threads = [
            threading.Thread(target=run, args=(i,)) for i in range(8)
        ]
        for t in threads[:4]:
            t.start()
        time.sleep(0.05)
        req = urllib.request.Request(
            f"{s.base_uri}/v1/info/state",
            data=b'"SHUTTING_DOWN"',
            method="PUT",
        )
        with urllib.request.urlopen(req, timeout=5) as r:
            assert r.status == 200
        for t in threads[4:]:
            t.start()
        for t in threads:
            t.join(30)
        assert not errors, f"non-shed failures during drain: {errors}"
        # the first wave was in flight before the drain began: all served
        for i, rows in accepted.items():
            assert rows == [(i,)], f"query {i} returned wrong rows"
        assert len(accepted) + len(refused) == 8
        assert accepted, "expected at least one in-flight query to finish"
