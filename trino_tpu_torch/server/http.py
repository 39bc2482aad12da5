"""HTTP server: client statement protocol + node endpoints.

Reference: ``dispatcher/QueuedStatementResource.java:93,171`` and
``server/protocol/ExecutingStatementResource.java:76,145`` (the two-phase
queued → executing nextUri protocol driven by
``client/trino-client/.../StatementClientV1.java:62,125,324``),
``QueryResource``, ``StatusResource``, ``ServerInfoResource`` and
``GracefulShutdownHandler.java:43`` (PUT /v1/info/state SHUTTING_DOWN).

Implementation: a non-blocking ``selectors`` event loop
(``server/eventloop.py``) instead of a thread per connection, mirroring
the reference's async HTTP stack: idle ``nextUri`` pollers cost a parked
:class:`Responder` each, long-poll ``maxWait`` waits are loop timers +
state-machine listeners, and handler work that must block (engine
dispatch, task creation, spool IO) runs on a bounded ``_DispatchPool``
with completion callbacks back onto the loop.  The robustness layer on
top: per-tenant token-bucket rate limits, a global in-flight ceiling
(over-limit requests shed with ``503 + Retry-After`` and counted in
``trino_tpu_requests_shed_total{reason}``), client-abandonment reaping
(a query whose ``nextUri`` goes unpolled past ``client_timeout_s`` is
canceled and its admission slot freed), and byte-budgeted streaming
result pages with producer backpressure.

A copy of ``trino_tpu/server/http.py`` for the coordinator role on one
engine, and for the worker role. The statement protocol, the node,
query, resource-group and metrics endpoints, shedding, draining and the
web UI are served as the reference serves them, and so are the repeat and
post-mortem tiers (``/v1/history``, ``/v1/cache``, ``/v1/slo``,
``/v1/query/{id}/flight``) and the cluster tier: worker tasks and their
results (``/v1/task``), spooled pages (``/v1/spool``), scaled-writer pages
(``/v1/write``), discovery and announcements (``/v1/discovery``,
``/v1/announce``, the worker's announce loop) and a worker's graceful
drain (``PUT /v1/info/state``), and SPMD: with ``spmd=True`` the server
builds a ``parallel/spmd.py::SpmdRunner`` over the group its process
joined (``server/main.py``, ``--spmd-*``) and ``POST /v1/spmd`` runs the
two phases of a query a coordinator prepares and commits; a server
without it answers 400, as the reference's does.
"""

from __future__ import annotations

import json
import math
import threading
import time
import urllib.parse
from decimal import Decimal
from typing import Any, Callable, Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.config import ServerConfig, Session
from trino_tpu_torch.engine import Engine
from trino_tpu_torch.server.eventloop import (
    EventLoopHttpServer,
    Request,
    Responder,
    Response,
    TenantRateLimiter,
    json_response,
    parse_max_wait,
)
from trino_tpu_torch.server.querymanager import (
    ManagedQuery,
    QueryManager,
    _DispatchPool,
)
from trino_tpu_torch.server.statemachine import (
    QueryState,
    TERMINAL_QUERY_STATES,
)

PAGE_ROWS = 4096  # rows per protocol page (reference: target result bytes)
PROTOCOL_HEADER = "X-Trino"
VERSION = "trino-tpu-0.1 (356-compatible)"

def _json_rows(rows, decimal_columns: list[int]) -> list[list]:
    """Rows as JSON lists, each ``Decimal`` value as its text (the
    reference's ``_json_value``, which converts nothing else, applied to
    the DECIMAL columns: no other column holds a ``Decimal``)."""
    out = [list(row) for row in rows]
    for i in decimal_columns:  # a column at a time: no call a row
        for row in out:
            v = row[i]
            if isinstance(v, Decimal):
                row[i] = str(v)
    return out


# task/spool long-polls re-check on the loop at this cadence instead of
# parking a thread in the buffer's condition wait
_TASK_POLL_S = 0.015

class TrinoTpuServer:
    """Coordinator server wrapping Engine + QueryManager.

    The same class serves coordinator and worker roles, mirroring the
    reference's single binary with ``coordinator=true/false``.
    ``TrinoTpuServer()`` builds ``Engine(device=device)``: on ``cuda``
    unless ``device`` names another, raising where there is no GPU, as
    ``Engine()`` does. ``spmd=True`` runs fusable cluster queries SPMD
    over the process group this process joined (reference ``:108-130``).
    """

    def __init__(
        self,
        engine: Optional[Engine] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_concurrent: int = 16,
        resource_groups=None,
        role: str = "coordinator",
        node_id: Optional[str] = None,
        discovery_uri: Optional[str] = None,
        spmd: bool = False,
        cluster_memory_limit_bytes: Optional[int] = None,
        server_config: Optional[ServerConfig] = None,
        device=None,
    ):
        from trino_tpu_torch.obs.trace import InMemorySpanSink, get_tracer
        from trino_tpu_torch.server.resourcegroups import ResourceGroupManager
        from trino_tpu_torch.server.task import SqlTaskManager

        self.engine = engine or Engine(device=device)
        self.server_config = server_config or ServerConfig()
        # registering a sink is what turns tracing ON for this process;
        # a bare Engine (no server) stays dark and pays nothing
        self.span_sink = InMemorySpanSink()
        get_tracer().add_sink(self.span_sink)
        self.role = role
        self.node_id = node_id or f"{role}-{port}"
        # tasks need the node identity for delay-fault targeting
        # (ft/injection.py is_slow_node) and task-span attribution
        self.engine.node_id = self.node_id
        self.discovery_uri = discovery_uri
        self.resource_groups = resource_groups or ResourceGroupManager()
        # the device-memory gate reads the engine's card
        self.resource_groups.device = self.engine.device
        # every node can run tasks (reference: same binary, coordinator=true/false)
        self.task_manager = SqlTaskManager(self.engine)
        self.node_manager = None
        self.spmd = None
        if spmd:
            from trino_tpu_torch.parallel.spmd import SpmdRunner

            self.spmd = SpmdRunner(self.engine)
            self.engine.spmd = self.spmd
        if role == "coordinator":
            from trino_tpu_torch.server.cluster import ClusterNodeManager, ClusterScheduler

            self.node_manager = ClusterNodeManager()
            self.engine.cluster_scheduler = ClusterScheduler(
                self.engine, self.node_manager
            )
            if self.spmd is not None:
                self.engine.spmd_peers = lambda: [
                    n.uri for n in self.node_manager.active_nodes()
                ]
        self.cluster_memory_manager = None
        if role == "coordinator":
            from trino_tpu_torch.memory import ClusterMemoryManager

            self.cluster_memory_manager = ClusterMemoryManager(
                self.engine.memory_pool,
                cluster_memory_limit_bytes or (64 << 30),
                kill_fn=lambda qid, msg: self.query_manager.kill(qid, msg),
            )
        # event-driven admission: queries queue as resource-group waiters
        # (no parked thread per QUEUED query) and run on a bounded pool
        self.query_manager = QueryManager(
            self.engine,
            max_concurrent,
            resource_groups=self.resource_groups,
        )
        self.start_time = time.time()
        self.state = "ACTIVE"  # ACTIVE | SHUTTING_DOWN (NodeState)
        cfg = self.server_config
        self.httpd = EventLoopHttpServer(
            host,
            port,
            self._handle_request,
            max_connections=cfg.max_connections,
            read_timeout_s=cfg.read_timeout_s,
            idle_timeout_s=cfg.idle_timeout_s,
            write_timeout_s=cfg.write_timeout_s,
            on_shed=lambda reason: self._count_shed(reason),
        )
        self.host, self.port = self.httpd.server_address[:2]
        # bounded workers for handler stages that must block (engine
        # dispatch, SqlTask creation, spool/connector IO) — the loop
        # thread itself never blocks
        self._front_pool = _DispatchPool(cfg.blocking_pool_size, name="http")
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._rate_limiter = TenantRateLimiter(
            cfg.tenant_rate_limit_qps, cfg.tenant_rate_limit_burst
        )
        if role == "coordinator":
            # where workers spool finished output buffers (the scheduler
            # passes this to tasks as payload["spool"]["uri"])
            self.engine.spool_base_uri = self.base_uri
        self._announce_thread: Optional[threading.Thread] = None
        # shutdown sentinel for the announce thread: stop() sets it, so the
        # thread exits immediately instead of finishing a sleep that can be
        # a 10s backoff (and the state-flag check alone can't interrupt)
        self._announce_stop = threading.Event()
        # live node info for system.runtime.nodes
        self.engine._runtime_nodes_fn = lambda: [
            ("coordinator", self.base_uri, VERSION, True, self.state)
        ]
        # live task registry for system.runtime.tasks (this node's
        # SqlTaskManager — on a coordinator that includes any local tasks)
        self.engine._runtime_tasks_fn = lambda: [
            t.info() for t in self.task_manager.tasks()
        ]

    # --- lifecycle --------------------------------------------------------

    def start(self) -> "TrinoTpuServer":
        self.httpd.start()
        interval = min(
            1.0, max(0.05, self.server_config.client_timeout_s / 4.0)
        )
        self.httpd.loop.call_later(interval, self._housekeep, interval)
        if self.role == "worker" and self.discovery_uri:
            self._announce_thread = threading.Thread(
                target=self._announce_loop, daemon=True
            )
            self._announce_thread.start()
        return self

    def _housekeep(self, interval: float) -> None:
        """Periodic loop-side maintenance: reap queries whose client
        vanished (unpolled past client_timeout_s) and publish edge gauges."""
        if self.state == "STOPPED":
            return
        try:
            self.query_manager.expire_abandoned(
                self.server_config.client_timeout_s
            )
        except Exception:  # noqa: BLE001 — maintenance must not die
            pass
        try:
            from trino_tpu_torch.obs.metrics import get_registry

            reg = get_registry()
            reg.gauge("trino_tpu_http_open_connections").set(
                self.httpd.connection_count
            )
            reg.gauge("trino_tpu_http_inflight_requests").set(self._inflight)
        except Exception:  # noqa: BLE001
            pass
        self.httpd.loop.call_later(interval, self._housekeep, interval)

    def _announce_loop(self) -> None:
        """Periodic worker announcement to the coordinator's embedded
        discovery (reference: airlift discovery announcer). Failures back
        off exponentially (deterministic jitter) instead of hammering a
        coordinator that is not up yet."""
        import urllib.request as _rq

        from trino_tpu_torch.ft.retry import Backoff

        backoff = Backoff(initial_ms=500.0, max_ms=10_000.0, seed=0)
        failures = 0
        while self.state == "ACTIVE" and not self._announce_stop.is_set():
            delay = 2.0
            if self.discovery_uri and not self.discovery_uri.startswith("@"):
                try:
                    from trino_tpu_torch.server import auth

                    pool = self.engine.memory_pool
                    with pool._lock:
                        reservations = dict(pool._query_reserved)
                    body = json.dumps(
                        {
                            "nodeId": self.node_id,
                            "uri": self.base_uri,
                            "memoryInfo": {
                                "capacityBytes": pool.capacity,
                                "reservedBytes": sum(reservations.values()),
                                "queryReservations": reservations,
                            },
                        }
                    ).encode()
                    req = _rq.Request(
                        f"{self.discovery_uri}/v1/announce",
                        data=body,
                        method="PUT",
                        headers=auth.headers(),
                    )
                    _rq.urlopen(
                        req, timeout=self.server_config.http_request_timeout_s
                    )
                    failures = 0
                except Exception:  # noqa: BLE001 — coordinator may not be up yet
                    failures += 1
                    delay = backoff.delay(min(failures, 8))
            if self._announce_stop.wait(delay):
                return

    def stop(self) -> None:
        from trino_tpu_torch.obs.trace import get_tracer

        self._announce_stop.set()
        self.state = "STOPPED"
        self.httpd.close()
        self._front_pool.shutdown()
        self.query_manager.shutdown(wait=False)
        get_tracer().remove_sink(self.span_sink)

    def graceful_shutdown(self) -> None:
        """Drain, then stop (GracefulShutdownHandler.java:142).

        Coordinator: refuse new queries (shed 503), wait for active ones.
        Worker decommission: refuse new tasks (task POST 503s while not
        ACTIVE), finish running tasks, force-publish every retained
        buffer's spool manifest so consumers can re-read the output after
        this process is gone, deregister from the coordinator, and exit —
        the rolling-restart path with zero query failures."""
        self.state = "SHUTTING_DOWN"
        drain = self._drain_worker if self.role == "worker" else self._drain
        threading.Thread(target=drain, daemon=True).start()



    def _drain(self) -> None:
        while any(
            not q.state.is_terminal() for q in self.query_manager.queries()
        ):
            time.sleep(0.05)
        # grace: let clients pull the final result pages of queries that
        # just reached a terminal state before the socket closes
        time.sleep(self.server_config.drain_grace_s)
        self.stop()

    def _drain_worker(self, timeout: Optional[float] = None) -> None:
        cfg = self.server_config
        if timeout is None:
            timeout = cfg.drain_timeout_s
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and any(
            t.state == "RUNNING" for t in self.task_manager.tasks()
        ):
            time.sleep(0.05)
        # force-spool retained buffers: a consumer stage that has not yet
        # pulled this worker's output reads it from the coordinator's
        # spool once we are gone (finish() is idempotent — tasks that
        # already published on FINISHED return their cached result).
        # A fused-unit task is no different: its single retained buffer
        # IS the unit-boundary output, so the whole unit stays readable
        for t in self.task_manager.tasks():
            writer = getattr(t.buffer, "spool_writer", None)
            if writer is not None and t.state == "FINISHED":
                try:
                    writer.finish(timeout=cfg.spool_finish_timeout_s)
                except Exception:  # noqa: BLE001 — best-effort
                    pass
        if self.discovery_uri and not self.discovery_uri.startswith("@"):
            import urllib.request as _rq

            from trino_tpu_torch.server import auth

            try:
                req = _rq.Request(
                    f"{self.discovery_uri}/v1/announce/{self.node_id}",
                    method="DELETE",
                    headers=auth.headers(),
                )
                _rq.urlopen(req, timeout=cfg.http_request_timeout_s)
            except Exception:  # noqa: BLE001 — coordinator may be gone too
                pass
        # grace: let in-flight result GETs finish before the socket closes
        time.sleep(cfg.drain_grace_s)
        self.stop()

    @property
    def base_uri(self) -> str:
        return f"http://{self.host}:{self.port}"

    # --- protocol helpers -------------------------------------------------

    def query_results(self, q: ManagedQuery, phase: str, token: int) -> dict:
        state = q.state.get()
        uri = f"{self.base_uri}/v1/statement"
        out: dict[str, Any] = {
            "id": q.query_id,
            "infoUri": f"{self.base_uri}/v1/query/{q.query_id}",
            "warnings": [],
        }
        stats = {
            "state": state.value,
            "queued": state == QueryState.QUEUED,
            "scheduled": state
            in (QueryState.RUNNING, QueryState.FINISHING, QueryState.FINISHED),
            "nodes": 1,
            "elapsedTimeMillis": int(
                ((q.end_time or time.time()) - q.create_time) * 1000
            ),
            "peakMemoryBytes": q.result.peak_memory_bytes if q.result else 0,
        }
        out["stats"] = stats

        if state == QueryState.FAILED or state == QueryState.CANCELED:
            out["error"] = (q.error.to_json() if q.error else
                            {"message": "query failed", "errorCode": 65536,
                             "errorName": "GENERIC_INTERNAL_ERROR",
                             "errorType": "INTERNAL_ERROR"})
            return out

        if phase == "queued":
            if state in (QueryState.QUEUED, QueryState.PLANNING):
                out["nextUri"] = f"{uri}/queued/{q.query_id}/{q.slug}/{token}"
            else:
                out["nextUri"] = f"{uri}/executing/{q.query_id}/{q.slug}/0"
            return out

        # executing phase: page through buffered results
        if q.result is None:  # still running
            out["nextUri"] = f"{uri}/executing/{q.query_id}/{q.slug}/{token}"
            return out
        res = q.result
        out["columns"] = [
            {
                "name": n,
                "type": str(ty),
                "typeSignature": {"rawType": _raw_type(ty), "arguments": []},
            }
            for n, ty in zip(res.column_names, res.column_types)
        ]
        if res.update_type is not None:
            out["updateType"] = res.update_type
        if res.update_count is not None:
            out["updateCount"] = res.update_count
        budget = int(self.server_config.result_page_max_bytes or 0)
        decimals = [i for i, ty in enumerate(res.column_types)
                    if isinstance(ty, T.DecimalType)]
        if budget > 0:
            # streaming pager: pages cut on demand by byte budget; acked
            # pages are freed, so peak serving buffer stays bounded
            pager = q.result_pager(budget, PAGE_ROWS)
            rows, more = pager.page(token)
            if rows is not None:
                out["data"] = _json_rows(rows, decimals)
            if more:
                out["nextUri"] = (
                    f"{uri}/executing/{q.query_id}/{q.slug}/{token + 1}"
                )
            else:
                out["partialCancelUri"] = None
        else:
            # legacy fixed-row paging over the materialized result
            lo = token * PAGE_ROWS
            hi = min(lo + PAGE_ROWS, len(res.rows))
            if lo < len(res.rows):
                out["data"] = _json_rows(res.rows[lo:hi], decimals)
            if hi < len(res.rows):
                out["nextUri"] = (
                    f"{uri}/executing/{q.query_id}/{q.slug}/{token + 1}"
                )
            else:
                out["partialCancelUri"] = None
        if res.set_session:
            out["_setSession"] = {k: v for k, v in res.set_session.items()}
        if res.added_prepare is not None:
            out["_addedPrepare"] = res.added_prepare
        if res.deallocated_prepare is not None:
            out["_deallocatedPrepare"] = res.deallocated_prepare
        if res.started_transaction_id:
            out["_startedTransaction"] = res.started_transaction_id
        if res.cleared_transaction:
            out["_clearedTransaction"] = True
        return out

    # --- serving edge: shedding + offload ---------------------------------

    def _count_shed(self, reason: str) -> None:
        try:
            from trino_tpu_torch.obs.metrics import get_registry

            get_registry().counter(
                "trino_tpu_requests_shed_total", reason=reason
            ).inc()
        except Exception:  # noqa: BLE001
            pass

    def _shed(
        self,
        responder: Responder,
        reason: str,
        message: str,
        retry_after_s: Optional[float] = None,
    ) -> None:
        """503 the request. Overload sheds carry Retry-After (clients
        back off and retry); drain sheds do not (this server is going
        away — retrying it is pointless)."""
        self._count_shed(reason)
        headers = None
        if retry_after_s is not None:
            headers = {"Retry-After": str(max(1, math.ceil(retry_after_s)))}
        responder.respond(
            json_response({"error": message}, 503, headers=headers)
        )

    def _offload(self, responder: Responder, work: Callable[[], Response],
                 ceiling: bool = True) -> None:
        """Run ``work`` on the blocking pool, responding with its result.
        ``ceiling=True`` (client-facing requests) enforces the global
        in-flight ceiling and sheds the excess; the flight journal's
        replay and internal cluster traffic (tasks, spool, announce)
        bypass it — shedding those would fail admitted queries."""
        cfg = self.server_config
        with self._inflight_lock:
            shed = ceiling and self._inflight >= cfg.max_inflight_requests
            if not shed:
                self._inflight += 1
        if shed:
            return self._shed(
                responder,
                "inflight",
                "too many requests in flight",
                retry_after_s=cfg.shed_retry_after_s,
            )
        self._offload_submit(responder, work)

    def _offload_submit(
        self, responder: Responder, work: Callable[[], Response]
    ) -> None:
        def run() -> None:
            resp: Optional[Response] = None
            try:
                resp = work()
            except Exception as e:  # noqa: BLE001
                resp = json_response({"error": f"internal error: {e}"}, 500)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1
            responder.respond(resp)

        try:
            self._front_pool.submit(run)
        except RuntimeError:  # pool shut down mid-flight
            with self._inflight_lock:
                self._inflight -= 1
            self._shed(responder, "draining", "server is shutting down")

    # --- request handling (loop thread) -----------------------------------

    def _handle_request(self, request: Request, responder: Responder) -> None:
        from trino_tpu_torch.server import auth

        parsed = urllib.parse.urlparse(request.target)
        path = parsed.path
        if auth.is_internal_path(path) and not auth.authorized(request.headers):
            responder.respond(
                json_response(
                    {"error": "missing or invalid internal credential"}, 401
                )
            )
            return
        try:
            self._route(request, responder, path, parsed)
        except Exception as e:  # noqa: BLE001 — a route bug must not kill the loop
            responder.respond(
                json_response({"error": f"internal error: {e}"}, 500)
            )

    def _route(
        self,
        request: Request,
        responder: Responder,
        path: str,
        parsed,
    ) -> None:
        method = request.method
        parts = [p for p in path.split("/") if p]
        qs = urllib.parse.parse_qs(parsed.query)
        if method == "POST":
            return self._route_post(request, responder, path, parts, qs)
        if method == "GET":
            return self._route_get(request, responder, path, parts, qs)
        if method == "DELETE":
            return self._route_delete(request, responder, path, parts, qs)
        if method == "PUT":
            return self._route_put(request, responder, path, parts, qs)
        responder.respond(
            json_response({"error": f"unsupported method: {method}"}, 405)
        )

    # --- POST -------------------------------------------------------------

    def _route_post(self, request, responder, path, parts, qs) -> None:
        if path == "/v1/statement":
            if self.state != "ACTIVE":
                return self._shed(
                    responder, "draining", "server is shutting down"
                )
            user = request.headers.get(
                f"{PROTOCOL_HEADER}-User", "anonymous"
            ) or "anonymous"
            retry_in = self._rate_limiter.try_acquire(user)
            if retry_in > 0:
                return self._shed(
                    responder,
                    "tenant_rate_limit",
                    f"rate limit exceeded for user '{user}'",
                    retry_after_s=retry_in,
                )

            def create() -> Response:
                sql = request.body.decode()
                if not sql.strip():
                    return json_response(
                        {"error": "SQL statement is empty"}, 400
                    )
                from trino_tpu_torch.transaction import TransactionError

                try:
                    session = _session_from_headers(
                        self.engine, request.headers
                    )
                except TransactionError as e:
                    return json_response({"error": str(e)}, 400)
                q = self.query_manager.create_query(sql, session)
                return json_response(self.query_results(q, "queued", 0))

            return self._offload(responder, create)
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            # TaskResource.createOrUpdateTask (reference :127)
            if self.state != "ACTIVE":
                # draining worker: refuse admission; the coordinator
                # classifies the 503 retryable and re-dispatches the
                # attempt to another node
                return self._shed(
                    responder, "draining", "worker is shutting down"
                )
            from trino_tpu_torch.obs.trace import TRACE_HEADER, parse_trace_header

            trace = parse_trace_header(request.headers.get(TRACE_HEADER))

            def create_task() -> Response:
                payload = json.loads(request.body.decode())
                task = self.task_manager.create_or_update(
                    parts[2], payload, trace=trace
                )
                return json_response(task.info())

            return self._offload(responder, create_task, ceiling=False)
        if path == "/v1/write":
            # scaled-writer data plane: binary serialized batch in the
            # body, target table in query params; the connector appends
            # a part file on shared storage (reference: TableWriter
            # tasks under ScaledWriterScheduler)
            def write() -> Response:
                try:
                    from trino_tpu_torch.serde import deserialize_batch

                    batch = deserialize_batch(request.body)
                    conn = self.engine.catalogs.get(qs["catalog"][0])
                    part = ""
                    if hasattr(conn, "insert_part"):
                        # ?pending=true: a staged part that the
                        # coordinator commits once every writer is done
                        # (connectors/file.py::commit_parts)
                        pending = qs.get("pending", [""])[0] == "true"
                        kw = {"pending": True} if pending else {}
                        n, part = conn.insert_part(
                            qs["schema"][0], qs["table"][0], batch, **kw
                        )
                    else:
                        n = conn.insert(qs["schema"][0], qs["table"][0], batch)
                    # part name lets the coordinator roll back committed
                    # parts when a sibling scaled writer fails
                    return json_response({"rows": n, "part": part})
                except Exception as e:  # noqa: BLE001
                    return json_response({"error": f"write failed: {e}"}, 400)

            return self._offload(responder, write, ceiling=False)
        if path == "/v1/spmd":
            if self.spmd is None:
                return responder.respond(
                    json_response({"error": "spmd mode not enabled"}, 400)
                )

            def run_spmd() -> Response:
                payload = json.loads(request.body.decode())
                return json_response(self.spmd.execute_remote(payload))

            # a commit blocks until its slot's turn and run
            return self._offload(responder, run_spmd, ceiling=False)
        if len(parts) == 3 and parts[:2] == ["v1", "spool"]:
            # spooled exchange: a worker POSTs one finished-output page
            # (raw bytes; idempotent per (task, partition, seq))
            def put_page() -> Response:
                from trino_tpu_torch.exchange.spool import get_spool_store

                store = get_spool_store(self.engine)
                accepted = store.put_page(
                    qs.get("query", [""])[0],
                    parts[2],
                    int(qs.get("partition", ["0"])[0]),
                    int(qs.get("seq", ["0"])[0]),
                    request.body,
                )
                return json_response({"accepted": accepted})

            return self._offload(responder, put_page, ceiling=False)
        responder.respond(json_response({"error": f"unknown path: {path}"}, 404))

    # --- GET --------------------------------------------------------------

    def _route_get(self, request, responder, path, parts, qs) -> None:
        if path == "/v1/info":
            return responder.respond(json_response(
                {
                    "nodeVersion": {"version": VERSION},
                    "environment": "gpu",
                    "coordinator": True,
                    "starting": False,
                    "uptime": f"{time.time() - self.start_time:.2f}s",
                }
            ))
        if path == "/v1/memory":
            if self.cluster_memory_manager is None:
                return responder.respond(
                    json_response({"error": "not a coordinator"}, 404)
                )
            return responder.respond(
                json_response(self.cluster_memory_manager.info())
            )
        if path == "/v1/info/state":
            return responder.respond(json_response(self.state))
        if path == "/v1/status":
            pool = self.engine.memory_pool
            return responder.respond(json_response(
                {
                    "nodeId": "coordinator",
                    "nodeVersion": VERSION,
                    "state": self.state,
                    "coordinator": True,
                    "memoryInfo": {
                        "totalNodeMemory": pool.capacity,
                        "reservedBytes": pool.reserved,
                        "freeBytes": pool.free_bytes,
                    },
                    "queries": len(self.query_manager.queries()),
                    # system.runtime.queries-style admission breakdown
                    # (the knee is visible without running the bench)
                    "queryCounts": self.query_manager.state_counts(),
                    "resourceGroups": self.resource_groups.summary(),
                }
            ))
        if path in ("/ui", "/ui/", "/"):
            from trino_tpu_torch.server.webui import PAGE

            return responder.respond(Response(
                200, PAGE.encode(), "text/html; charset=utf-8"
            ))
        if path == "/v1/resourceGroup":
            return responder.respond(
                json_response(self.resource_groups.info())
            )
        if path == "/v1/task":
            return responder.respond(json_response(
                [t.info() for t in self.task_manager.tasks()]
            ))
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            # task status, optional long-poll (?maxWait=seconds) — a loop
            # timer re-checks instead of parking a thread
            task = self.task_manager.get(parts[2])
            if task is None:
                return responder.respond(
                    json_response({"error": "task not found"}, 404)
                )
            max_wait = parse_max_wait(qs.get("maxWait", ["0"])[0], default=0.0)
            deadline = time.monotonic() + max_wait
            return self._task_status_poll(responder, task, deadline)
        if (
            len(parts) == 6
            and parts[:2] == ["v1", "task"]
            and parts[3] == "results"
        ):
            # GET /v1/task/{id}/results/{partition}/{token}[?maxWait=s]
            # (TaskResource.java:261 paged binary fetch)
            task = self.task_manager.get(parts[2])
            if task is None:
                return responder.respond(
                    json_response({"error": "task not found"}, 404)
                )
            max_wait = parse_max_wait(
                qs.get("maxWait", ["1.0"])[0], default=1.0
            )
            deadline = time.monotonic() + max_wait
            return self._task_results_poll(
                responder, task, int(parts[4]), int(parts[5]), deadline
            )
        if (
            len(parts) == 6
            and parts[:2] == ["v1", "spool"]
            and parts[3] == "results"
        ):
            # GET /v1/spool/{taskId}/results/{partition}/{token} — the
            # exact task-results wire shape, so ExchangeClient pulls a
            # spool URI exactly like a live worker's buffer
            def read_spool() -> Response:
                store = getattr(self.engine, "spool_store", None)
                out = (
                    store.read(parts[2], int(parts[4]), int(parts[5]))
                    if store is not None
                    else None
                )
                if out is None:
                    return json_response(
                        {"error": "spooled task not found"}, 404
                    )
                return json_response(out)

            return self._offload(responder, read_spool, ceiling=False)
        if path == "/v1/spool":
            store = getattr(self.engine, "spool_store", None)
            return responder.respond(json_response(
                store.stats() if store is not None else {}
            ))
        if path == "/v1/node":
            if self.node_manager is None:
                return responder.respond(json_response([]))
            return responder.respond(json_response(
                {
                    "nodes": [
                        n.to_json() for n in self.node_manager.all_nodes()
                    ],
                    "failureInfo": (
                        self.node_manager.failure_detector.info()
                    ),
                }
            ))
        if path == "/v1/metrics":
            # Prometheus text scrape (text format 0.0.4); ?format=json
            # returns the structured snapshot for bench/chaos embeds
            from trino_tpu_torch.obs.metrics import get_registry

            if qs.get("format", [""])[0] == "json":
                return responder.respond(
                    json_response(get_registry().snapshot())
                )
            return responder.respond(Response(
                200,
                get_registry().render_prometheus().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            ))
        if path == "/v1/history":
            # per-fingerprint observed execution truth (obs/history.py):
            # one entry a store the engine resolved, most recently used
            # fingerprints first
            snap_fn = getattr(self.engine, "history_snapshot", None)
            return responder.respond(json_response(
                snap_fn() if callable(snap_fn) else {"stores": []}
            ))
        if path == "/v1/cache":
            # the result cache's entries, byte budget and counters; a
            # brief lock only, as /v1/metrics
            rc = getattr(self.engine, "result_cache", None)
            return responder.respond(json_response(
                rc.snapshot() if rc is not None else {"entries": []}
            ))
        if path == "/v1/slo":
            # the SLO sentinel's regressed fingerprints and counters
            from trino_tpu_torch.obs.slo import get_sentinel

            return responder.respond(json_response(get_sentinel().snapshot()))
        if path == "/v1/query":
            return responder.respond(json_response(
                [q.info() for q in self.query_manager.queries()]
            ))
        if (
            len(parts) == 4
            and parts[:2] == ["v1", "query"]
            and parts[3] == "timeline"
        ):
            # span dump for one trace (= query id). Workers hold spans
            # for queries they never registered, so 404 only when the
            # id is unknown to BOTH the query manager and the sink.
            spans = self.span_sink.spans_for(parts[2])
            if not spans and self.query_manager.get(parts[2]) is None:
                return responder.respond(
                    json_response({"error": "query not found"}, 404)
                )
            return responder.respond(
                json_response({"queryId": parts[2], "spans": spans})
            )
        if len(parts) == 4 and parts[:2] == ["v1", "query"] and parts[3] == "flight":
            # the flight journal's replay of one query (obs/flight.py). A
            # restarted coordinator serves the pre-crash journal through
            # ?dir= (its query registry is gone, so no 404 gating on the
            # query manager). The replay flushes and reads files: off the
            # loop thread
            qid = parts[2]
            directory = qs.get("dir", [""])[0]

            def read_flight() -> Response:
                from trino_tpu_torch.obs import flight as flight_mod

                events = flight_mod.replay_known(qid, directory or None)
                if not events and self.query_manager.get(qid) is None:
                    return json_response(
                        {"error": "no flight records for query"}, 404
                    )
                return json_response({"queryId": qid, "events": events})

            return self._offload(responder, read_flight, ceiling=False)
        if len(parts) == 3 and parts[:2] == ["v1", "query"]:
            q = self.query_manager.get(parts[2])
            if q is None:
                return responder.respond(
                    json_response({"error": "query not found"}, 404)
                )
            return responder.respond(json_response(q.info()))
        if len(parts) == 6 and parts[:2] == ["v1", "statement"]:
            phase, qid, slug, token = parts[2], parts[3], parts[4], parts[5]
            q = self.query_manager.get(qid)
            if q is None or q.slug != slug:
                return responder.respond(
                    json_response({"error": "query not found"}, 404)
                )
            return self._statement_poll(
                request, responder, q, phase, int(token)
            )
        responder.respond(json_response({"error": f"unknown path: {path}"}, 404))

    # --- DELETE -----------------------------------------------------------

    def _route_delete(self, request, responder, path, parts, qs) -> None:
        if len(parts) >= 5 and parts[:2] == ["v1", "statement"]:
            qid, slug = parts[3], parts[4]
            q = self.query_manager.get(qid)
            if q is None or q.slug != slug:  # slug = per-query secret
                return responder.respond(
                    json_response({"error": "query not found"}, 404)
                )
            q.cancel()
            return responder.respond(Response(204))
        if len(parts) == 3 and parts[:2] == ["v1", "query"]:
            if self.query_manager.cancel(parts[2]):
                return responder.respond(Response(204))
            return responder.respond(
                json_response({"error": "query not found"}, 404)
            )
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            # ?speculative=true marks a hedged-attempt loser: the state
            # machine records CANCELED_SPECULATIVE instead of CANCELED
            speculative = qs.get("speculative", [""])[0] == "true"
            if self.task_manager.cancel(parts[2], speculative=speculative):
                return responder.respond(Response(204))
            return responder.respond(
                json_response({"error": "task not found"}, 404)
            )
        if len(parts) == 3 and parts[:2] == ["v1", "spool"]:
            # aborted spool write / cancelled attempt: drop its pages
            store = getattr(self.engine, "spool_store", None)
            if store is not None:
                store.delete_task(parts[2])
            return responder.respond(Response(204))
        if len(parts) == 3 and parts[:2] == ["v1", "announce"]:
            # worker decommission: deregister from discovery AND the
            # failure detector (a drained node must not be pinged or
            # counted failed afterwards)
            if self.node_manager is None:
                return responder.respond(
                    json_response({"error": "not a coordinator"}, 400)
                )
            self.node_manager.decommission(parts[2])
            return responder.respond(Response(204))
        responder.respond(json_response({"error": f"unknown path: {path}"}, 404))

    # --- PUT --------------------------------------------------------------

    def _route_put(self, request, responder, path, parts, qs) -> None:
        if path == "/v1/discovery":
            # late discovery injection (SPMD boot: the coordinator's
            # HTTP port is unknown until every rank joins the mesh)
            body = json.loads(request.body.decode())
            self.discovery_uri = body["uri"]
            return responder.respond(json_response({"ok": True}))
        if path == "/v1/announce":
            # embedded discovery: workers announce themselves
            if self.node_manager is None:
                return responder.respond(
                    json_response({"error": "not a coordinator"}, 400)
                )
            body = json.loads(request.body.decode())
            self.node_manager.announce(body["nodeId"], body["uri"])
            if self.cluster_memory_manager is not None:
                self.cluster_memory_manager.update(
                    body["nodeId"], body.get("memoryInfo")
                )
            return responder.respond(json_response({"ok": True}))
        if path == "/v1/info/state":
            body = request.body.decode().strip().strip('"')
            if body == "SHUTTING_DOWN":
                self.graceful_shutdown()
                return responder.respond(json_response({}, 200))
            return responder.respond(
                json_response({"error": f"unsupported state: {body}"}, 400)
            )
        if (
            len(parts) == 4
            and parts[:2] == ["v1", "spool"]
            and parts[3] == "complete"
        ):
            # spool completion manifest: {queryId, partitions: {p: n}}
            def complete() -> Response:
                from trino_tpu_torch.exchange.spool import get_spool_store

                body = json.loads(request.body.decode())
                store = get_spool_store(self.engine)
                ok = store.complete(
                    parts[2],
                    body.get("queryId", ""),
                    {
                        int(p): int(n)
                        for p, n in body.get("partitions", {}).items()
                    },
                )
                return json_response({"complete": ok})

            return self._offload(responder, complete, ceiling=False)
        responder.respond(json_response({"error": f"unknown path: {path}"}, 404))

    def _task_status_poll(self, responder, task, deadline: float) -> None:
        if responder.done or not responder.connected:
            return
        if task.state != "RUNNING" or time.monotonic() >= deadline:
            return responder.respond(json_response(task.info()))
        self.httpd.loop.call_later(
            0.02, self._task_status_poll, responder, task, deadline
        )

    def _task_results_poll(
        self, responder, task, partition: int, token: int, deadline: float
    ) -> None:
        if responder.done or not responder.connected:
            return
        # max_wait=0 makes the buffer read non-blocking: pages below the
        # token are acked, available pages return immediately
        out = task.results(partition, token, max_wait=0.0)
        if (
            out.get("pages")
            or out.get("complete")
            or out.get("failed")
            or time.monotonic() >= deadline
        ):
            return responder.respond(json_response(out))
        self.httpd.loop.call_later(
            _TASK_POLL_S,
            self._task_results_poll,
            responder, task, partition, token, deadline,
        )

    # --- long-polls (loop-driven, no parked threads) ----------------------

    def _statement_poll(
        self,
        request: Request,
        responder: Responder,
        q: ManagedQuery,
        phase: str,
        token: int,
    ) -> None:
        """Statement nextUri GET: park the responder on the query's state
        machine. A state transition satisfying the phase predicate (or
        the maxWait timer) responds; no thread waits anywhere."""
        q.touch()
        max_wait = parse_max_wait(
            _parse_duration(
                request.headers.get(f"{PROTOCOL_HEADER}-Max-Wait", "1s")
                or "1s"
            ),
            default=1.0,
        )
        if phase == "queued":
            def pred(s) -> bool:
                return s not in (QueryState.QUEUED, QueryState.PLANNING)
        else:
            def pred(s) -> bool:
                return q.result is not None or s in TERMINAL_QUERY_STATES

        loop = self.httpd.loop

        def finish() -> None:
            # one-shot via responder; both the listener and the timer may
            # race here — remove/cancel are idempotent
            timer.cancel()
            q.state.remove_listener(listener)
            if responder.done:
                return
            q.touch()
            try:
                out = self.query_results(q, phase, token)
            except Exception as e:  # noqa: BLE001
                responder.respond(
                    json_response({"error": f"internal error: {e}"}, 500)
                )
                return
            responder.respond(_statement_response(out))

        timer = loop.call_later(max_wait, finish)

        def listener(s) -> None:
            if pred(s):
                loop.call_soon(finish)

        q.state.add_listener(listener)


def _statement_response(out: dict) -> Response:
    """Pop the session-mutation fields into their response headers."""
    headers: dict[str, str] = {}
    set_session = out.pop("_setSession", None)
    if set_session:
        for k, v in set_session.items():
            headers[f"{PROTOCOL_HEADER}-Set-Session"] = (
                f"{k}={urllib.parse.quote(str(v))}"
            )
    added = out.pop("_addedPrepare", None)
    if added:
        headers[f"{PROTOCOL_HEADER}-Added-Prepare"] = (
            f"{added[0]}={urllib.parse.quote(added[1])}"
        )
    dealloc = out.pop("_deallocatedPrepare", None)
    if dealloc:
        headers[f"{PROTOCOL_HEADER}-Deallocated-Prepare"] = dealloc
    started = out.pop("_startedTransaction", None)
    if started:
        headers[f"{PROTOCOL_HEADER}-Started-Transaction-Id"] = started
    if out.pop("_clearedTransaction", None):
        headers[f"{PROTOCOL_HEADER}-Clear-Transaction-Id"] = "true"
    return json_response(out, headers=headers)


def _raw_type(ty: T.SqlType) -> str:
    s = str(ty)
    return s.split("(")[0]


def _session_from_headers(engine: Engine, h) -> Session:
    s = Session(
        user=h.get(f"{PROTOCOL_HEADER}-User", "anonymous"),
        catalog=h.get(f"{PROTOCOL_HEADER}-Catalog", "tpch"),
        schema=h.get(f"{PROTOCOL_HEADER}-Schema", "tiny"),
        source=h.get(f"{PROTOCOL_HEADER}-Source", ""),
    )
    raw = h.get(f"{PROTOCOL_HEADER}-Session", "") or ""
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        k, v = part.split("=", 1)
        s.set(k.strip(), _decode_session_value(urllib.parse.unquote(v.strip())))
    txn = h.get(f"{PROTOCOL_HEADER}-Transaction-Id", "") or ""
    if txn and txn.upper() != "NONE":
        # Validate against the TransactionManager: a bogus id would
        # make write paths skip the single-writer lock (reference
        # errors on unknown transaction ids).
        engine.transaction_manager.get(txn)  # raises if unknown
        s.properties["__txn"] = txn
    # prepared statements ride headers (the protocol is stateless):
    # X-Trino-Prepared-Statement: name=<urlencoded sql>[,name=...]
    raw = h.get(f"{PROTOCOL_HEADER}-Prepared-Statement", "") or ""
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        k, v = part.split("=", 1)
        s.prepared[k.strip().lower()] = urllib.parse.unquote(v.strip())
    return s


def _decode_session_value(v: str) -> Any:
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v


def _parse_duration(text: str) -> float:
    text = text.strip().lower()
    for suffix, mult in (("ms", 0.001), ("s", 1.0), ("m", 60.0)):
        if text.endswith(suffix):
            try:
                return float(text[: -len(suffix)]) * mult
            except ValueError:
                return 1.0
    try:
        return float(text)
    except ValueError:
        return 1.0
