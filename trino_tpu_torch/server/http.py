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
engine. The statement protocol, the node, query, resource-group and
metrics endpoints, shedding, draining and the web UI are served as the
reference serves them, and so are the repeat and post-mortem tiers:
``/v1/history`` (the engine's history stores), ``/v1/cache`` (the result
cache), ``/v1/slo`` (the SLO sentinel) and ``/v1/query/{id}/flight`` (the
flight journal's replay, read off the loop thread). What belongs to the
cluster tier (worker tasks, discovery and announcements, SPMD, spooling,
scaled writes; ROADMAP item 9c) answers **501** with a body naming its
item, and a server asked for a worker role, SPMD or a discovery URI
refuses at construction. Where a reference coordinator with no workers
answers with an empty listing (``GET /v1/task``, ``/v1/node``) or with its
own pool (``/v1/memory``), this one answers the same.
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


# where a route that is not ported yet belongs (ROADMAP item)
CLUSTER_ITEM = "9c"


class NotPortedError(RuntimeError):
    """A server option of a tier this package does not have yet."""


def refuse_cluster_options(role: str = "coordinator", spmd: bool = False,
                           discovery_uri: Optional[str] = None) -> None:
    """Raise for a server option of the cluster tier (ROADMAP item 9c)."""
    for asked, what in ((role != "coordinator", f"role={role!r}"),
                        (spmd, "spmd"),
                        (discovery_uri, "discovery_uri")):
        if asked:
            raise NotPortedError(
                f"{what} is not yet ported to trino_tpu_torch "
                f"(ROADMAP item {CLUSTER_ITEM})"
            )


class TrinoTpuServer:
    """Coordinator server wrapping Engine + QueryManager.

    ``TrinoTpuServer()`` builds ``Engine(device=device)``: on ``cuda``
    unless ``device`` names another, raising where there is no GPU, as
    ``Engine()`` does. The worker role, SPMD and discovery are the
    cluster tier's (ROADMAP item 9c) and raise.
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

        refuse_cluster_options(role, spmd, discovery_uri)
        self.engine = engine or Engine(device=device)
        self.server_config = server_config or ServerConfig()
        # registering a sink is what turns tracing ON for this process;
        # a bare Engine (no server) stays dark and pays nothing
        self.span_sink = InMemorySpanSink()
        get_tracer().add_sink(self.span_sink)
        self.role = role
        self.node_id = node_id or f"{role}-{port}"
        self.engine.node_id = self.node_id
        self.resource_groups = resource_groups or ResourceGroupManager()
        # the device-memory gate reads the engine's card
        self.resource_groups.device = self.engine.device
        # the coordinator's own pool is the cluster's while it has no
        # workers: /v1/memory reports it against this limit
        self.cluster_memory_limit_bytes = int(cluster_memory_limit_bytes or (64 << 30))
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
        # dispatch) — the loop thread itself never blocks
        self._front_pool = _DispatchPool(cfg.blocking_pool_size, name="http")
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._rate_limiter = TenantRateLimiter(
            cfg.tenant_rate_limit_qps, cfg.tenant_rate_limit_burst
        )
        # live node info for system.runtime.nodes; this node runs no
        # worker tasks (item 9c), so system.runtime.tasks lists none
        self.engine._runtime_nodes_fn = lambda: [
            ("coordinator", self.base_uri, VERSION, True, self.state)
        ]
        self.engine._runtime_tasks_fn = lambda: []

    # --- lifecycle --------------------------------------------------------

    def start(self) -> "TrinoTpuServer":
        self.httpd.start()
        interval = min(
            1.0, max(0.05, self.server_config.client_timeout_s / 4.0)
        )
        self.httpd.loop.call_later(interval, self._housekeep, interval)
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

    def stop(self) -> None:
        from trino_tpu_torch.obs.trace import get_tracer

        self.state = "STOPPED"
        self.httpd.close()
        self._front_pool.shutdown()
        self.query_manager.shutdown(wait=False)
        get_tracer().remove_sink(self.span_sink)

    def graceful_shutdown(self) -> None:
        """Drain, then stop (GracefulShutdownHandler.java:142): refuse new
        queries (shed 503), wait for active ones."""
        self.state = "SHUTTING_DOWN"
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self) -> None:
        while any(
            not q.state.is_terminal() for q in self.query_manager.queries()
        ):
            time.sleep(0.05)
        # grace: let clients pull the final result pages of queries that
        # just reached a terminal state before the socket closes
        time.sleep(self.server_config.drain_grace_s)
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
        replay (and, in the reference, internal cluster traffic) bypasses
        it."""
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
        if (len(parts) == 3 and parts[:2] in (["v1", "task"], ["v1", "spool"])) or path in (
                "/v1/write", "/v1/spmd"):
            # task creation, scaled-writer pages, SPMD and spooled pages
            return self._not_ported(responder, path, CLUSTER_ITEM)
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
            # a coordinator with no workers: its own pool's reservations
            # against the cluster limit (ClusterMemoryManager.info)
            pool = self.engine.memory_pool
            with pool._lock:
                reservations = dict(pool._query_reserved)
            return responder.respond(json_response({
                "clusterMemoryLimitBytes": self.cluster_memory_limit_bytes,
                "clusterReservedBytes": sum(reservations.values()),
                "queryReservations": reservations,
                "killedQueries": [],
            }))
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
            # this node runs no worker tasks (item 9c)
            return responder.respond(json_response([]))
        if path == "/v1/node":
            # a coordinator with no announced workers
            return responder.respond(json_response({"nodes": [], "failureInfo": []}))
        if parts[:2] in (["v1", "task"], ["v1", "spool"]):
            # task status and results, spooled pages and store stats
            return self._not_ported(responder, path, CLUSTER_ITEM)
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
        if len(parts) == 3 and parts[:2] in (["v1", "task"], ["v1", "spool"], ["v1", "announce"]):
            # task cancel, spool drop, worker decommission
            return self._not_ported(responder, path, CLUSTER_ITEM)
        responder.respond(json_response({"error": f"unknown path: {path}"}, 404))

    # --- PUT --------------------------------------------------------------

    def _route_put(self, request, responder, path, parts, qs) -> None:
        if path == "/v1/info/state":
            body = request.body.decode().strip().strip('"')
            if body == "SHUTTING_DOWN":
                self.graceful_shutdown()
                return responder.respond(json_response({}, 200))
            return responder.respond(
                json_response({"error": f"unsupported state: {body}"}, 400)
            )
        if path in ("/v1/discovery", "/v1/announce") or (
                len(parts) == 4 and parts[:2] == ["v1", "spool"] and parts[3] == "complete"):
            # late discovery, worker announcements, spool manifests
            return self._not_ported(responder, path, CLUSTER_ITEM)
        responder.respond(json_response({"error": f"unknown path: {path}"}, 404))

    def _not_ported(self, responder: Responder, path: str, item: str) -> None:
        responder.respond(json_response(
            {"error": f"{path} is not yet ported to trino_tpu_torch (ROADMAP item {item})",
             "roadmapItem": item},
            501,
        ))

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
