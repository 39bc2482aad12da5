"""Coordinator cluster layer: discovery, remote tasks, stage scheduling.

Reference:
- ``metadata/DiscoveryNodeManager.java:68,148`` — worker membership via the
  embedded discovery service (workers announce; coordinator polls). Here
  workers PUT /v1/announce on the coordinator and re-announce periodically.
- ``failuredetector/HeartbeatFailureDetector.java:78,91-120`` — the
  existing detector (server/failuredetector.py) monitors announced workers;
  failed nodes are excluded from scheduling.
- ``server/remotetask/HttpRemoteTask.java:103,317`` — coordinator-side
  proxy of a worker task: POST TaskUpdateRequest, long-poll status.
- ``execution/scheduler/SqlQueryScheduler.java:112,538`` +
  ``SqlStageExecution.java:384`` — stage tree scheduling. Fragment task
  counts: SOURCE/HASH fragments get one task per live worker (splits
  round-robin, FIXED_HASH partitions by index), SINGLE fragments one task;
  the root fragment executes on the coordinator, pulling child output over
  the same HTTP exchange (``server/protocol/Query.java:117``).

A port of ``trino_tpu/server/cluster.py``: the scheduler is host code and
is the reference's, apart from the root fragment's interpreter, which
runs on the coordinator engine's device, and what each stage sums of its
tasks: ``pages`` (the output's device-to-host read, its serialization,
the pages and their bytes; ``pageStats`` for the query), the tasks'
``executionPaths`` and their hand-kernel launches (``kernelLaunches``).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import urllib.request
from typing import Any, Optional

from trino_tpu_torch.config import Session
from trino_tpu_torch.events import StageCompletedEvent, TaskCompletedEvent
from trino_tpu_torch.exec.local import ExecutionError
from trino_tpu_torch.obs.metrics import get_registry, percentile
from trino_tpu_torch.obs.trace import TRACE_HEADER, format_trace_header, get_tracer
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.fragmenter import (
    HASH,
    SOURCE,
    FusedFragment,
    PlanFragment,
    SubPlan,
    filtered_broadcast_fids,
    fragment_plan,
    fuse_groups,
    partitioned_join_pairs,
)

_task_counter = itertools.count(1)

# a task's page counters (server/task.py::SqlTask._emit), summed a stage
# (``stages[i]["pages"]``) and a query (``pageStats``)
_PAGE_STATS = ("d2h_ms", "serialize_ms", "pages_out", "page_bytes_out")


class WorkerNode:
    def __init__(self, node_id: str, uri: str):
        self.node_id = node_id
        self.uri = uri.rstrip("/")
        self.last_announce = time.time()

    def to_json(self) -> dict:
        return {
            "nodeId": self.node_id,
            "uri": self.uri,
            "lastAnnounceSecondsAgo": round(time.time() - self.last_announce, 3),
        }


class ClusterNodeManager:
    """Announce-based membership + failure-detector exclusion."""

    def __init__(self, announce_timeout: float = 30.0, ping_interval: float = 2.0):
        self._nodes: dict[str, WorkerNode] = {}
        self._lock = threading.Lock()
        self.announce_timeout = announce_timeout
        from trino_tpu_torch.server.failuredetector import HeartbeatFailureDetector

        def ping(uri: str) -> bool:
            with urllib.request.urlopen(f"{uri}/v1/info", timeout=5) as r:
                return r.status == 200

        self.failure_detector = HeartbeatFailureDetector(
            ping, interval=ping_interval
        )
        self._started = False

    def announce(self, node_id: str, uri: str) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                self._nodes[node_id] = WorkerNode(node_id, uri)
                self.failure_detector.register(node_id, uri)
            else:
                node.last_announce = time.time()
                new_uri = uri.rstrip("/")
                if node.uri != new_uri:
                    # restarted worker, same identity, new port: the
                    # detector must ping the NEW uri (and forget the dead
                    # port's failure history) or the fresh process would
                    # be flagged failed on its predecessor's evidence
                    node.uri = new_uri
                    self.failure_detector.register(node_id, new_uri)
        if not self._started:
            self._started = True
            try:
                self.failure_detector.start()
            except Exception:  # pragma: no cover - detector is advisory
                pass

    def remove(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def decommission(self, node_id: str) -> None:
        """Drained-worker deregistration (DELETE /v1/announce/{nodeId}):
        drop from membership AND the failure detector, so a cleanly
        departed node neither attracts placements nor gets pinged and
        counted as failed."""
        self.remove(node_id)
        self.failure_detector.unregister(node_id)

    def all_nodes(self) -> list[WorkerNode]:
        with self._lock:
            return list(self._nodes.values())

    def active_nodes(self) -> list[WorkerNode]:
        """Announced recently AND not flagged by the failure detector
        (scheduling exclusion, reference NodeScheduler + failure detector)."""
        now = time.time()
        with self._lock:
            nodes = list(self._nodes.values())
        return [
            n
            for n in nodes
            if now - n.last_announce < self.announce_timeout
            and not self.failure_detector.is_failed(n.node_id)
        ]



class NodeScheduler:
    """Node-selection policy for task placement.

    Reference: ``execution/scheduler/NodeScheduler.java`` +
    ``UniformNodeSelector.java`` — tasks go to the least-loaded active
    nodes (tracked coordinator-side per in-flight task) rather than blind
    round-robin, so a straggling worker stops attracting new work.
    """

    def __init__(self, node_manager: "ClusterNodeManager"):
        self.node_manager = node_manager
        self._assigned: dict[str, int] = {}  # node_id -> in-flight tasks
        self._lock = threading.Lock()

    def select(self, nodes: list["WorkerNode"], count: int) -> list["WorkerNode"]:
        """Pick ``count`` placements (repeats allowed when count > nodes),
        each time choosing the node with the fewest in-flight tasks.

        Selection IS reservation: ``_assigned`` is bumped here, under the
        same lock, so two fragments scheduling concurrently see each
        other's placements instead of both dog-piling the least-loaded
        node. Callers release via :meth:`release` when the task finishes
        (or fails to start).

        Among equally-loaded nodes, the failure detector's ping-latency
        EWMA breaks the tie (slow node last); nodes without latency
        evidence rank neutral (0.0), preserving the node-id round-robin."""
        det = getattr(self.node_manager, "failure_detector", None)
        lat = getattr(det, "latency_ms", None)
        out: list[WorkerNode] = []
        with self._lock:
            for _ in range(count):
                best = min(
                    nodes,
                    key=lambda n: (
                        self._assigned.get(n.node_id, 0),
                        lat(n.node_id) if lat is not None else 0.0,
                        n.node_id,
                    ),
                )
                self._assigned[best.node_id] = (
                    self._assigned.get(best.node_id, 0) + 1
                )
                out.append(best)
        return out

    def acquire(self, node: "WorkerNode") -> None:
        with self._lock:
            self._assigned[node.node_id] = self._assigned.get(node.node_id, 0) + 1

    def release(self, node: "WorkerNode") -> None:
        with self._lock:
            v = self._assigned.get(node.node_id, 0) - 1
            if v <= 0:
                self._assigned.pop(node.node_id, None)
            else:
                self._assigned[node.node_id] = v


def phased_order(sub: "SubPlan") -> list["PlanFragment"]:
    """Fragment launch order under the phased policy.

    Reference: ``execution/scheduler/PhasedExecutionSchedule.java`` —
    producers launch before consumers (our baseline bottom-up already
    guarantees that), and among one join's feeding fragments the BUILD
    side (the join's right subtree) launches before the PROBE side, so
    probe tasks never sit on a worker waiting for a build that has not
    even been scheduled.
    """
    out: list[PlanFragment] = []

    def build_side_fragments(frag: PlanFragment) -> set[int]:
        """Fragment ids referenced from any join's right (build) subtree."""
        build: set[int] = set()

        def mark(node, in_build: bool):
            if isinstance(node, P.RemoteSource):
                if in_build:
                    build.add(node.fragment_id)
                return
            if isinstance(node, P.Join):
                mark(node.left, in_build)
                mark(node.right, True)
                return
            for s in node.sources:
                mark(s, in_build)

        mark(frag.root, False)
        return build

    def rec(sp: "SubPlan"):
        build_ids = build_side_fragments(sp.fragment)
        ordered = sorted(
            sp.children,
            key=lambda c: 0 if c.fragment.id in build_ids else 1,
        )
        for c in ordered:
            rec(c)
        out.append(sp.fragment)

    rec(sub)
    return out


class HttpRemoteTask:
    """Coordinator-side handle of one worker task.

    Request timeouts come from the session (``http_request_timeout_s``)
    and each call retries through transient failures — including injected
    HTTP drops — with deterministic backoff. Injection sites are keyed by
    ``fragment.partition[+attempt]`` (the task id minus the per-run query
    counter) so chaos runs replay exactly.
    """

    def __init__(
        self,
        node: WorkerNode,
        task_id: str,
        payload: dict,
        timeout: float = 30.0,
        http_retries: int = 3,
        injector=None,
        backoff=None,
    ):
        from trino_tpu_torch.ft.retry import Backoff

        self.node = node
        self.task_id = task_id
        self.payload = payload
        self.uri = f"{node.uri}/v1/task/{task_id}"
        self.timeout = timeout
        self.http_retries = max(1, int(http_retries))
        self.injector = injector
        self.backoff = backoff or Backoff()
        # set instead of raising when a TASK-retry dispatch fails to start
        self.start_error: Optional[str] = None
        # observability: the dispatch attempt's span + propagation context
        # ((trace_id, span_id) rides X-Trino-Trace so the worker's
        # task_execute span parents to this attempt), last observed status
        # for the end-of-query finalize pass, and attempt ordinal
        self.trace = None
        self.span = None
        self.attempt = 1
        self.last_status: Optional[dict] = None
        self._obs_done = False
        # hedged execution: dispatch time feeds the straggler detector;
        # speculative marks a duplicate (hedge) attempt of a straggler
        self.started_mono: Optional[float] = None
        self.speculative = False
        # recovery: set on lineage re-executions of a dead producer
        # (rendered like speculative attempts in the waterfall)
        self.recovered = False

    def _site_target(self) -> str:
        # "cq7.3.0r1" -> "3.0r1": stable across runs, fresh per attempt
        return self.task_id.split(".", 1)[-1]

    def _request(
        self,
        op: str,
        method: str,
        uri: str,
        body: Optional[bytes] = None,
        timeout: Optional[float] = None,
        parse: bool = True,
    ):
        from trino_tpu_torch.ft.retry import is_retryable
        from trino_tpu_torch.server import auth

        last: Optional[Exception] = None
        for attempt in range(1, self.http_retries + 1):
            try:
                if self.injector is not None:
                    site = self.injector.http_site(
                        op, self._site_target(), attempt
                    )
                    self.injector.delay_http(site)
                    self.injector.maybe_drop_http(site)
                req = urllib.request.Request(
                    uri, data=body, method=method, headers=auth.headers()
                )
                if body is not None:
                    req.add_header("Content-Type", "application/json")
                header = format_trace_header(self.trace)
                if header is not None:
                    req.add_header(TRACE_HEADER, header)
                with urllib.request.urlopen(
                    req, timeout=timeout or self.timeout
                ) as r:
                    return json.loads(r.read().decode()) if parse else None
            except Exception as e:  # noqa: BLE001
                last = e
                if not is_retryable(e) or attempt >= self.http_retries:
                    raise
                time.sleep(self.backoff.delay(attempt))
        raise last  # pragma: no cover — loop always returns or raises

    def start(self) -> None:
        self.started_mono = time.monotonic()
        self._request(
            "start", "POST", self.uri, body=json.dumps(self.payload).encode()
        )

    def elapsed_ms(self) -> float:
        """Wall time since dispatch (0 before start)."""
        if self.started_mono is None:
            return 0.0
        return (time.monotonic() - self.started_mono) * 1000.0

    def status(self, max_wait: float = 0.0) -> dict:
        uri = self.uri + (f"?maxWait={max_wait}" if max_wait else "")
        st = self._request(
            "status", "GET", uri, timeout=max(self.timeout, max_wait + 10)
        )
        self.last_status = st
        return st

    def cancel(self, speculative: bool = False) -> None:
        uri = self.uri + ("?speculative=true" if speculative else "")
        try:
            self._request("cancel", "DELETE", uri, timeout=10, parse=False)
        except Exception:  # noqa: BLE001 - best-effort
            pass


class SpoolHandle:
    """Stand-in for a dead producer whose completed output now serves
    from the coordinator's spool store.

    Quacks like :class:`HttpRemoteTask` everywhere the scheduler touches
    producer tasks: ``.uri`` points at ``/v1/spool/{taskId}`` (whose
    results route speaks the task-results wire shape, so consumers'
    ``ExchangeClient`` pulls it unchanged), ``status()`` is always
    FINISHED, ``cancel()`` is a no-op (spool lifetime belongs to the
    query, not the attempt). Its node is a dummy the NodeScheduler never
    reserved — the query-level release is a harmless no-op."""

    def __init__(self, base_uri: str, task_id: str):
        self.task_id = task_id
        self.uri = f"{base_uri.rstrip('/')}/v1/spool/{task_id}"
        self.node = WorkerNode("__spool__", base_uri)
        self.payload: dict = {}
        self.last_status = {"state": "FINISHED", "spool": True}
        self.start_error: Optional[str] = None
        self.trace = None
        self.span = None
        self.attempt = 1
        self.speculative = False
        self.recovered = True
        self._obs_done = True  # the recovery span already closed
        self.started_mono: Optional[float] = None

    def start(self) -> None:  # pragma: no cover — never dispatched
        pass

    def status(self, max_wait: float = 0.0) -> dict:
        return self.last_status

    def cancel(self, speculative: bool = False) -> None:
        pass

    def elapsed_ms(self) -> float:
        return 0.0


def _build_side_scans(roots) -> tuple[set, bool]:
    """The tables a fragment scans on the build side of one of its joins
    (every task reads them whole), and whether the fragment must run in
    one task with every table whole: a table scanned on both a probe
    spine and a build side, or a FULL or RIGHT join over a scan on its
    build side (each task would emit the unmatched build rows)."""
    probe: set = set()
    build: set = set()
    whole = False

    def walk(node, on_build: bool) -> None:
        nonlocal whole
        if isinstance(node, P.TableScan):
            (build if on_build else probe).add(
                f"{node.catalog}.{node.schema}.{node.table}")
            return
        if isinstance(node, P.Join):
            if node.join_type in ("FULL", "RIGHT") and any(
                    isinstance(n, P.TableScan) for n in P.walk_plan(node.right)):
                whole = True
            walk(node.left, on_build)
            walk(node.right, True)
            return
        for src in node.sources:
            walk(src, on_build)

    for root in roots:
        walk(root, False)
    return build, whole or bool(probe & build)


class ClusterScheduler:
    """Schedules a fragmented plan over the worker set and gathers output.

    One scheduler per coordinator; one `execute` per query.

    Retry policies (``retry_policy`` session property, reference: Trino's
    fault-tolerant execution / ``io.trino.execution.RetryPolicy``):

    - NONE: v356 semantics — pipelined stages, any task failure fails the
      query (now with a *classified* retryable/fatal error).
    - TASK: stage-barrier execution over retained (materialized) task
      output. Each fragment's tasks must finish before consumers launch;
      a failed attempt is re-dispatched to a different worker with
      exponential backoff + deterministic jitter, bounded by
      ``task_retry_attempts``. Placement consults the failure detector's
      ``active_nodes()`` so sick workers do not attract retries.
    - QUERY is handled a level up (server/querymanager.py): the whole
      statement re-runs on a fresh attempt salt.
    """

    def __init__(self, engine, node_manager: ClusterNodeManager):
        self.engine = engine
        self.node_manager = node_manager
        self.node_scheduler = NodeScheduler(node_manager)

    def _http_opts(self, session: Session) -> dict:
        """Per-query HTTP tuning + chaos hooks for remote-task calls."""
        from trino_tpu_torch.ft.injection import FaultInjector
        from trino_tpu_torch.ft.retry import Backoff

        try:
            timeout = float(session.get("http_request_timeout_s"))
            retries = int(session.get("http_retry_attempts"))
        except KeyError:
            timeout, retries = 30.0, 3
        return {
            "timeout": timeout,
            "http_retries": retries,
            "injector": FaultInjector.from_session(session),
            "backoff": Backoff.from_session(session),
        }

    def execute(
        self,
        plan: P.PlanNode,
        session: Session,
        stats_sink=None,
        query_id: Optional[str] = None,
    ):
        """Returns (Batch, column_names). ``stats_sink`` (dict) receives
        retry/attempt counters plus a per-stage ``stages`` rollup for
        query stats and /v1/query."""
        from trino_tpu_torch.ft.retry import (
            RetryPolicy,
            SpeculationConfig,
            SpoolConfig,
        )

        tracer = get_tracer()
        with tracer.span("fragment"):
            sub = fragment_plan(plan)
        nodes = self.node_manager.active_nodes()
        if not nodes:
            raise ExecutionError("no active workers in the cluster")
        n = len(nodes)
        query_id = query_id or f"cq{next(_task_counter)}"
        policy = RetryPolicy.from_session(session)
        stats = stats_sink if stats_sink is not None else {}
        stats.setdefault("retry_policy", policy)
        stats.setdefault("task_retries", 0)
        stats.setdefault("task_attempts", {})
        stats.setdefault("speculative_attempts", 0)
        stats.setdefault("speculative_wins", 0)
        http = self._http_opts(session)

        fragments = {f.id: f for f in sub.all_fragments()}
        # execution policy: all-at-once launches in simple bottom-up order;
        # phased launches join build sides before their probes
        # (AllAtOnceExecutionPolicy vs PhasedExecutionPolicy)
        if session.get("execution_policy") == "phased":
            order = phased_order(sub)
        else:
            order = self._bottom_up(sub)

        # whole-pipeline fusion: chains of eligible fragments collapse
        # into single-task stage-groups — ONE task POST runs the whole
        # chain as one compiled program on one worker's local mesh
        # (in-jit collectives cannot cross worker process boundaries, so
        # a fused unit trades cross-worker fan-out for zero interior
        # dispatch round-trips). Speculation/retry operate on the unit
        # task. Spooled exchange coexists: the unit's only materialized
        # outputs are its unit-boundary buffers, so those are the spool
        # pages — recovery then works at unit granularity (re-point a
        # complete unit spool, or re-execute the lost unit atomically).
        units_members: dict[int, list[PlanFragment]] = {}
        unit_root_of: dict[int, int] = {}
        units_fused: dict[int, FusedFragment] = {}
        if (
            bool(session.get("pipeline_fusion"))
            and str(session.get("worker_execution")).startswith("fused")
        ):
            from trino_tpu_torch.exec.fragments import fragment_fusable

            units = fuse_groups(
                sub,
                fusable=fragment_fusable,
                max_fragments=max(
                    1, int(session.get("fusion_max_fragments"))
                ),
                # selective broadcast builds keep the dynamic-filter
                # boundary (worker-side DF needs the materialized build)
                blocked=(
                    frozenset(filtered_broadcast_fids(sub))
                    if bool(session.get("enable_dynamic_filtering"))
                    else frozenset()
                ),
                skew_pairs=(
                    partitioned_join_pairs(sub)
                    if bool(session.get("skew_handling"))
                    else ()
                ),
                include_root=False,  # the root runs on the coordinator
                broadcast_links=bool(session.get("dense_join")),
            )
            for u in units:
                if isinstance(u, FusedFragment):
                    units_members[u.id] = list(u.fragments)
                    units_fused[u.id] = u
                    for m in u.fragments:
                        unit_root_of[m.id] = u.id

        # task counts per fragment (root runs on the coordinator)
        task_counts: dict[int, int] = {}
        for frag in order:
            if frag.id == sub.fragment.id:
                task_counts[frag.id] = 0  # coordinator
            elif frag.id in units_members:
                task_counts[frag.id] = 1  # one fused program, one worker
            elif unit_root_of.get(frag.id, frag.id) != frag.id:
                task_counts[frag.id] = 0  # interior: rides its unit task
            elif frag.partitioning.kind in (SOURCE, HASH):
                task_counts[frag.id] = n
            else:
                task_counts[frag.id] = 1

        consumer_of: dict[int, int] = {}
        for frag in order:
            for fid in frag.source_fragment_ids:
                # producers feeding a fused unit's interior address the
                # unit's single task: partition counts follow the unit
                consumer_of[fid] = unit_root_of.get(frag.id, frag.id)

        remote_tasks: dict[int, list[HttpRemoteTask]] = {}
        session_json = {
            "user": session.user,
            "catalog": session.catalog,
            "schema": session.schema,
            "properties": {
                k: v
                for k, v in session.properties.items()
                if isinstance(v, (str, int, float, bool))
                and k not in ("execution_mode",)
            },
        }
        # per-execute observability state (the scheduler instance is shared
        # across concurrent queries, so nothing goes on ``self``):
        # stage spans stay open until the query finalizes, ``elapsed``
        # collects FINISHED sibling-task wall times per stage for the
        # p50/p99 rollup, ``stage_start`` is monotonic per stage. The
        # speculation budget (max concurrent hedges) is per QUERY, shared
        # across this execute's stage barriers via spec_active.
        spec = SpeculationConfig.from_session(session)
        obs: dict = {
            "stage_spans": {},
            "elapsed": {},
            "stage_start": {},
            "spec": spec,
            "spec_budget": spec.budget(sum(task_counts.values())),
            "spec_active": 0,
        }
        # spooled exchange + lineage recovery (only under TASK retry: both
        # extend the retained-buffer materialized exchange). ``store`` is
        # the coordinator-hosted spool; ``rc`` is the recovery context the
        # heal paths thread through — which producer ran where, how to
        # rebuild source URIs, and where the spool lives.
        spool_cfg = SpoolConfig.from_session(session)
        spool_base = getattr(self.engine, "spool_base_uri", None)
        store = None
        spool_payload = None
        if spool_cfg.enabled and policy == RetryPolicy.TASK and spool_base:
            from trino_tpu_torch.exchange.spool import get_spool_store

            store = get_spool_store(
                self.engine, spool_cfg.spool_dir, spool_cfg.max_bytes
            )
            spool_payload = {"uri": spool_base, "queryId": query_id}
        rc = None
        if policy == RetryPolicy.TASK:
            stats.setdefault("recovered_tasks", 0)
            stats.setdefault("recovered_levels", {})
        if policy == RetryPolicy.TASK and spool_cfg.enabled:
            # dead-producer recovery (spool re-point / lineage
            # re-execution) is part of the opt-in spooled-exchange mode:
            # without it, a retry keeps the plain PR-6 semantics — no
            # liveness probes of upstream producers on the retry path
            rc = {
                "query_id": query_id,
                "fragments": fragments,
                "remote_tasks": remote_tasks,
                "session": session,
                "http": http,
                "stats": stats,
                "store": store,
                "base_uri": spool_base,
                "lineage_seq": itertools.count(1),
                "obs": obs,
                "units": units_fused,
            }
        ok = False
        try:
            for frag in order:
                if frag.id == sub.fragment.id:
                    continue
                if unit_root_of.get(frag.id, frag.id) != frag.id:
                    continue  # fused-unit interior: rides its unit's task
                members = units_members.get(frag.id)
                if rc is not None:
                    # lineage heal: a producer whose node left the cluster
                    # since its barrier is recovered (spool re-point or
                    # re-execution) BEFORE this consumer's source URIs are
                    # baked into its payloads
                    self._heal_sources(frag, rc)
                obs["stage_start"][frag.id] = time.monotonic()
                stage_span = tracer.start_span(
                    "stage",
                    attrs={
                        "stage": frag.id,
                        "tasks": task_counts[frag.id],
                        **(
                            {"fusedFragments": len(members)}
                            if members is not None
                            else {}
                        ),
                    },
                )
                obs["stage_spans"][frag.id] = stage_span
                remote_tasks[frag.id] = self._schedule_fragment(
                    query_id,
                    frag,
                    nodes,
                    task_counts,
                    consumer_of,
                    remote_tasks,
                    session_json,
                    fragments,
                    policy=policy,
                    http=http,
                    stage_span=stage_span,
                    spool=spool_payload,
                    members=members,
                )
                if policy == RetryPolicy.TASK:
                    # stage barrier: producers must FINISH (with retained
                    # output) before consumers launch, so a consumer only
                    # ever sees the surviving attempt's URIs and retained
                    # pages stay re-pullable by retried consumers
                    self._await_fragment(
                        query_id, frag, remote_tasks[frag.id],
                        session, stats, http,
                        stage_span=stage_span, obs=obs, rc=rc,
                    )
            obs["stage_start"][sub.fragment.id] = time.monotonic()
            root_span = tracer.start_span(
                "stage",
                attrs={
                    "stage": sub.fragment.id,
                    "tasks": 0,
                    "coordinator": True,
                },
            )
            obs["stage_spans"][sub.fragment.id] = root_span
            with tracer.activate(root_span):
                result = self._execute_root(
                    sub.fragment, session, remote_tasks, task_counts, policy,
                    rc=rc,
                )
            ok = True
            if policy == RetryPolicy.TASK:
                # retained buffers never free on ack; release them now
                for tasks in remote_tasks.values():
                    for t in tasks:
                        t.cancel()
            return result
        except Exception:
            for tasks in remote_tasks.values():
                for t in tasks:
                    t.cancel()
            raise
        finally:
            if store is not None:
                # the query is done either way: record what got spooled,
                # then free the spool (results already left the cluster)
                stats["spooled_bytes"] = store.query_bytes(query_id)
                store.delete_query(query_id)
            # close attempt/stage spans, fire stage/task events, and build
            # stats["stages"] BEFORE releasing nodes — the caller reads
            # ``stats`` right after execute() returns
            self._finalize_query(
                query_id, stats, remote_tasks, task_counts, obs, ok
            )
            for tasks in remote_tasks.values():
                for t in tasks:
                    self.node_scheduler.release(t.node)

    # --- stage scheduling -------------------------------------------------

    def _bottom_up(self, sub: SubPlan) -> list[PlanFragment]:
        out: list[PlanFragment] = []

        def rec(sp: SubPlan):
            for c in sp.children:
                rec(c)
            out.append(sp.fragment)

        rec(sub)
        return out

    def _sources_payload(
        self,
        frag: PlanFragment,
        partition: int,
        remote_tasks: dict[int, list[HttpRemoteTask]],
        fragments: dict[int, PlanFragment],
        exclude: frozenset = frozenset(),
    ) -> dict:
        sources = {}
        for fid in frag.source_fragment_ids:
            if fid in exclude:
                continue  # in-unit producer: handed off inside the program
            tasks = remote_tasks[fid]
            producer = fragments.get(fid)
            entry = {
                "locations": [t.uri for t in tasks],
                "partition": partition,
            }
            if producer is not None and producer.output_exchange == "hash":
                # workers re-partition hash-exchanged rows over their local
                # devices; ship the partition keys and the wire column order
                entry["keys"] = [s.name for s in producer.output_keys]
                entry["symbols"] = [
                    s.name for s in producer.root.output_symbols
                ]
            sources[str(fid)] = entry
        return sources

    def _schedule_fragment(
        self,
        query_id: str,
        frag: PlanFragment,
        nodes: list[WorkerNode],
        task_counts: dict[int, int],
        consumer_of: dict[int, int],
        remote_tasks: dict[int, list[HttpRemoteTask]],
        session_json: dict,
        fragments: dict[int, PlanFragment],
        policy: str = "NONE",
        http: Optional[dict] = None,
        stage_span=None,
        spool: Optional[dict] = None,
        members: Optional[list[PlanFragment]] = None,
    ) -> list[HttpRemoteTask]:
        from trino_tpu_torch.ft.retry import RetryPolicy, is_retryable
        from trino_tpu_torch.planner.serde import fragment_to_json

        http = http or {}

        n_tasks = task_counts[frag.id]
        consumer = consumer_of.get(frag.id)
        output_partitions = max(
            1, task_counts.get(consumer, 1) if consumer is not None else 1
        )
        # a fused unit's task evaluates every member fragment, so its
        # splits and remote sources span the whole member list
        member_ids = frozenset(m.id for m in members) if members else frozenset()
        scan_frags = members if members else [frag]
        # split assignment for SOURCE fragments (enumerated on the
        # coordinator during scheduling, reference SplitManager timing)
        split_assignment: list[dict[str, list[dict]]] = [
            {} for _ in range(max(n_tasks, 1))
        ]
        scans: dict[str, tuple[P.TableScan, Any]] = {}
        for sf in scan_frags:
            if sf.partitioning.kind != SOURCE and not members:
                continue
            for node in P.walk_plan(sf.root):
                if isinstance(node, P.TableScan):
                    key = f"{node.catalog}.{node.schema}.{node.table}"
                    if key in scans:
                        # two member scans of one table share the split
                        # list on the wire: widen to unconstrained when
                        # their pruning constraints disagree, so neither
                        # scan misses splits (predicates still apply
                        # in-program — the constraint is advisory)
                        if scans[key][1] != node.constraint:
                            scans[key] = (scans[key][0], None)
                        continue
                    scans[key] = (node, node.constraint)
        # a scan on the build side of a join inside the fragment is read
        # whole by every task (the join is replicated); the probe spine's
        # scans are split over the tasks (the reference splits every scan,
        # so a join of two scans in one fragment loses the pairs that land
        # in different tasks: TPC-H Q10's customer and orders at SF1)
        build_keys, whole = _build_side_scans(
            [sf.root for sf in scan_frags
             if sf.partitioning.kind == SOURCE or members])
        for key, (node, constraint) in scans.items():
            connector = self.engine.catalogs.get(node.catalog)
            splits = connector.get_splits(
                node.schema,
                node.table,
                target_splits=max(n_tasks, 1) * 4,
                constraint=constraint,
            )
            for i, s in enumerate(splits):
                wire = {
                    "table": s.table,
                    "index": s.index,
                    "total": s.total,
                    "info": s.info,
                }
                if whole:
                    targets = [0]  # one task reads every table whole
                elif key in build_keys:
                    targets = range(max(n_tasks, 1))
                else:
                    targets = [i % max(n_tasks, 1)]
                for t in targets:
                    split_assignment[t].setdefault(key, []).append(wire)
        frag_json = fragment_to_json(frag)
        tasks: list[HttpRemoteTask] = []
        # membership can shrink between execute()'s snapshot and this
        # fragment's turn (node died or drained during an earlier stage
        # barrier): place on the currently-live subset when one exists.
        # task_counts stay as planned — fewer nodes just take more tasks.
        live = {x.node_id for x in self.node_manager.active_nodes()}
        candidates = [x for x in nodes if x.node_id in live] or nodes
        placements = self.node_scheduler.select(candidates, n_tasks)
        try:
            for p in range(n_tasks):
                sources: dict = {}
                for sf in scan_frags:
                    sources.update(
                        self._sources_payload(
                            sf, p, remote_tasks, fragments, exclude=member_ids
                        )
                    )
                payload = {
                    "session": session_json,
                    "fragment": frag_json,
                    "splits": split_assignment[p],
                    "sources": sources,
                    "output_partitions": output_partitions,
                    # materialized exchange: retained pages survive acks so
                    # a retried consumer attempt can re-pull them
                    "retain_output": policy == RetryPolicy.TASK,
                }
                if members is not None:
                    # whole chain ships with the task: the worker compiles
                    # the members into one program instead of N fragments
                    payload["fused_fragments"] = [
                        fragment_to_json(m) for m in members
                    ]
                if spool is not None:
                    # async durable copy: the worker spools finished pages
                    # to the coordinator so output survives its death
                    payload["spool"] = spool
                task = HttpRemoteTask(
                    placements[p], f"{query_id}.{frag.id}.{p}", payload, **http
                )
                att = get_tracer().start_span(
                    "task_attempt",
                    trace_id=getattr(stage_span, "trace_id", None),
                    parent_id=getattr(stage_span, "span_id", None),
                    attrs={
                        "taskId": task.task_id,
                        "stage": frag.id,
                        "worker": placements[p].node_id,
                        "attempt": 1,
                    },
                )
                task.span = att
                # rides X-Trino-Trace so the worker's task_execute span
                # parents to this dispatch attempt
                task.trace = att.context()
                if policy == RetryPolicy.TASK:
                    # a dispatch failure is just attempt 1 failing: defer
                    # to the stage barrier, which retries it elsewhere
                    try:
                        task.start()
                    except Exception as e:  # noqa: BLE001
                        if not is_retryable(e):
                            raise
                        task.start_error = str(e)
                else:
                    task.start()  # select() already reserved the slot
                tasks.append(task)
        except Exception:
            # a mid-fragment failure leaves these tasks outside
            # remote_tasks, so the query-level release never sees them:
            # cancel started tasks and release EVERY reserved placement
            # (started or not) to keep the load counters honest
            for t in tasks:
                t.cancel()
            for node in placements:
                self.node_scheduler.release(node)
            raise
        return tasks

    # --- stage barrier + task retry (retry_policy=TASK) -------------------

    def _prune_slowest(self, candidates: list[WorkerNode]) -> list[WorkerNode]:
        """Drop the slowest healthy node from hedge/retry placement when
        its ping-latency EWMA is far off the fastest's (over both 2x the
        fastest AND fastest + 25ms — absolute floor so sub-millisecond
        jitter on a quiet loopback cluster never triggers it). Hedges and
        recovery re-dispatches exist to dodge slowness; landing them on
        the known-slowest node defeats the point."""
        if len(candidates) < 2:
            return candidates
        det = getattr(self.node_manager, "failure_detector", None)
        lat_fn = getattr(det, "latency_ms", None)
        if lat_fn is None:
            return candidates
        lats = {n.node_id: lat_fn(n.node_id) for n in candidates}
        known = [v for v in lats.values() if v > 0.0]
        if len(known) < 2:
            return candidates
        fastest, slowest = min(known), max(known)
        if slowest > max(2.0 * fastest, fastest + 25.0):
            keep = [n for n in candidates if lats[n.node_id] < slowest]
            if keep:
                return keep
        return candidates

    def _retry_node(self, exclude: str) -> WorkerNode:
        """Placement for a re-dispatched attempt: prefer a *different*
        worker with positive health evidence from the failure detector
        (avoiding the slowest of them); fall back to any active node
        (single-worker clusters retry in place rather than fail).
        ``select()`` reserves the slot."""
        active = self.node_manager.active_nodes()
        healthy = set(self.node_manager.failure_detector.active_nodes())
        candidates = [
            n for n in active
            if n.node_id != exclude and (not healthy or n.node_id in healthy)
        ]
        candidates = self._prune_slowest(candidates)
        if not candidates:
            candidates = [n for n in active if n.node_id != exclude] or active
        if not candidates:
            raise ExecutionError("no active workers available for task retry")
        return self.node_scheduler.select(candidates, 1)[0]

    def _speculation_node(self, exclude: str) -> Optional[WorkerNode]:
        """Placement for a hedged attempt: a *different* healthy node
        (never the slowest of them), or None (unlike retries, a hedge on
        the straggler's own node is pointless — skip hedging instead).
        ``select()`` reserves the slot; the caller must release on every
        hedge outcome."""
        active = self.node_manager.active_nodes()
        healthy = set(self.node_manager.failure_detector.active_nodes())
        candidates = [
            n for n in active
            if n.node_id != exclude and (not healthy or n.node_id in healthy)
        ]
        candidates = self._prune_slowest(candidates)
        if not candidates:
            candidates = [n for n in active if n.node_id != exclude]
        if not candidates:
            return None
        return self.node_scheduler.select(candidates, 1)[0]

    # --- lineage recovery (spooled exchange, worker death) -----------------

    def _producer_alive(self, t, probe: bool) -> bool:
        """Is this finished producer's retained output still reachable?
        Membership first (cheap); with ``probe`` also one live status GET
        — membership lags a fresh SIGKILL by several detector cycles, but
        the dead socket refuses instantly."""
        if isinstance(t, SpoolHandle):
            return True  # already durable on the coordinator
        active = {n.node_id for n in self.node_manager.active_nodes()}
        if t.node.node_id not in active:
            return False
        if not probe:
            return True
        try:
            st = t.status(max_wait=0.0)
        except Exception:  # noqa: BLE001 — unreachable == lost output
            return False
        return st.get("state") == "FINISHED"

    def _source_fids(self, frag, rc) -> tuple:
        """The producer fragment ids ``frag`` actually pulls from. For a
        fused-unit root that is the unit's *external* sources — every
        member's out-of-unit producer — because interior links are in-jit
        collectives with no tasks of their own. Everything else pulls its
        plain ``source_fragment_ids``."""
        unit = (rc.get("units") or {}).get(getattr(frag, "id", None))
        if unit is not None:
            return unit.external_source_ids
        return tuple(getattr(frag, "source_fragment_ids", ()) or ())

    def _rebuild_sources(self, frag, partition: int, rc: dict) -> dict:
        """Source URIs for a (re)dispatched attempt of ``frag``, rebuilt
        from the current remote_tasks — which may now hold spool handles
        or recovered attempts. Unit-aware: a fused unit's sources span
        all members, with in-unit links excluded."""
        unit = (rc.get("units") or {}).get(getattr(frag, "id", None))
        if unit is not None:
            sources: dict = {}
            for m in unit.fragments:
                sources.update(
                    self._sources_payload(
                        m, partition, rc["remote_tasks"], rc["fragments"],
                        exclude=unit.member_ids,
                    )
                )
            return sources
        return self._sources_payload(
            frag, partition, rc["remote_tasks"], rc["fragments"]
        )

    def _heal_sources(self, frag, rc, probe: bool = False) -> bool:
        """Recover every dead producer feeding ``frag``: spool re-point
        when the task's output spooled completely (level=task), else
        re-execute just that producer — recursively healing ITS sources
        first (level=lineage, or level=fused when the producer is a
        whole fused unit re-run atomically). Returns whether anything was
        recovered (callers then rebuild consumer source URIs from
        remote_tasks). Fused-unit consumers heal the unit's *external*
        sources — interior members have no tasks to heal."""
        if rc is None:
            return False
        healed = False
        for fid in self._source_fids(frag, rc):
            tasks = rc["remote_tasks"].get(fid)
            if not tasks:
                continue
            for idx in range(len(tasks)):
                if self._producer_alive(tasks[idx], probe):
                    continue
                self._recover_task(fid, idx, rc, probe=probe)
                healed = True
        return healed

    def _recover_task(self, fid: int, idx: int, rc: dict,
                      probe: bool = False) -> None:
        """Recover one lost producer task. Tier 1 (level=task): its spool
        is complete — swap a :class:`SpoolHandle` into remote_tasks so
        consumers read the durable copy; no re-execution at all (a fused
        unit's spool holds its unit-boundary output buffers, so the
        whole unit re-points as one handle). Tier 2: re-run only this
        producer on a healthy node, healing its own sources first —
        level=lineage for a plain fragment, level=fused when the lost
        producer is a fused unit re-executed atomically."""
        tasks = rc["remote_tasks"][fid]
        old = tasks[idx]
        store = rc.get("store")
        if (
            store is not None
            and rc.get("base_uri")
            and store.is_complete(old.task_id)
        ):
            self._spool_repoint(fid, idx, rc)
            return
        frag = rc["fragments"].get(fid)
        if frag is not None:
            # the producer's own inputs may have died with the same node:
            # heal them first so the re-execution pulls live sources
            self._heal_sources(frag, rc, probe=probe)
        self._run_recovery_task(fid, idx, rc)

    def _spool_repoint(self, fid: int, idx: int, rc: dict) -> None:
        """Swap a :class:`SpoolHandle` over a lost-but-fully-spooled
        attempt in remote_tasks (level=task — zero re-execution). The
        caller has already established ``store.is_complete(task_id)``."""
        tasks = rc["remote_tasks"][fid]
        old = tasks[idx]
        stats = rc["stats"]
        stage_span = (rc.get("obs") or {}).get("stage_spans", {}).get(fid)
        handle = SpoolHandle(rc["base_uri"], old.task_id)
        handle.payload = old.payload
        handle.attempt = getattr(old, "attempt", 1)
        tasks[idx] = handle
        self.node_scheduler.release(old.node)
        get_registry().counter(
            "trino_tpu_recovered_tasks_total", level="task"
        ).inc()
        stats["recovered_tasks"] = stats.get("recovered_tasks", 0) + 1
        levels = stats.setdefault("recovered_levels", {})
        levels["task"] = levels.get("task", 0) + 1
        # synthetic zero-length attempt span: the waterfall shows the
        # recovery point without pretending work re-ran
        span = get_tracer().start_span(
            "task_attempt",
            trace_id=getattr(stage_span, "trace_id", None),
            parent_id=getattr(stage_span, "span_id", None),
            attrs={
                "taskId": old.task_id,
                "stage": fid,
                "worker": "__spool__",
                "attempt": handle.attempt,
                "recovered": True,
                "spool": True,
                "fused": (rc.get("units") or {}).get(fid) is not None,
            },
        )
        span.finish(status="OK", state="FINISHED")

    def _run_recovery_task(self, fid: int, idx: int, rc: dict,
                           max_attempts: int = 3) -> None:
        """Re-execute one lost producer task to completion (lineage tier).
        Runs synchronously — recovery sits on a consumer's critical path
        anyway. Task ids take an ``l{k}`` suffix (fresh injection sites,
        distinct from ``r``etries and ``s``peculation). A fused unit
        re-executes atomically — its payload still carries the whole
        member chain, the worker re-traces through the fused program
        cache — and counts at level=fused (``{qid}.{unit}.{i}l{k}``)."""
        from trino_tpu_torch.ft.retry import (
            TaskFailure,
            TaskRetriesExhausted,
            is_retryable,
        )

        tasks = rc["remote_tasks"][fid]
        frag = rc["fragments"].get(fid)
        session = rc["session"]
        stats = rc["stats"]
        try:
            budget_s = float(session.get("exchange_timeout_s"))
        except KeyError:
            budget_s = 300.0
        stage_span = (rc.get("obs") or {}).get("stage_spans", {}).get(fid)
        is_unit = (rc.get("units") or {}).get(fid) is not None
        level = "fused" if is_unit else "lineage"
        exclude = tasks[idx].node.node_id
        last_error: Optional[str] = None
        for _ in range(max_attempts):
            old = tasks[idx]
            k = next(rc["lineage_seq"])
            node = self._retry_node(exclude=exclude)
            new_id = f"{rc['query_id']}.{fid}.{idx}l{k}"
            payload = dict(old.payload)
            if frag is not None:
                # sources rebuilt NOW: they may point at spool handles or
                # other just-recovered attempts
                payload["sources"] = self._rebuild_sources(frag, idx, rc)
            task = HttpRemoteTask(node, new_id, payload, **rc["http"])
            task.attempt = getattr(old, "attempt", 1) + 1
            task.recovered = True
            att = get_tracer().start_span(
                "task_attempt",
                trace_id=getattr(stage_span, "trace_id", None),
                parent_id=getattr(stage_span, "span_id", None),
                attrs={
                    "taskId": new_id,
                    "stage": fid,
                    "worker": node.node_id,
                    "attempt": task.attempt,
                    "recovered": True,
                    "lineage": True,
                    "fused": is_unit,
                },
            )
            task.span = att
            task.trace = att.context()
            # swap in before start(): query-level cleanup releases whatever
            # sits in remote_tasks; the dead attempt's slot frees here
            tasks[idx] = task
            self.node_scheduler.release(old.node)
            deadline = time.monotonic() + budget_s
            failed_st: Optional[dict] = None
            try:
                task.start()
                while True:
                    st = task.status(max_wait=1.0)
                    state = st.get("state")
                    if state == "FINISHED":
                        self._finish_attempt(
                            rc["query_id"], fid, task, st, rc.get("obs")
                        )
                        get_registry().counter(
                            "trino_tpu_recovered_tasks_total", level=level
                        ).inc()
                        stats["recovered_tasks"] = (
                            stats.get("recovered_tasks", 0) + 1
                        )
                        levels = stats.setdefault("recovered_levels", {})
                        levels[level] = levels.get(level, 0) + 1
                        return
                    if state == "FAILED":
                        r = st.get("retryable")
                        if r is not None and not bool(r):
                            self._finish_attempt(
                                rc["query_id"], fid, task, st, rc.get("obs")
                            )
                            raise TaskFailure(
                                new_id, node.node_id, st.get("error"),
                                retryable=False,
                            )
                        failed_st, last_error = st, st.get("error")
                        break
                    if time.monotonic() > deadline:
                        last_error = (
                            f"lineage recovery exceeded {budget_s}s budget"
                        )
                        failed_st = {"state": "FAILED", "error": last_error}
                        break
            except TaskFailure:
                raise
            except Exception as e:  # noqa: BLE001
                if not is_retryable(e):
                    raise
                last_error = str(e)
                failed_st = {"state": "FAILED", "error": last_error}
            task.cancel()
            self._finish_attempt(
                rc["query_id"], fid, task, failed_st, rc.get("obs")
            )
            exclude = node.node_id
        raise TaskRetriesExhausted(
            f"{rc['query_id']}.{fid}.{idx}",
            exclude,
            f"lineage recovery failed: {last_error}",
            max_attempts,
        )

    def _await_fragment(
        self,
        query_id: str,
        frag: PlanFragment,
        tasks: list[HttpRemoteTask],
        session: Session,
        stats: dict,
        http: dict,
        stage_span=None,
        obs: Optional[dict] = None,
        rc: Optional[dict] = None,
    ) -> None:
        """Block until every task of ``frag`` is FINISHED, re-dispatching
        failed attempts (``{qid}.{frag}.{p}`` -> ``...{p}r{k}``) to other
        workers with backoff, bounded by ``task_retry_attempts``.

        Speculation (``speculation=true``): once enough siblings have
        finished, a running attempt whose elapsed exceeds
        ``max(floor, multiplier * p99_of_completed_siblings)`` gets ONE
        duplicate (hedge) attempt (``...{p}s{k}``) on a different healthy
        node. First finisher wins and is swapped into ``tasks`` — under
        the stage barrier consumers only ever read the winner's URI, so
        the loser (cancelled with ``?speculative=true``, which aborts its
        output buffer) can never double-deliver pages. Concurrent hedges
        are capped per query by ``speculation_max_fraction``.

        Mutates ``tasks`` in place so consumers scheduled afterwards see
        the surviving attempt's URIs. Raises :class:`TaskFailure` for a
        fatal error, :class:`TaskRetriesExhausted` when the budget is
        spent (QUERY retry may still apply a level up)."""
        from trino_tpu_torch.ft.retry import (
            Backoff,
            TaskFailure,
            TaskRetriesExhausted,
            is_retryable,
        )

        try:
            max_attempts = max(1, int(session.get("task_retry_attempts")))
        except KeyError:
            max_attempts = 4
        try:
            stage_budget = float(session.get("exchange_timeout_s"))
        except KeyError:
            stage_budget = 300.0
        backoff = http.get("backoff") or Backoff.from_session(session)
        reg = get_registry()
        spec = (obs or {}).get("spec")
        attempts = [1] * len(tasks)
        # per-attempt deadline: a hung-but-responsive worker must not
        # stall the stage barrier forever — overrun counts as a
        # retryable attempt failure (monotonic: wall-clock jumps must not
        # spuriously expire the budget)
        deadlines = [time.monotonic() + stage_budget] * len(tasks)
        pending = set(range(len(tasks)))
        hedges: dict[int, HttpRemoteTask] = {}

        def _spec_counter(outcome: str) -> None:
            reg.counter(
                "trino_tpu_speculative_attempts_total", outcome=outcome
            ).inc()

        def _drop_hedge(i: int, h: HttpRemoteTask, st: dict,
                        outcome: str) -> None:
            """Resolve a hedge that did NOT win: cancel, release its node,
            close its attempt span, free budget."""
            hedges.pop(i, None)
            h.cancel(speculative=True)
            self.node_scheduler.release(h.node)
            self._finish_attempt(query_id, frag.id, h, st, obs)
            if obs is not None:
                obs["spec_active"] = max(0, obs.get("spec_active", 1) - 1)
            _spec_counter(outcome)

        def _dispatch_hedge(i: int, t: HttpRemoteTask, node: WorkerNode,
                            extra_attrs: dict) -> None:
            """Launch one hedge of ``tasks[i]`` on ``node`` (whose slot
            ``_speculation_node`` already reserved) and register it in
            ``hedges``. Shared by the straggler detector and the
            queued-task hedging path."""
            hedge_id = f"{query_id}.{frag.id}.{i}s{attempts[i]}"
            hedge = HttpRemoteTask(node, hedge_id, t.payload, **http)
            hedge.attempt = attempts[i]
            hedge.speculative = True
            att = get_tracer().start_span(
                "task_attempt",
                trace_id=getattr(stage_span, "trace_id", None),
                parent_id=getattr(stage_span, "span_id", None),
                attrs={
                    "taskId": hedge_id,
                    "stage": frag.id,
                    "worker": node.node_id,
                    "attempt": attempts[i],
                    "speculative": True,
                    "hedgeOf": t.task_id,
                    **extra_attrs,
                },
            )
            hedge.span = att
            hedge.trace = att.context()
            stats["speculative_attempts"] = (
                stats.get("speculative_attempts", 0) + 1
            )
            obs["spec_active"] = obs.get("spec_active", 0) + 1
            hedges[i] = hedge
            try:
                hedge.start()
            except Exception as e:  # noqa: BLE001
                if not is_retryable(e):
                    raise
                hedge.start_error = str(e)

        try:
            while pending:
                for i in sorted(pending):
                    t = tasks[i]
                    if t.start_error is not None:
                        # QUEUED-but-undispatched hedging: an attempt whose
                        # POST never landed is hedged immediately on a
                        # different healthy node (no straggler threshold —
                        # there is nothing running to outwait). The queued
                        # twin is cancelled when the hedge promotes, one
                        # poll round later.
                        if (
                            i not in hedges
                            and spec is not None
                            and spec.enabled
                            and obs is not None
                            and obs.get("spec_active", 0)
                            < obs.get("spec_budget", 0)
                            # promotion bumps attempts[i]; the cap keeps a
                            # cluster-wide dispatch outage from ping-ponging
                            # hedge->promote->hedge forever
                            and attempts[i] < max_attempts
                        ):
                            node = self._speculation_node(
                                exclude=t.node.node_id
                            )
                            if node is not None:
                                _dispatch_hedge(i, t, node, {"queued": True})
                                continue
                        failure, retryable = t.start_error, True
                        fail_st = {"state": "FAILED", "error": failure}
                    elif time.monotonic() > deadlines[i]:
                        failure = f"task attempt exceeded {stage_budget}s stage budget"
                        retryable = True
                        fail_st = {"state": "FAILED", "error": failure}
                    else:
                        try:
                            # a hedged straggler gets a short poll: the
                            # 1s long-poll would delay noticing the hedge
                            # finishing first by a full status round
                            st = t.status(
                                max_wait=0.05 if i in hedges else 1.0
                            )
                        except Exception as e:  # noqa: BLE001
                            if not is_retryable(e):
                                raise
                            # worker unreachable through all HTTP retries:
                            # treat the attempt as lost
                            failure, retryable = f"unreachable: {e}", True
                            fail_st = {"state": "FAILED", "error": failure}
                        else:
                            state = st.get("state")
                            if state == "FINISHED":
                                h = hedges.get(i)
                                if h is not None:
                                    # primary beat its hedge: the loser's
                                    # buffer is aborted before consumers
                                    # ever learn its URI
                                    _drop_hedge(
                                        i, h,
                                        {
                                            "state": "CANCELED_SPECULATIVE",
                                            "elapsed": h.elapsed_ms() / 1000.0,
                                        },
                                        outcome="cancelled",
                                    )
                                self._finish_attempt(query_id, frag.id, t, st, obs)
                                pending.discard(i)
                                continue
                            if state != "FAILED":
                                continue  # still queued/running
                            failure = st.get("error")
                            r = st.get("retryable")
                            retryable = True if r is None else bool(r)
                            fail_st = st
                    self._finish_attempt(query_id, frag.id, t, fail_st, obs)
                    if not retryable:
                        raise TaskFailure(
                            t.task_id, t.node.node_id, failure, retryable=False
                        )
                    if (
                        rc is not None
                        and rc.get("store") is not None
                        and rc.get("base_uri")
                        and rc["store"].is_complete(t.task_id)
                    ):
                        # stage-barrier spool re-point: the attempt (e.g. a
                        # single-task fused unit whose worker was killed
                        # right after finishing) is lost but its output
                        # spooled completely — the durable copy IS the
                        # attempt's output, so swap in a SpoolHandle and
                        # close the slot without re-running anything
                        h = hedges.get(i)
                        if h is not None:
                            _drop_hedge(
                                i, h, {"state": "CANCELED_SPECULATIVE"},
                                outcome="cancelled",
                            )
                        t.cancel()
                        self._spool_repoint(frag.id, i, rc)
                        pending.discard(i)
                        continue
                    h = hedges.pop(i, None)
                    if h is not None:
                        # the primary died while its hedge is in flight:
                        # promote the hedge instead of dispatching a fresh
                        # retry (the duplicate work is already running)
                        t.cancel()
                        self.node_scheduler.release(t.node)
                        attempts[i] += 1
                        stats.setdefault("task_attempts", {})[
                            f"{query_id}.{frag.id}.{i}"
                        ] = attempts[i]
                        if obs is not None:
                            obs["spec_active"] = max(
                                0, obs.get("spec_active", 1) - 1
                            )
                        tasks[i] = h
                        deadlines[i] = time.monotonic() + stage_budget
                        continue
                    if attempts[i] >= max_attempts:
                        raise TaskRetriesExhausted(
                            t.task_id, t.node.node_id, failure, attempts[i]
                        )
                    # release the failed attempt, back off, re-dispatch
                    t.cancel()
                    self.node_scheduler.release(t.node)
                    time.sleep(backoff.delay(attempts[i]))
                    payload = t.payload
                    if rc is not None:
                        # the failure may be the symptom of a dead
                        # producer: probe this fragment's sources, recover
                        # lost ones (spool re-point / lineage
                        # re-execution), and rebuild the source URIs the
                        # retry will pull — remote_tasks may now hold
                        # spool handles or recovered attempts
                        self._heal_sources(frag, rc, probe=True)
                        payload = dict(t.payload)
                        payload["sources"] = self._rebuild_sources(frag, i, rc)
                    node = self._retry_node(exclude=t.node.node_id)
                    attempts[i] += 1
                    base = f"{query_id}.{frag.id}.{i}"
                    new_id = f"{base}r{attempts[i] - 1}"
                    stats["task_retries"] = stats.get("task_retries", 0) + 1
                    stats.setdefault("task_attempts", {})[base] = attempts[i]
                    reg.counter("trino_tpu_task_retries_total").inc()
                    retry = HttpRemoteTask(node, new_id, payload, **http)
                    retry.attempt = attempts[i]
                    att = get_tracer().start_span(
                        "task_attempt",
                        trace_id=getattr(stage_span, "trace_id", None),
                        parent_id=getattr(stage_span, "span_id", None),
                        attrs={
                            "taskId": new_id,
                            "stage": frag.id,
                            "worker": node.node_id,
                            "attempt": attempts[i],
                            "retry": True,
                        },
                    )
                    retry.span = att
                    retry.trace = att.context()
                    # swap in before start(): the query-level cleanup releases
                    # whatever sits in ``tasks``, and the old node is released
                    tasks[i] = retry
                    deadlines[i] = time.monotonic() + stage_budget
                    try:
                        retry.start()
                    except Exception as e:  # noqa: BLE001
                        if not is_retryable(e):
                            raise
                        retry.start_error = str(e)

                # --- hedge polling: first finisher wins -------------------
                for i, h in list(hedges.items()):
                    if i not in pending:
                        continue
                    if h.start_error is not None:
                        hst = {"state": "FAILED", "error": h.start_error}
                    else:
                        try:
                            hst = h.status(max_wait=0.0)
                        except Exception as e:  # noqa: BLE001
                            if not is_retryable(e):
                                raise
                            hst = {"state": "FAILED", "error": f"unreachable: {e}"}
                    state = hst.get("state")
                    if state == "FINISHED":
                        # hedge wins: swap it in as the surviving attempt and
                        # speculatively cancel the straggling primary (its
                        # buffer aborts, so it can never deliver a page)
                        primary = tasks[i]
                        hedges.pop(i)
                        primary.cancel(speculative=True)
                        self._finish_attempt(
                            query_id, frag.id, primary,
                            {
                                "state": "CANCELED_SPECULATIVE",
                                "elapsed": primary.elapsed_ms() / 1000.0,
                            },
                            obs,
                        )
                        self.node_scheduler.release(primary.node)
                        tasks[i] = h
                        if obs is not None:
                            obs["spec_active"] = max(
                                0, obs.get("spec_active", 1) - 1
                            )
                        stats["speculative_wins"] = (
                            stats.get("speculative_wins", 0) + 1
                        )
                        _spec_counter("won")
                        _spec_counter("cancelled")  # the loser's cancel
                        self._finish_attempt(query_id, frag.id, h, hst, obs)
                        pending.discard(i)
                    elif state == "FAILED":
                        # hedge died on its own; the primary keeps running
                        # (no retry of a hedge — it was a bet, not a need)
                        _drop_hedge(i, h, hst, outcome="lost")

                # --- straggler detection -> hedge dispatch ----------------
                if (
                    spec is not None
                    and spec.enabled
                    and pending
                    and obs is not None
                    and obs.get("spec_active", 0) < obs.get("spec_budget", 0)
                ):
                    samples = obs["elapsed"].get(frag.id, [])
                    if (
                        len(tasks) == 1
                        and len(samples) < getattr(spec, "min_completed", 1)
                        and tasks[0].payload.get("fused_fragments")
                    ):
                        # a fused unit is a single-task stage — it has no
                        # siblings to threshold against, so borrow the
                        # query-wide completed-attempt samples (earlier
                        # stages/units of this query) for the p99
                        samples = [
                            v for vs in obs["elapsed"].values() for v in vs
                        ]
                    threshold = spec.threshold_ms(samples)
                    if threshold is not None:
                        for i in sorted(pending):
                            if i in hedges:
                                continue
                            t = tasks[i]
                            if (
                                t.start_error is not None
                                or t.elapsed_ms() <= threshold
                            ):
                                continue
                            node = self._speculation_node(
                                exclude=t.node.node_id
                            )
                            if node is None:
                                continue  # no distinct healthy node
                            _dispatch_hedge(
                                i, t, node,
                                {"thresholdMs": round(threshold, 1)},
                            )
                            if obs["spec_active"] >= obs["spec_budget"]:
                                break
        finally:
            # a raising exit (fatal failure, retries exhausted) leaves
            # hedges in flight; they are not in ``tasks``, so the
            # query-level cleanup would never cancel or release them
            for i, h in list(hedges.items()):
                _drop_hedge(
                    i, h, {"state": "CANCELED_SPECULATIVE"}, outcome="cancelled"
                )

    # --- per-attempt / per-query observability rollup ---------------------

    def _finish_attempt(
        self,
        query_id: str,
        frag_id: int,
        t: HttpRemoteTask,
        st: Optional[dict],
        obs: Optional[dict],
    ) -> None:
        """Close one dispatch attempt: span, counters, sibling-elapsed
        sample, TaskCompletedEvent. Idempotent per attempt — the stage
        barrier, _first_failed_status, and the end-of-query finalize can
        each observe the same task."""
        if t._obs_done:
            return
        t._obs_done = True
        st = st or {}
        state = st.get("state") or "UNKNOWN"
        elapsed_ms = float(st.get("elapsed") or 0.0) * 1000.0
        reg = get_registry()
        reg.counter("trino_tpu_tasks_total", state=state).inc()
        if state == "FINISHED":
            # sibling elapsed within a stage feeds the p50/p99 rollup the
            # speculation detector thresholds on
            if obs is not None:
                obs["elapsed"].setdefault(frag_id, []).append(elapsed_ms)
            reg.histogram(
                # fragment ids restart at 0 per plan: a bounded domain
                "trino_tpu_task_elapsed_ms", stage=str(frag_id)  # lint: ignore[OBS001]
            ).observe(elapsed_ms)
        if t.span is not None:
            attrs = {"state": state, "elapsedMs": elapsed_ms}
            if t.speculative:
                attrs["speculative"] = True
            if getattr(t, "recovered", False):
                attrs["recovered"] = True
            if st.get("error"):
                attrs["error"] = st.get("error")
            # a speculatively-cancelled loser is not an error: a sibling
            # simply finished first (rendered distinctly in the waterfall)
            if state == "FINISHED":
                status = "OK"
            elif state == "CANCELED_SPECULATIVE":
                status = "CANCELED"
            else:
                status = "ERROR"
            t.span.finish(status=status, **attrs)
        listeners = getattr(self.engine, "event_listeners", None)
        if listeners is not None:
            listeners.fire_task_completed(
                TaskCompletedEvent(
                    query_id=query_id,
                    stage_id=frag_id,
                    task_id=t.task_id,
                    worker=t.node.node_id,
                    state=state,
                    attempt=t.attempt,
                    elapsed_ms=elapsed_ms,
                    error_message=st.get("error"),
                    speculative=t.speculative,
                )
            )

    def _finalize_query(
        self,
        query_id: str,
        stats: dict,
        remote_tasks: dict[int, list[HttpRemoteTask]],
        task_counts: dict[int, int],
        obs: dict,
        ok: bool,
    ) -> None:
        """End-of-query rollup (runs on success AND failure, tracer on or
        off): close remaining attempt spans, close stage spans, observe
        stage metrics, fire stage events, and build ``stats['stages']``
        (elapsedMs + sibling task p50/p99) for queryStats."""
        for fid, tasks in remote_tasks.items():
            for t in tasks:
                if t._obs_done:
                    continue
                st = t.last_status
                terminal = st is not None and st.get("state") in (
                    "FINISHED", "FAILED", "CANCELED", "CANCELED_SPECULATIVE",
                )
                if ok and not terminal:
                    # one best-effort poll only on the success path — a
                    # failed query may have unreachable workers
                    try:
                        st = t.status()
                    except Exception:  # noqa: BLE001
                        pass
                self._finish_attempt(query_id, fid, t, st, obs)
        reg = get_registry()
        listeners = getattr(self.engine, "event_listeners", None)
        task_attempts = stats.get("task_attempts", {})
        now = time.monotonic()
        stages = []
        query_programs: dict[str, dict] = {}
        for fid in sorted(obs["stage_spans"]):
            start = obs["stage_start"].get(fid)
            elapsed_ms = (now - start) * 1000.0 if start is not None else 0.0
            n_tasks = task_counts.get(fid, 0)
            # retries recorded as {query_id}.{fid}.{i} -> total attempts
            extra = 0
            for base, a in task_attempts.items():
                rest = base[len(query_id) + 1:] if base.startswith(
                    query_id + "."
                ) else ""
                if rest.split(".", 1)[0] == str(fid):
                    extra += a - 1
            n_attempts = n_tasks + extra
            entry = {
                "stage": fid,
                "tasks": n_tasks,
                "attempts": n_attempts,
                "elapsedMs": elapsed_ms,
            }
            vals = obs["elapsed"].get(fid, [])
            if vals:
                entry["taskElapsedMs"] = {
                    "count": len(vals),
                    "p50": percentile(vals, 50),
                    "p99": percentile(vals, 99),
                    "max": max(vals),
                }
            self._merge_stage_task_stats(
                entry, remote_tasks.get(fid, []), query_programs
            )
            stages.append(entry)
            reg.histogram(
                # fragment ids restart at 0 per plan: a bounded domain
                "trino_tpu_stage_elapsed_ms", stage=str(fid)  # lint: ignore[OBS001]
            ).observe(elapsed_ms)
            obs["stage_spans"][fid].finish(
                status="OK" if ok else "ERROR",
                tasks=n_tasks,
                attempts=n_attempts,
            )
            if listeners is not None:
                listeners.fire_stage_completed(
                    StageCompletedEvent(
                        query_id=query_id,
                        stage_id=fid,
                        state="FINISHED" if ok else "FAILED",
                        tasks=n_tasks,
                        attempts=n_attempts,
                        elapsed_ms=elapsed_ms,
                        task_elapsed_p50_ms=percentile(vals, 50),
                        task_elapsed_p99_ms=percentile(vals, 99),
                    )
                )
        stats["stages"] = stages
        # query-level exchange rollup for /v1/query parity with local
        # mode: sum worker-shipped counters across stages, but take
        # dispatchRoundTrips from the coordinator's own accounting — one
        # per task POST attempt — since worker-side values also count
        # retried attempts whose work was discarded
        exchange_totals: dict = {}
        total_caps: dict = {}
        join_strategy: dict = {}
        total_operators: dict = {}
        for entry in stages:
            for k, v in (entry.get("exchange") or {}).items():
                if k == "capacities" and isinstance(v, dict):
                    total_caps.update(v)  # site names are per-stage unique
                elif k == "joinStrategy" and isinstance(v, dict):
                    join_strategy.update(v)  # ditto: densejoin@{fid}#{ord}
                elif k == "operators" and isinstance(v, dict):
                    total_operators.update(v)  # ditto: scan@{fid}#{ord}
                elif k != "padding_ratio" and isinstance(
                    v, (int, float)
                ) and not isinstance(v, bool):
                    exchange_totals[k] = exchange_totals.get(k, 0) + v
        if total_caps:
            exchange_totals["capacities"] = total_caps
        if join_strategy:
            exchange_totals["joinStrategy"] = join_strategy
        if total_operators:
            exchange_totals["operators"] = total_operators
        round_trips = sum(e.get("attempts", 0) for e in stages)
        if exchange_totals or round_trips:
            exchange_totals["dispatchRoundTrips"] = round_trips
            if exchange_totals.get("shuffle_rows"):
                exchange_totals["padding_ratio"] = round(
                    exchange_totals.get("padded_shuffle_rows", 0)
                    / max(1, exchange_totals["shuffle_rows"]),
                    4,
                )
            stats["exchangeStats"] = exchange_totals
        # ingest rollup: decode/H2D/table-cache counters summed per stage
        ingest_totals: dict = {}
        for entry in stages:
            for k, v in (entry.get("ingest") or {}).items():
                ingest_totals[k] = round(ingest_totals.get(k, 0) + v, 3)
        if ingest_totals:
            stats["ingestStats"] = ingest_totals
        page_totals: dict = {}
        for entry in stages:
            for k, v in (entry.get("pages") or {}).items():
                page_totals[k] = round(page_totals.get(k, 0) + v, 3)
        if page_totals:
            stats["pageStats"] = page_totals
        kernel_totals: dict = {}
        for entry in stages:
            for k, v in (entry.get("kernelLaunches") or {}).items():
                kernel_totals[k] = kernel_totals.get(k, 0) + v
        if kernel_totals:
            # the workers' hand-kernel launches, FINISHED tasks only
            stats["kernelLaunches"] = kernel_totals
        if query_programs:
            from trino_tpu_torch.obs.profiler import rollup_device_stats

            ds = rollup_device_stats(query_programs)
            ds["programs"] = query_programs
            stats["deviceStats"] = ds

    @staticmethod
    def _merge_stage_task_stats(
        entry: dict,
        tasks: list[HttpRemoteTask],
        query_programs: dict[str, dict],
    ) -> None:
        """Merge every FINISHED sibling task's shipped stats (rows, bytes,
        compile, exchange counters, device profiler snapshot —
        ``server/task.py::SqlTask.info``) into one stage entry, and fold
        the per-program device stats into the query-level accumulator.
        Non-FINISHED attempts (failed, speculative losers) are skipped so
        a retried partition counts once."""
        from trino_tpu_torch.obs.profiler import merge_device_stats

        rows = in_rows = out_bytes = in_bytes = 0
        have_rows = have_in = have_bytes = False
        compile_ms = flops = 0.0
        have_flops = have_peak = False
        peak = 0
        exchange: dict = {}
        exchange_caps: dict = {}
        exchange_join: dict = {}
        exchange_ops: dict = {}
        ingest: dict = {}
        pages: dict = {}
        paths: dict = {}
        fused_errors: list = []
        kernels: dict = {}
        for t in tasks:
            st = t.last_status or {}
            if st.get("state") != "FINISHED":
                continue
            ts = st.get("stats") or {}
            path = st.get("executionPath")
            if path:
                paths[path] = paths.get(path, 0) + 1
            if ts.get("fused_error"):
                # why a task left the fused path for the interpreter
                fused_errors.append(ts["fused_error"])
            for k, v in (ts.get("kernel_launches") or {}).items():
                kernels[k] = kernels.get(k, 0) + int(v)
            # the output's device-to-host read, its serialization into
            # pages and the pages' bytes (server/task.py::SqlTask._emit)
            for k in _PAGE_STATS:
                if isinstance(ts.get(k), (int, float)):
                    pages[k] = round(pages.get(k, 0) + ts[k], 3)
            if "output_rows" in ts:
                have_rows = True
                rows += int(ts["output_rows"])
            if "input_rows" in ts:
                have_in = True
                in_rows += int(ts["input_rows"])
            if "output_bytes" in ts:
                have_bytes = True
                out_bytes += int(ts["output_bytes"])
            if "input_bytes" in ts:
                in_bytes += int(ts["input_bytes"])
            compile_ms += float((ts.get("compile") or {}).get("compile_ms", 0.0))
            for k, v in (ts.get("exchange") or {}).items():
                # ratios/capacity maps don't sum — recomputed/unioned below
                if k != "padding_ratio" and isinstance(
                    v, (int, float)
                ) and not isinstance(v, bool):
                    exchange[k] = exchange.get(k, 0) + v
            # capacity sites union across sibling tasks (same program,
            # same sites): keep the largest observed value per site so
            # the stage view and the web-UI provenance column reflect
            # the worst-case (final) shape
            for name, ent in ((ts.get("exchange") or {}).get(
                "capacities"
            ) or {}).items():
                if not isinstance(ent, dict):
                    continue
                old = exchange_caps.get(name)
                if old is None or int(ent.get("value", 0) or 0) >= int(
                    old.get("value", 0) or 0
                ):
                    exchange_caps[name] = ent
            # join sites are per-stage unique, same strategy on every
            # sibling task — a plain union is exact
            js = (ts.get("exchange") or {}).get("joinStrategy")
            if isinstance(js, dict):
                exchange_join.update(js)
            # operator row counters sum across sibling tasks: each task
            # saw a disjoint partition of the stage's rows
            for site, ent in ((ts.get("exchange") or {}).get(
                "operators"
            ) or {}).items():
                if not isinstance(ent, dict):
                    continue
                acc = exchange_ops.get(site)
                if acc is None:
                    acc = exchange_ops[site] = {
                        "kind": ent.get("kind", ""),
                        "rows_in": 0,
                        "rows_out": 0,
                    }
                acc["rows_in"] += int(ent.get("rows_in", 0) or 0)
                acc["rows_out"] += int(ent.get("rows_out", 0) or 0)
            for k, v in (ts.get("ingest") or {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    ingest[k] = ingest.get(k, 0) + v
            ds = ts.get("deviceStats") or {}
            merge_device_stats(query_programs, ds.get("programs"))
            if ds.get("total_flops") is not None:
                have_flops = True
                flops += float(ds["total_flops"])
            if ds.get("peak_hbm_bytes") is not None:
                have_peak = True
                peak = max(peak, int(ds["peak_hbm_bytes"]))
        if have_rows:
            entry["rows"] = rows
        if have_in:
            entry["inputRows"] = in_rows
        if have_bytes:
            entry["outputBytes"] = out_bytes
            entry["inputBytes"] = in_bytes
        if compile_ms:
            entry["compileMs"] = round(compile_ms, 3)
        if exchange_caps:
            exchange["capacities"] = exchange_caps
        if exchange_join:
            exchange["joinStrategy"] = exchange_join
        if exchange_ops:
            exchange["operators"] = exchange_ops
        if exchange:
            if exchange.get("shuffle_rows"):
                exchange["padding_ratio"] = round(
                    exchange.get("padded_shuffle_rows", 0)
                    / max(1, exchange["shuffle_rows"]),
                    4,
                )
            entry["exchange"] = exchange
        if ingest:
            entry["ingest"] = ingest
        if pages:
            entry["pages"] = pages
        if paths:
            entry["executionPaths"] = paths
        if fused_errors:
            entry["fusedErrors"] = fused_errors
        if kernels:
            entry["kernelLaunches"] = kernels
        if have_flops:
            entry["flops"] = flops
        if have_peak:
            entry["peakHbmBytes"] = peak

    # --- root fragment on the coordinator --------------------------------

    def _execute_root(
        self,
        frag: PlanFragment,
        session: Session,
        remote_tasks: dict[int, list[HttpRemoteTask]],
        task_counts: dict[int, int],
        policy: str = "NONE",
        rc: Optional[dict] = None,
    ):
        from trino_tpu_torch.ft.retry import RetryPolicy, TaskFailure
        from trino_tpu_torch.server.task import WorkerExecutor

        root = frag.root
        # A producer can die between the stage barrier and the root pull.
        # With spooling (rc set) heal the lost producers and re-pull; the
        # sources dict is rebuilt each attempt so SpoolHandle / lineage
        # re-execution URIs are picked up automatically.
        attempts = 3 if rc is not None else 1
        batch = names = None
        for attempt in range(attempts):
            sources = {
                fid: {"locations": [t.uri for t in tasks], "partition": 0}
                for fid, tasks in remote_tasks.items()
                if fid in frag.source_fragment_ids
            }
            local_session = Session(
                user=session.user, catalog=session.catalog, schema=session.schema
            )
            for k, v in session.properties.items():
                if k != "execution_mode":
                    local_session.properties[k] = v
            # splits None: the root's own table scans read every split
            # here (the reference passes none, and reads nothing)
            executor = WorkerExecutor(
                self.engine.catalogs, local_session, None, sources,
                device=self.engine.device,
            )
            try:
                if isinstance(root, P.Output):
                    batch, names = executor.execute(root)
                else:
                    res = executor._exec(root)
                    batch = res.batch.compact()
                    names = [s.name for s in root.output_symbols]
                break
            except Exception as e:  # noqa: BLE001
                if rc is not None and attempt < attempts - 1:
                    if self._heal_sources(frag, rc, probe=True):
                        continue
                # the coordinator-side symptom (empty exchange, timeout) is
                # usually downstream of a worker task failure — surface the
                # root cause with the worker's retryable classification
                failed = self._first_failed_status(remote_tasks)
                if failed is not None:
                    t, st = failed
                    raise TaskFailure(
                        st.get("taskId") or t.task_id,
                        t.node.node_id,
                        st.get("error"),
                        retryable=bool(st.get("retryable", True)),
                    ) from e
                raise
        # surface any worker failure even if results looked complete; the
        # TASK stage barrier already verified every producer FINISHED
        if policy != RetryPolicy.TASK:
            failed = self._first_failed_status(remote_tasks)
            if failed is not None:
                t, st = failed
                raise TaskFailure(
                    st.get("taskId") or t.task_id,
                    t.node.node_id,
                    st.get("error"),
                    retryable=bool(st.get("retryable", True)),
                )
        return batch, names

    @staticmethod
    def _first_failed_status(
        remote_tasks: dict[int, list[HttpRemoteTask]],
    ) -> Optional[tuple[HttpRemoteTask, dict]]:
        for tasks in remote_tasks.values():
            for t in tasks:
                try:
                    st = t.status()
                except Exception:  # noqa: BLE001 - unreachable worker
                    continue
                if st.get("state") == "FAILED":
                    return t, st
        return None
