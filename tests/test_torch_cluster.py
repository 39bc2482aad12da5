"""The cluster tier through trino_tpu_torch on the CPU: a coordinator and
two worker processes (``python -m trino_tpu_torch.server.main``), HTTP
task dispatch, page exchange, discovery and failure detection.

The cases are the reference's ``tests/test_cluster.py``,
``test_fusion.py::TestClusterFusion``, ``test_map_row.py``'s cluster case
and ``test_observability.py::TestDistributedSpans`` /
``TestDistributedDeviceStats``, run against the port's cluster. Rows are
held against the reference's ``LocalQueryRunner`` (JAX on the CPU) or its
committed ``tpch.tiny`` answers, exactly; the scheduler's node picks and
launch order against the reference's classes on the same inputs. One
cluster serves the module; no reference cluster is booted.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from torch_cluster_fixtures import (
    cluster_timeline,
    execute_with_id,
    get_json,
    get_text,
    query_id_for,
    query_info_by_id,
    query_info_for,
    worker_tasks,
)


@pytest.fixture(scope="module")
def cluster():
    from trino_tpu_torch.testing import MultiProcessQueryRunner

    # ``split``: tpch with 2,000-row splits, so tiny tables spread over
    # both workers' tasks
    with MultiProcessQueryRunner(n_workers=2, device="cpu",
                                 catalogs=["split=tpch:2000"]) as runner:
        yield runner


@pytest.fixture(scope="module")
def ref_local():
    from trino_tpu.testing import LocalQueryRunner as RefRunner

    return RefRunner()


def check(cluster, ref_local, sql, props=None):
    crows, _ = cluster.execute(sql, session_properties=props)
    lrows, _ = ref_local.execute(sql)
    assert crows == lrows, (
        f"cluster != reference for {sql}\ncluster: {crows[:5]}\nreference: {lrows[:5]}"
    )
    return crows


# the reference's TestClusterQueries, its map_row case and the fused
# strict query: rows equal the reference's LocalQueryRunner
QUERIES = {
    "scan_count": "select count(*) from lineitem",
    "grouped_agg": """select l_returnflag, l_linestatus, sum(l_quantity), count(*),
               avg(l_extendedprice) from lineitem
               where l_shipdate <= date '1998-09-02'
               group by l_returnflag, l_linestatus
               order by l_returnflag, l_linestatus""",
    "broadcast_join": """select o_orderpriority, count(*) from orders
               join lineitem on l_orderkey = o_orderkey
               where o_orderdate < date '1995-06-01'
               group by o_orderpriority order by o_orderpriority""",
    "topn": "select o_orderkey, o_totalprice from orders"
            " order by o_totalprice desc, o_orderkey limit 10",
    "global_agg_min_max": "select count(*), min(l_shipdate), max(l_shipdate), sum(l_quantity)"
                          " from lineitem",
    "tpch_q6": """select sum(l_extendedprice * l_discount) as revenue
               from lineitem
               where l_shipdate >= date '1994-01-01'
                 and l_shipdate < date '1995-01-01'
                 and l_discount between decimal '0.05' and decimal '0.07'
                 and l_quantity < 24""",
    "tpch_q3_shape": """select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
                      o_orderdate, o_shippriority
               from customer, orders, lineitem
               where c_mktsegment = 'BUILDING'
                 and c_custkey = o_custkey and l_orderkey = o_orderkey
                 and o_orderdate < date '1995-03-15'
                 and l_shipdate > date '1995-03-15'
               group by l_orderkey, o_orderdate, o_shippriority
               order by revenue desc, o_orderdate limit 10""",
    "string_functions_cross_wire": """select o_orderstatus, min(o_orderpriority),
               max(o_orderpriority) from orders group by o_orderstatus order by o_orderstatus""",
    "arrays_cross_process_exchange": (
        "select o_orderstatus, array_agg(o_orderpriority)"
        " from (select * from orders order by o_orderkey limit 10) x"
        " group by o_orderstatus order by o_orderstatus"),
    "client_statement_endpoint_stays_open": "select count(*) from region",
}


@pytest.mark.parametrize("part", [0, 1, 2])
def test_cluster_queries_equal_the_reference(cluster, ref_local, part):
    """Each query of a third of :data:`QUERIES` (three cases, so three
    test processes share the reference's compiles)."""
    for name in sorted(QUERIES)[part::3]:
        check(cluster, ref_local, QUERIES[name])


def test_strict_fusable_query_succeeds(cluster, ref_local):
    """``worker_execution=fused_strict`` runs a fusable query; its rows and
    the default mode's equal the reference's."""
    sql = """select l_returnflag, count(*), sum(l_quantity)
             from lineitem group by l_returnflag order by l_returnflag"""
    strict, _ = cluster.execute(sql, session_properties={"worker_execution": "fused_strict"})
    default = check(cluster, ref_local, sql)
    assert strict == default and len(strict) == 3


@pytest.mark.parametrize("half", [0, 1])
def test_tpch_tiny_over_the_cluster_equals_the_committed_answers(cluster, half):
    """The 22 TPC-H queries at ``tpch.tiny`` in ``execution_mode=cluster``
    give the reference's committed rows and column types (two cases of
    eleven queries, so two test processes share them)."""
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.benchmarks.tpch import queries
    from trino_tpu_torch.testing import LocalQueryRunner

    answers = B.load_answers(
        B.ANSWERS_SF1.replace("tpch_sf1_answers", "tpch_tiny_answers"))["queries"]
    planner = LocalQueryRunner(device="cpu")
    for q in range(1 + 11 * half, 12 + 11 * half):
        sql = queries("tpch.tiny")[q]
        rows, _ = cluster.execute(sql)
        bad = B.first_mismatch(
            B.canonical_rows(rows), answers[str(q)]["rows"],
            B.order_positions(planner.plan(sql)),
        )
        assert bad is None, f"Q{q}: {bad}"


@pytest.mark.parametrize("q", [3, 10, 18, 21])
def test_tpch_over_many_splits_equals_the_committed_answers(cluster, q):
    """With 2,000-row splits every task of a scan fragment reads a part
    of each table. A join of two scans inside one fragment (Q10's
    customer and orders) reads its build side whole in every task, so
    the rows stay the committed answers' (the reference splits both
    sides and loses the pairs that land in different tasks)."""
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.benchmarks.tpch import queries
    from trino_tpu_torch.testing import LocalQueryRunner

    answers = B.load_answers(
        B.ANSWERS_SF1.replace("tpch_sf1_answers", "tpch_tiny_answers"))["queries"]
    sql = queries("split.tiny")[q]
    rows, _ = cluster.execute(sql)
    bad = B.first_mismatch(B.canonical_rows(rows), answers[str(q)]["rows"],
                           B.order_positions(LocalQueryRunner(device="cpu").plan(
                               queries("tpch.tiny")[q])))
    assert bad is None, f"Q{q}: {bad}"


def test_tasks_ran_fused(cluster):
    """Worker tasks execute eligible fragments through the fragment
    executor's programs (``fused`` or ``fused-pipeline``), not the
    interpreter, and ship their page and ingest counters."""
    before = set(worker_tasks(cluster))
    rows, _ = cluster.execute("""select o_orderpriority, count(*) from orders
               join lineitem on l_orderkey = o_orderkey
               group by o_orderpriority order by o_orderpriority""")
    assert len(rows) == 5
    mine = {tid: t for tid, t in worker_tasks(cluster).items() if tid not in before}
    finished = [t for t in mine.values() if t["state"] == "FINISHED"]
    assert finished, "no finished tasks found for this query"
    assert all(t["executionPath"] in ("fused", "fused-pipeline") for t in finished), [
        (t["taskId"], t["executionPath"], t["stats"].get("fused_error")) for t in mine.values()]
    for t in finished:
        st = t["stats"]
        assert {"serialize_ms", "pages_out", "page_bytes_out", "d2h_ms"} <= set(st)
    assert sum(t["stats"]["page_bytes_out"] for t in finished) > 0


def test_nodes_announced(cluster):
    info = get_json(cluster.coordinator_uri, "/v1/node")
    assert len(info["nodes"]) == 2
    assert all(not n["failed"] for n in info["failureInfo"])
    # every worker's pool rides its announcement into the cluster's view
    mem = get_json(cluster.coordinator_uri, "/v1/memory")
    assert set(mem) == {"clusterMemoryLimitBytes", "clusterReservedBytes",
                        "queryReservations", "killedQueries"}


def test_unauthenticated_task_post_rejected(cluster):
    """Task and announce endpoints demand the shared secret (reference
    InternalAuthenticationManager); a wrong secret is refused too."""
    body = json.dumps({"fragment": {}}).encode()
    for path, method, headers in (
        ("/v1/task/evil.1.0", "POST", {}),
        ("/v1/announce", "PUT", {}),
        ("/v1/task/evil.2.0", "POST", {"Authorization": "Bearer wrong-secret"}),
    ):
        req = urllib.request.Request(cluster.worker_uris[0] + path, data=body,
                                     method=method, headers=headers)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 401, (path, ei.value.code)


def test_worker_side_filters_collected(cluster, ref_local):
    """Worker tasks prefetch build pages first and prune their probe
    splits and rows before reading; the rows with and without dynamic
    filtering equal the reference's."""
    sql = """select count(*) from lineitem join orders
               on l_orderkey = o_orderkey
               where o_totalprice > decimal '400000.00'"""
    rows = check(cluster, ref_local, sql)
    unfiltered, _ = cluster.execute(sql, {"enable_dynamic_filtering": False})
    assert rows == unfiltered
    counts = [t["stats"].get("dynamic_filters", 0) for t in worker_tasks(cluster).values()]
    assert any(c > 0 for c in counts), counts


def _unfusable_task_payload(props):
    from trino_tpu_torch.exec.fragments import fragment_fusable
    from trino_tpu_torch.planner.fragmenter import fragment_plan
    from trino_tpu_torch.planner.serde import fragment_to_json
    from trino_tpu_torch.testing import LocalQueryRunner

    r = LocalQueryRunner(device="cpu")
    r.session.set("execution_mode", "distributed")
    sub = fragment_plan(r.plan(
        "select x, row_number() over (order by x) from (values (1),(2),(3)) t(x)"))
    unfusable = [f for f in sub.all_fragments() if not fragment_fusable(f)]
    assert unfusable, "expected the window fragment to be unfusable"
    return r.engine, {
        "fragment": fragment_to_json(unfusable[0]), "splits": {}, "sources": {},
        "session": {"properties": props},
    }


@pytest.mark.parametrize("mode", ["fused_strict", "default"])
def test_unfusable_fragment_fails_strict_and_falls_back_visibly(mode):
    """A fragment the fused path cannot take fails its task under
    ``fused_strict``; in the default mode it completes on the interpreter
    and says so (``executionPath``)."""
    from trino_tpu_torch.server.task import SqlTask

    props = {"worker_execution": "fused_strict"} if mode == "fused_strict" else {}
    engine, payload = _unfusable_task_payload(props)
    task = SqlTask(f"{mode}-test-task.0.0", engine, payload)
    task._thread.join(timeout=60)
    if mode == "fused_strict":
        assert task.state == "FAILED"
        assert "fused_strict" in (task.error or "")
    else:
        assert task.state == "FINISHED", task.error
        assert task.execution_path == "interpreter"


@pytest.mark.parametrize("error", ["cuda", "kernel", "capacity"])
def test_device_errors_fail_the_task_unretryable(monkeypatch, error):
    """No fallback: a CUDA or kernel error in a worker's program fails the
    task with the error named and is not retryable (it is not re-run on
    the interpreter); a capacity exhaustion falls back as in the
    reference."""
    from trino_tpu_torch import _kernels
    from trino_tpu_torch.exec.fragments import CapacityRetryExceeded
    from trino_tpu_torch.ft.retry import is_retryable
    from trino_tpu_torch.planner.fragmenter import fragment_plan
    from trino_tpu_torch.planner.serde import fragment_to_json
    from trino_tpu_torch.server import task as TK
    from trino_tpu_torch.testing import LocalQueryRunner

    exc = {
        "cuda": RuntimeError("CUDA error: an illegal memory access was encountered"),
        "kernel": _kernels.KernelError("dense_join_build: CUDA launch failed with error 700"),
        "capacity": CapacityRetryExceeded("join", fragment_id=1, attempts=12),
    }[error]

    def boom(self, *a, **k):
        raise exc

    monkeypatch.setattr(TK.FusedWorkerRunner, "run", boom)
    monkeypatch.setattr(TK.FusedWorkerRunner, "run_chain", boom)
    r = LocalQueryRunner(device="cpu")
    sub = fragment_plan(r.plan("select n_regionkey, count(*) from tpch.tiny.nation"
                               " group by n_regionkey"))
    leaf = next(f for f in sub.all_fragments() if not f.source_fragment_ids)
    payload = {"fragment": fragment_to_json(leaf), "sources": {}, "session": {},
               "splits": {"tpch.tiny.nation": [
                   {"table": "nation", "index": 0, "total": 1, "info": None}]}}
    task = TK.SqlTask(f"q-{error}.1.0", r.engine, payload)
    task._thread.join(timeout=60)
    if error == "capacity":
        assert task.state == "FINISHED" and task.execution_path == "interpreter"
        return
    assert task.state == "FAILED" and task.retryable is False
    assert str(exc) in task.error and task.execution_path != "interpreter"
    assert is_retryable(_kernels.KernelError("x")) is False
    assert is_retryable(OSError("x")) is True  # the reference's classes stand


def test_cancelled_task_stops_serializing(monkeypatch):
    """A task cancelled while it serializes its output (its query killed,
    a speculative loser) serializes no further page, enqueues none, and
    frees its reservation."""
    import threading

    from trino_tpu_torch.planner.fragmenter import fragment_plan
    from trino_tpu_torch.planner.serde import fragment_to_json
    from trino_tpu_torch.server import task as TK
    from trino_tpu_torch.testing import LocalQueryRunner

    holder, ready, produced = {}, threading.Event(), []
    real = TK._paginate

    def paginate(batch):
        ready.wait(30)
        for page in real(batch):
            produced.append(page)
            if len(produced) == 2:
                holder["task"].cancel()  # the query is killed at page 2
            yield page

    monkeypatch.setattr(TK, "PAGE_ROWS", 5)
    monkeypatch.setattr(TK, "_paginate", paginate)
    r = LocalQueryRunner(device="cpu")
    sub = fragment_plan(r.plan("select n_nationkey, n_name from tpch.tiny.nation"))
    leaf = next(f for f in sub.all_fragments() if not f.source_fragment_ids)
    payload = {"fragment": fragment_to_json(leaf), "sources": {}, "session": {},
               "splits": {"tpch.tiny.nation": [
                   {"table": "nation", "index": 0, "total": 1, "info": None}]}}
    task = TK.SqlTask("q-cancel.1.0", r.engine, payload)
    holder["task"] = task
    ready.set()
    task._thread.join(timeout=60)
    assert task.state == "CANCELED"
    assert len(produced) == 2  # 25 rows would make 5 pages
    assert task.stats["pages_out"] == 1
    assert task.buffer._buffered == 0
    assert r.engine.memory_pool.query_reserved("q-cancel") == 0


def test_node_scheduler_picks_equal_the_reference():
    """UniformNodeSelector analog: the port's picks, reservations and
    latency tie-breaks equal the reference's on the same inputs."""
    from trino_tpu.server import cluster as RC
    from trino_tpu_torch.server import cluster as PC

    def run(C):
        nm = C.ClusterNodeManager()
        ns = C.NodeScheduler(nm)
        a, b, c = (C.WorkerNode(x, f"http://{x}") for x in "abc")
        for _ in range(3):
            ns.acquire(a)
        picks = [n.node_id for n in ns.select([a, b, c], 5)]
        picks2 = [n.node_id for n in ns.select([a, b], 1)]
        ns.release(a)
        return picks, picks2, dict(ns._assigned)

    assert run(PC) == run(RC)
    picks, _, assigned = run(PC)
    assert picks.count("a") <= 1 and assigned["a"] == 3 + picks.count("a")


@pytest.mark.parametrize("sql", [
    "select count(*) from tpch.tiny.lineitem l join tpch.tiny.orders o"
    " on l.l_orderkey = o.o_orderkey",
    "select c_name, sum(o_totalprice) from tpch.tiny.customer join tpch.tiny.orders"
    " on c_custkey = o_custkey join tpch.tiny.nation on c_nationkey = n_nationkey"
    " group by c_name",
])
def test_phased_order_equals_the_reference(ref_local, sql):
    """PhasedExecutionSchedule analog: the port's launch order of the
    same fragmented plan equals the reference's, builds before probes and
    producers before consumers."""
    from trino_tpu.exec.fragments import fragment_plan as ref_fragment_plan
    from trino_tpu.server.cluster import phased_order as ref_phased_order
    from trino_tpu_torch.planner.fragmenter import fragment_plan
    from trino_tpu_torch.server.cluster import phased_order
    from trino_tpu_torch.testing import LocalQueryRunner

    sub = fragment_plan(LocalQueryRunner(device="cpu").plan(sql))
    order = [f.id for f in phased_order(sub)]
    ref_order = [f.id for f in ref_phased_order(ref_fragment_plan(ref_local.plan(sql)))]
    assert order == ref_order
    for f in sub.all_fragments():
        for src in f.source_fragment_ids:
            assert order.index(src) < order.index(f.id)


# --- cluster fusion (reference test_fusion.py::TestClusterFusion) ---------

FUSED_CLUSTER_PROPS = {"join_distribution_type": "PARTITIONED", "worker_execution": "fused"}
JOIN_SQL = ("select o_orderpriority, count(*) as fusion_probe from orders"
            " join lineitem on l_orderkey = o_orderkey"
            " group by o_orderpriority order by o_orderpriority")


def test_spooling_coexists_with_fusion(cluster):
    """Fusion and spooled exchange coexist: turning spooling on keeps the
    same fused schedule while unit boundaries become durable."""
    base, _, qid = execute_with_id(cluster, JOIN_SQL, FUSED_CLUSTER_PROPS)
    ex_fused = query_info_by_id(cluster, qid).get("exchangeStats") or {}
    assert ex_fused.get("fusedFragments", 0) >= 3, ex_fused
    spooled, _, qid = execute_with_id(cluster, JOIN_SQL, {
        **FUSED_CLUSTER_PROPS, "exchange_spooling": True, "retry_policy": "TASK"})
    info = query_info_by_id(cluster, qid)
    ex_spool = info.get("exchangeStats") or {}
    assert spooled == base
    assert ex_spool.get("fusedFragments", 0) == ex_fused.get("fusedFragments", 0)
    assert ex_spool.get("dispatchRoundTrips", 0) <= ex_fused.get("dispatchRoundTrips", 0)
    assert info.get("retryPolicy") == "TASK" and info.get("spooledBytes", 0) > 0


def test_task_retry_chaos_with_fusion_on(cluster):
    clean, _ = cluster.execute(JOIN_SQL, session_properties=FUSED_CLUSTER_PROPS)
    retries = 0
    for seed in (7, 11, 23):
        chaos = {**FUSED_CLUSTER_PROPS, "retry_policy": "TASK", "task_retry_attempts": 8,
                 "fault_injection_seed": seed, "fault_task_crash_p": 0.4,
                 "retry_initial_delay_ms": 20, "retry_max_delay_ms": 200}
        chaotic, _, qid = execute_with_id(cluster, JOIN_SQL, chaos)
        assert chaotic == clean, f"seed={seed} diverged under chaos"
        retries += query_info_by_id(cluster, qid).get("taskRetries", 0)
    assert retries > 0


# --- distributed spans and device stats (reference test_observability.py) --


def test_q5_span_tree_connected(cluster):
    """TPC-H Q5 on a 2-node cluster yields one connected span tree:
    worker ``task_execute`` spans parent (via ``X-Trino-Trace``) to the
    coordinator's ``task_attempt`` spans, which parent to stage spans,
    which reach the query root."""
    from trino_tpu_torch.benchmarks.tpch import queries

    rows, _ = cluster.execute(queries("tpch.tiny")[5], {"pipeline_fusion": False})
    assert rows
    qid = query_id_for(cluster, "revenue")
    spans = cluster_timeline(cluster, qid)
    assert all(s["traceId"] == qid for s in spans)
    by_id = {s["spanId"]: s for s in spans}
    roots = [s for s in spans if s["parentId"] is None]
    assert len(roots) == 1 and roots[0]["name"] == "query"
    for s in spans:
        hops = 50
        while s["parentId"] is not None and hops:
            s = by_id[s["parentId"]]  # KeyError == disconnected tree
            hops -= 1
        assert s["spanId"] == roots[0]["spanId"]
    names = {s["name"] for s in spans}
    assert {"query", "execute", "plan", "optimize", "fragment", "stage",
            "task_attempt", "task_execute"} <= names
    attempt_ids = {s["spanId"] for s in spans if s["name"] == "task_attempt"}
    assert all(s["parentId"] in attempt_ids for s in spans if s["name"] == "task_execute")
    assert len([s for s in spans if s["name"] == "stage"]) >= 2
    assert len({s["attrs"].get("worker") for s in spans if s["name"] == "task_attempt"}) == 2


def test_metrics_and_stage_percentiles(cluster):
    cluster.execute("select o_orderpriority as pct_probe, count(*) from orders"
                    " group by o_orderpriority", {"pipeline_fusion": False})
    text = get_text(cluster.coordinator_uri, "/v1/metrics")
    for line in ("# TYPE trino_tpu_queries_total counter",
                 'trino_tpu_queries_total{state="FINISHED"}',
                 "# TYPE trino_tpu_stage_elapsed_ms histogram",
                 "trino_tpu_task_elapsed_ms_count"):
        assert line in text
    snap = get_json(cluster.coordinator_uri, "/v1/metrics?format=json")
    finished = sum(v for k, v in snap["counters"].items()
                   if k.startswith("trino_tpu_tasks_total") and 'state="FINISHED"' in k)
    observed = sum(h["count"] for k, h in snap["histograms"].items()
                   if k.startswith("trino_tpu_task_elapsed_ms"))
    assert finished > 0 and observed == finished
    stats = get_json(cluster.coordinator_uri,
                     f"/v1/query/{query_id_for(cluster, 'pct_probe')}")["queryStats"]
    multi = [s for s in stats["stages"] if s.get("tasks", 0) >= 2]
    assert multi
    for s in multi:
        te = s["taskElapsedMs"]
        assert te["count"] == s["tasks"] and 0 <= te["p50"] <= te["p99"] <= te["max"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        get_json(cluster.coordinator_uri, "/v1/query/nope_xyz/timeline")
    assert ei.value.code == 404


def test_retry_spans_under_task_policy(cluster):
    rows, _ = cluster.execute(
        "select count(*) as chaos_probe from lineitem",
        {"retry_policy": "TASK", "task_retry_attempts": 8, "fault_injection_seed": 3,
         "fault_task_crash_p": 0.3, "retry_initial_delay_ms": 20, "retry_max_delay_ms": 200,
         "pipeline_fusion": False})
    assert rows
    info = query_info_for(cluster, "chaos_probe")
    spans = cluster_timeline(cluster, info["queryId"])
    retried = [s for s in spans
               if s["name"] == "task_attempt" and s["attrs"].get("attempt", 1) >= 2]
    assert retried and all(s["attrs"].get("retry") for s in retried)
    assert info["taskRetries"] >= 1


def test_distributed_explain_analyze(cluster):
    rows, _ = cluster.execute(
        "explain analyze select o_orderpriority as dea_probe, count(*)"
        " from orders group by o_orderpriority", {"pipeline_fusion": False})
    text = "\n".join(r[0] for r in rows)
    for part in ("Distributed plan:", "Stages (stats merged from worker tasks):",
                 "[tasks: ", "output rows: ", "task wall p50/p99/max:", "pages: ",
                 "paths: ", "wall time:"):
        assert part in text, part


def test_stage_stats_merged_from_both_workers(cluster):
    rows, _ = cluster.execute(
        "select o_orderpriority as dss_probe, count(*) as c from orders"
        " group by o_orderpriority", {"pipeline_fusion": False})
    assert rows
    info = get_json(cluster.coordinator_uri,
                    f"/v1/query/{query_id_for(cluster, 'dss_probe')}")
    stages = info["queryStats"]["stages"]
    assert [s for s in stages if s.get("tasks", 0) >= 2]
    assert any(s.get("rows") for s in stages)
    assert sum(s.get("inputRows") or s.get("rows") or 0 for s in stages) > 0
    # the workers' device profiles rode the same merge (executions only
    # on the CPU: the allocator's numbers are the card's)
    ds = info["deviceStats"]
    assert ds and any(label.startswith("frag:") for label in ds["programs"])
    assert all(p["executions"] >= 1 for p in ds["programs"].values())


def test_worker_runtime_tasks_table(cluster):
    """``system.runtime.tasks`` on a worker lists its retained tasks, as
    its ``/v1/task`` registry does."""
    from trino_tpu_torch.client import Connection

    # a grouped aggregate: its source fragment runs as worker tasks (a
    # global count may run whole on the coordinator, and then the test
    # would lean on the tasks that earlier tests left)
    cluster.execute("select o_orderpriority as tasks_probe, count(*) from orders"
                    " group by o_orderpriority")
    found = []
    for uri in cluster.worker_uris:
        rows, _ = Connection(uri).execute(
            "select task_id, state, fragment, elapsed_ms from system.runtime.tasks")
        found.extend(rows)
    assert found
    assert all(r[1] in ("FINISHED", "FAILED", "RUNNING", "CANCELED", "CANCELED_SPECULATIVE")
               for r in found)
    assert all(r[3] >= 0 for r in found)


def test_worker_failure_excluded_and_query_survives(cluster):
    """Kill one worker: the failure detector flags it and the next query
    succeeds on the remaining worker, with the rows of the whole
    cluster's run; the worker then restarts and announces again."""
    sql = "select count(*), sum(o_totalprice) from orders"
    want, _ = cluster.execute(sql)
    victim = cluster._worker_procs[-1]
    victim.terminate()
    victim.wait(timeout=10)
    try:
        deadline = time.time() + 30
        while time.time() < deadline:
            info = get_json(cluster.coordinator_uri, "/v1/node")
            if any(n["failed"] for n in info["failureInfo"]):
                break
            time.sleep(0.5)
        else:
            pytest.fail("failure detector never flagged the killed worker")
        assert cluster.execute(sql)[0] == want
    finally:
        cluster.restart_worker(len(cluster._worker_procs) - 1)


def test_string_keys_partition_by_value_across_producers():
    """Two producers' dictionaries code the same strings differently: a
    hash exchange partitions their rows by value, so one group's rows meet
    in one consumer; and a page carries the dictionary values its rows
    use, which read back to the same rows."""
    import torch

    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch, Column, Dictionary, concat_batches
    from trino_tpu_torch.ops import join as J
    from trino_tpu_torch.serde import deserialize_batch
    from trino_tpu_torch.server.task import _hash_key, _paginate

    words = [f"Customer#{i:09d}" for i in range(50)]
    a = Column(T.VARCHAR, torch.arange(50, dtype=torch.int32), None, Dictionary(words))
    b = Column(T.VARCHAR, torch.arange(49, -1, -1, dtype=torch.int32), None,
               Dictionary(list(reversed(words))))
    ha, _ = J.hash_keys([_hash_key(a)])
    hb, _ = J.hash_keys([_hash_key(b)])
    assert torch.equal(ha % 3, hb % 3)  # row i is words[i] in both
    valid = torch.ones(50, dtype=torch.bool)
    valid[7] = False
    big = Column(T.VARCHAR, torch.arange(50, dtype=torch.int32) % 5, valid,
                 Dictionary(words))
    batch = Batch([big], 50)
    pages = list(_paginate(batch))
    page = deserialize_batch(pages[0])
    assert len(page.columns[0].dictionary.values) == 5
    assert concat_batches([page]).to_pylist() == batch.to_pylist()


def test_launch_scopes_count_captures_and_replays():
    """A task's launch scope sees its own launches and its graphs'
    replays; a capture's launches stay in the capture's scope (its
    replays count them) and reach no outer scope nor ``LAUNCHES``."""
    from trino_tpu_torch import _kernels as K

    before = dict(K.LAUNCHES)
    with K.launch_scope() as task:
        K.count_launch("dense_join_build")
        with K.launch_scope(capture=True) as graph:
            K.count_launch("dense_join_build")
            K.count_launch("dense_groupby")
        assert task == {"dense_join_build": 1}
        K.count_replay(graph)
        K.count_replay(graph)
    assert graph == {"dense_join_build": 1, "dense_groupby": 1}
    assert task == {"dense_join_build": 3, "dense_groupby": 2}
    assert {k: K.LAUNCHES[k] - before[k] for k in before} == task
