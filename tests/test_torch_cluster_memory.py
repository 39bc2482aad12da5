"""Cluster-wide memory management.

Reference tier: ``memory/ClusterMemoryManager.java:89,104`` (coordinator
aggregates worker pool reports and kills the largest query over the
cluster limit) exercised the way
``testing/trino-tests/.../memory/TestMemoryManager.java`` does — against
real server processes.

The reference's ``tests/test_cluster_memory.py`` against the port (its
cluster on the CPU), and the port's ``ClusterMemoryManager`` held to the
reference's: the same reports give the same kills, in the same order,
and the same ``/v1/memory`` document.
"""

import json
import time
import urllib.request

import pytest

from trino_tpu_torch.memory import ClusterMemoryManager, MemoryPool

# (node, {query: bytes}) reports, with a coordinator reservation between
REPORTS = [
    ("w1", {"q1": 450, "q2": 300}),
    ("w2", {"q2": 400}),
    ("coord", {"q9": 120}),
    ("w1", {"q1": 900, "q3": 50}),
    ("w3", {"q3": 700, "q4": 10}),
    ("w2", {}),
    ("w3", {"q4": 5000}),
]


@pytest.mark.parametrize("limit", [1000, 1500, 100_000])
def test_kills_equal_the_reference(limit):
    """The port's manager and the reference's, fed the same reports (the
    coordinator's own pool included) and a kill function that refuses
    one query, kill the same queries in the same order and report the
    same cluster state after every step."""
    from trino_tpu.memory import ClusterMemoryManager as RefManager
    from trino_tpu.memory import MemoryPool as RefPool

    def run(manager_cls, pool_cls):
        killed = []

        def kill(q, msg):
            killed.append((q, msg))
            return q != "q1"  # q1 has finished: the killer moves on

        mgr = manager_cls(pool_cls(1 << 30), limit, kill_fn=kill)
        trail = []
        for node, res in REPORTS:
            if node == "coord":
                for q, b in res.items():
                    mgr.local_pool.try_reserve(q, b)
            else:
                mgr.update(node, {"queryReservations": res})
            trail.append(mgr.info())
        mgr.remove_node("w1")
        trail.append(mgr.info())
        return killed, trail

    assert run(ClusterMemoryManager, MemoryPool) == run(RefManager, RefPool)


class TestClusterMemoryManagerUnit:
    def _mgr(self, limit):
        self.killed = []
        pool = MemoryPool(1 << 30)
        return ClusterMemoryManager(
            pool, limit, kill_fn=lambda q, m: (self.killed.append((q, m)), True)[1]
        )

    def test_under_limit_no_kill(self):
        mgr = self._mgr(1000)
        mgr.update("w1", {"queryReservations": {"q1": 400}})
        mgr.update("w2", {"queryReservations": {"q1": 300, "q2": 200}})
        assert self.killed == []
        assert mgr.cluster_reservations() == {"q1": 700, "q2": 200}

    def test_kills_largest_cluster_wide(self):
        mgr = self._mgr(1000)
        # q2 is the largest only when summed ACROSS nodes
        mgr.update("w1", {"queryReservations": {"q1": 450, "q2": 300}})
        mgr.update("w2", {"queryReservations": {"q2": 400}})
        assert [q for q, _ in self.killed] == ["q2"]
        assert "cluster memory" in self.killed[0][1]

    def test_includes_coordinator_pool(self):
        mgr = self._mgr(1000)
        mgr.local_pool.try_reserve("q9", 900)
        mgr.update("w1", {"queryReservations": {"q1": 200}})
        assert [q for q, _ in self.killed] == ["q9"]

    def test_node_removal_releases(self):
        mgr = self._mgr(10_000)
        mgr.update("w1", {"queryReservations": {"q1": 4000}})
        mgr.remove_node("w1")
        assert mgr.cluster_reservations() == {}


@pytest.fixture(scope="module")
def small_cluster():
    from trino_tpu_torch.testing import MultiProcessQueryRunner

    with MultiProcessQueryRunner(
        n_workers=1, device="cpu", cluster_memory_limit_bytes=8 << 20
    ) as runner:
        yield runner


class TestClusterMemoryIntegration:
    def test_over_limit_query_killed(self, small_cluster):
        """A worker report that pushes the cluster total over the limit
        kills the running query with CLUSTER_OUT_OF_MEMORY (the report is
        posted through the real announce endpoint, exactly what the
        worker announce loop sends)."""
        from trino_tpu_torch.server import auth

        uri = small_cluster.coordinator_uri
        # start a query via the raw protocol so we hold its id mid-flight
        req = urllib.request.Request(
            f"{uri}/v1/statement",
            data=b"select count(*) from tpch.tiny.lineitem, tpch.tiny.orders"
            b" where l_orderkey = o_orderkey",
            method="POST",
            headers={"X-Trino-User": "mem", **auth.headers()},
        )
        with urllib.request.urlopen(req) as r:
            body = json.loads(r.read().decode())
        qid = body["id"]
        # a worker announce reporting this query far over the 8MB limit
        announce = json.dumps(
            {
                "nodeId": "worker-0",
                "uri": "http://127.0.0.1:9",
                "memoryInfo": {
                    "capacityBytes": 1 << 30,
                    "reservedBytes": 1 << 30,
                    "queryReservations": {qid: 1 << 30},
                },
            }
        ).encode()
        req = urllib.request.Request(
            f"{uri}/v1/announce",
            data=announce,
            method="PUT",
            headers=auth.headers(),
        )
        urllib.request.urlopen(req)
        # the query must terminate FAILED with the cluster-OOM error code
        deadline = time.time() + 30
        state = err = None
        while time.time() < deadline:
            req = urllib.request.Request(
                f"{uri}/v1/query/{qid}", headers=auth.headers()
            )
            with urllib.request.urlopen(req) as r:
                info = json.loads(r.read().decode())
            state = info["state"]
            if state in ("FAILED", "FINISHED", "CANCELED"):
                err = info.get("error") or {}
                break
            time.sleep(0.2)
        assert state == "FAILED", f"query ended {state}, expected FAILED"
        assert err.get("errorName") == "CLUSTER_OUT_OF_MEMORY", err
        # cluster memory endpoint records the kill
        req = urllib.request.Request(f"{uri}/v1/memory", headers=auth.headers())
        with urllib.request.urlopen(req) as r:
            mem = json.loads(r.read().decode())
        assert qid in mem["killedQueries"]

    def test_small_queries_unaffected(self, small_cluster):
        rows, _ = small_cluster.execute("select count(*) from tpch.tiny.region")
        assert rows == [(5,)]


# --- a kill or cancel cancels the query's worker tasks -----------------------

# a join whose worker tasks stall 30 s before they run (the fault
# injector's pre-execute stall), so they are still running when the query
# is killed or cancelled
STALLED_SQL = (b"select count(*) from tpch.tiny.lineitem, tpch.tiny.orders"
               b" where l_orderkey = o_orderkey")
STALLED_SESSION = "execution_mode=cluster,fault_task_stall_ms=30000"


def _json(url, method="GET", data=None, headers=None):
    from trino_tpu_torch.server import auth

    req = urllib.request.Request(url, data=data, method=method,
                                 headers={**auth.headers(), **(headers or {})})
    with urllib.request.urlopen(req, timeout=30) as r:
        body = r.read().decode()
    return json.loads(body) if body else None


def _announce(runner, reservations: dict) -> None:
    """What the worker's announce loop sends, with ``reservations``."""
    _json(f"{runner.coordinator_uri}/v1/announce", "PUT", json.dumps({
        "nodeId": "worker-0", "uri": runner.worker_uris[0],
        "memoryInfo": {"capacityBytes": 1 << 30, "reservedBytes": sum(reservations.values()),
                       "queryReservations": reservations},
    }).encode(), {"Content-Type": "application/json"})


def _task_states(runner, qid) -> list:
    return [t["state"] for uri in runner.worker_uris
            for t in _json(f"{uri}/v1/task") if t["taskId"].startswith(qid + ".")]


def _until(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.1)
    return pred()


@pytest.mark.parametrize("how", ["memory_kill", "user_delete"])
def test_kill_or_cancel_cancels_the_worker_tasks(small_cluster, how):
    """A query killed by the cluster memory manager, or cancelled by its
    user's ``DELETE /v1/query``, while its worker tasks run: every task
    reads CANCELED within a few seconds (not after its 30-s stall), the
    query keeps the kill's or the cancel's error, and the cluster's
    reservation falls under the limit."""
    uri = small_cluster.coordinator_uri
    # the worker at its own address (an earlier test announced it at
    # another), so that the query's tasks are placed on it
    _announce(small_cluster, {})
    qid = _json(f"{uri}/v1/statement", "POST", STALLED_SQL,
                {"X-Trino-User": "mem", "X-Trino-Session": STALLED_SESSION})["id"]
    running = _until(lambda: "RUNNING" in _task_states(small_cluster, qid), 30)
    assert running, _task_states(small_cluster, qid)
    if how == "memory_kill":
        # the worker's announce, reporting this query over the 8 MiB limit
        _announce(small_cluster, {qid: 1 << 30})
    else:
        _json(f"{uri}/v1/query/{qid}", "DELETE")
    t0 = time.monotonic()
    canceled = _until(lambda: (lambda s: s and all(x == "CANCELED" for x in s))(
        _task_states(small_cluster, qid)), 10)
    assert canceled, _task_states(small_cluster, qid)
    assert time.monotonic() - t0 < 10
    info = _until(lambda: (lambda i: i if i["state"] in ("FAILED", "CANCELED") else None)(
        _json(f"{uri}/v1/query/{qid}")), 10)
    if how == "memory_kill":
        assert info["state"] == "FAILED"
        assert info["error"]["errorName"] == "CLUSTER_OUT_OF_MEMORY"
    else:
        assert info["state"] == "CANCELED"
    # the worker's next announce (every 2 s) reports what its pool holds
    mem = _until(lambda: (lambda m: m if m["clusterReservedBytes"] <= m["clusterMemoryLimitBytes"]
                          else None)(_json(f"{uri}/v1/memory")), 10)
    assert mem, _json(f"{uri}/v1/memory")
