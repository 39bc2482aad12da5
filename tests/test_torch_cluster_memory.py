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
