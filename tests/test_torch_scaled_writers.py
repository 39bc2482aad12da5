"""Scaled writers: distributed part-file writes over shared storage.

Reference: ``execution/scheduler/ScaledWriterScheduler.java`` with
``FIXED_ARBITRARY``/``SCALED_WRITER`` round-robin placement
(``SystemPartitioningHandle.java:61,63``) — writer tasks on several
nodes append part files concurrently; the coordinator anchors the
schema and totals the row counts (TableFinish analog). The catalog is
mounted on every node via ``--catalog`` (etc/catalog analog).

The reference's ``tests/test_scaled_writers.py`` against the port's
cluster (CPU processes), and the port's commit protocol: a worker's part
is staged until every writer has answered, so a failed scaled INSERT —
a writer that errs, or one that outlives the coordinator's wait — leaves
no committed row (the reference's abort can miss a part committed after
its ``join(timeout)``).
"""

import os
import threading
import time

import pytest

from trino_tpu_torch.testing import MultiProcessQueryRunner


@pytest.fixture(scope="module")
def shared_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("shared_pq"))


@pytest.fixture(scope="module")
def cluster(shared_root):
    with MultiProcessQueryRunner(
        n_workers=2, device="cpu", catalogs=[f"shared=parquet:{shared_root}"]
    ) as runner:
        yield runner


def test_scaled_ctas_writes_from_many_nodes(cluster, shared_root):
    cluster.execute(
        "create table shared.default.orders_copy as "
        "select o_orderkey, o_custkey, o_totalprice from tpch.tiny.orders",
        session_properties={
            "scaled_writers": "true",
            "writer_target_bytes": "65536",
        },
    )
    rows, _ = cluster.execute(
        "select count(*), min(o_orderkey), max(o_orderkey)"
        " from shared.default.orders_copy"
    )
    want, _ = cluster.execute(
        "select count(*), min(o_orderkey), max(o_orderkey)"
        " from tpch.tiny.orders"
    )
    assert rows == want
    parts = [
        f
        for f in os.listdir(os.path.join(shared_root, "default", "orders_copy"))
        if f.endswith(".parquet")
    ]
    # several writers produced part files (coordinator anchor + workers)
    assert len(parts) >= 3, parts


def test_scaled_insert_appends(cluster, shared_root):
    cluster.execute("create table shared.default.app as select 1 v")
    cluster.execute(
        "insert into shared.default.app "
        "select o_orderkey from tpch.tiny.orders",
        session_properties={
            "scaled_writers": "true",
            "writer_target_bytes": "65536",
        },
    )
    rows, _ = cluster.execute("select count(*) from shared.default.app")
    assert rows == [(15001,)]


def test_unscaled_write_single_part(cluster, shared_root):
    cluster.execute(
        "create table shared.default.single as "
        "select r_regionkey from tpch.tiny.region"
    )
    parts = os.listdir(os.path.join(shared_root, "default", "single"))
    assert len([f for f in parts if f.endswith(".parquet")]) == 1


# --- the commit protocol, in one process -----------------------------------


class _SlowParts:
    """A file connector whose worker-side part writes wait ``delay_s``
    after writing (a writer that outlives the coordinator's wait), or
    raise."""

    def __init__(self, conn, delay_s=0.0, fail=False):
        self._conn, self.delay_s, self.fail = conn, delay_s, fail
        self.done = threading.Event()

    def __getattr__(self, name):
        return getattr(self._conn, name)

    def insert_part(self, schema, table, batch, pending=False):
        try:
            if self.fail:
                raise OSError("disk full")
            out = self._conn.insert_part(schema, table, batch, pending=pending)
            time.sleep(self.delay_s)
            return out
        finally:
            self.done.set()


@pytest.fixture
def writer_pair(tmp_path):
    """A coordinator engine and an in-process worker server over one
    shared file catalog; the coordinator's scheduler knows the worker."""
    from trino_tpu_torch.connectors.file import FileConnector
    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.server.cluster import ClusterNodeManager, NodeScheduler, WorkerNode
    from trino_tpu_torch.server.http import TrinoTpuServer

    coord = Engine(device="cpu")
    coord.catalogs.register("f", FileConnector(str(tmp_path)))
    worker = TrinoTpuServer(role="worker", device="cpu").start()
    slow = _SlowParts(FileConnector(str(tmp_path)))
    worker.engine.catalogs.register("f", slow)

    class _Scheduler:
        node_manager = ClusterNodeManager()
        node_scheduler = NodeScheduler(node_manager)

    node = WorkerNode("w0", worker.base_uri)
    _Scheduler.node_manager.active_nodes = lambda: [node]
    coord.cluster_scheduler = _Scheduler()
    try:
        yield coord, slow, str(tmp_path)
    finally:
        worker.stop()
        _Scheduler.node_manager.failure_detector.stop()


def _rows(coord, sql):
    from trino_tpu_torch.config import Session

    return coord.execute_statement(sql, Session()).rows


SCALED = {"scaled_writers": True, "writer_target_bytes": 1 << 14}


@pytest.mark.parametrize("fault", ["outlives_join", "fails"])
def test_failed_scaled_insert_leaves_no_committed_rows(writer_pair, monkeypatch, fault):
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.engine import Engine

    coord, slow, root = writer_pair
    _rows(coord, "create table f.default.t as select n_nationkey from tpch.tiny.nation")
    before = _rows(coord, "select count(*), sum(n_nationkey) from f.default.t")
    if fault == "fails":
        slow.fail = True
    else:
        slow.delay_s = 1.5
        monkeypatch.setattr(Engine, "WRITER_JOIN_TIMEOUT_S", 0.3)
    with pytest.raises(Exception, match="scaled write failed"):
        coord.execute_statement(
            "insert into f.default.t select o_orderkey from tpch.tiny.orders",
            Session(properties=dict(SCALED)))
    assert slow.done.wait(10)
    time.sleep(slow.delay_s + 0.5)  # the late writer has answered by now
    assert _rows(coord, "select count(*), sum(n_nationkey) from f.default.t") == before
    names = os.listdir(os.path.join(root, "default", "t"))
    assert not [n for n in names if n.endswith(".pending")]
    assert len([n for n in names if n.endswith(".ttp")]) == 1, names


def test_scaled_insert_commits_every_part(writer_pair):
    coord, _, root = writer_pair
    _rows(coord, "create table f.default.u as select n_nationkey from tpch.tiny.nation")
    from trino_tpu_torch.config import Session

    res = coord.execute_statement(
        "insert into f.default.u select o_orderkey from tpch.tiny.orders",
        Session(properties=dict(SCALED)))
    assert res.update_count == 15000
    assert _rows(coord, "select count(*) from f.default.u") == [(15025,)]
    names = os.listdir(os.path.join(root, "default", "u"))
    assert not [n for n in names if n.endswith(".pending")]
    assert len([n for n in names if n.endswith(".ttp")]) == 3, names
