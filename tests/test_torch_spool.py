"""Spooled exchange + lineage-based recovery (exchange/spool.py,
server/cluster.py heal paths) and worker drain/decommission.

Reference tier: Trino's fault-tolerant execution over a spooled exchange
(the Tardigrade design / ``plugin/trino-exchange-filesystem``): finished
task output survives its producer, so a worker's death recovers by
re-pointing consumers at the spool (level=task) or re-executing only the
lost producers (level=lineage) — never by re-running the whole query.

The reference's ``tests/test_spool.py`` run against trino_tpu_torch
(its classes, and its cluster of CPU processes in the slow-marked
cases), with the port's own cases at the end: a spool directory written
by either package reads in the other, and the port's store answers as
the reference's on the same pages.
"""

import base64
import json
import threading
import time
import urllib.request
from types import SimpleNamespace

import pytest

from trino_tpu_torch.exchange.spool import (
    DiskSpoolStore,
    MemorySpoolStore,
    SpoolWriter,
)


# === unit: spool store ===================================================


class TestSpoolStore:
    def test_put_complete_read_wire_shape(self):
        s = MemorySpoolStore()
        assert s.put_page("q1", "q1.1.0", 0, 0, b"aa")
        assert s.put_page("q1", "q1.1.0", 0, 1, b"bb")
        assert s.put_page("q1", "q1.1.0", 1, 0, b"cc")
        # not readable until the manifest verifies
        assert not s.is_complete("q1.1.0")
        assert s.read("q1.1.0", 0, 0) is None
        assert s.complete("q1.1.0", "q1", {0: 2, 1: 1})
        out = s.read("q1.1.0", 0, 0)
        # exact task-results wire shape: ExchangeClient pulls it unchanged
        assert out == {
            "taskId": "q1.1.0",
            "pages": [
                base64.b64encode(b"aa").decode(),
                base64.b64encode(b"bb").decode(),
            ],
            "token": 2,
            "complete": True,
            "failed": False,
            "error": None,
        }

    def test_token_paging_resumes_mid_stream(self):
        s = MemorySpoolStore()
        for i in range(3):
            s.put_page("q1", "t", 0, i, bytes([i]))
        s.complete("t", "q1", {0: 3})
        out = s.read("t", 0, 2)
        assert [base64.b64decode(p) for p in out["pages"]] == [bytes([2])]
        assert out["token"] == 3

    def test_put_idempotent_per_seq(self):
        s = MemorySpoolStore()
        assert s.put_page("q1", "t", 0, 0, b"xyz")
        assert s.put_page("q1", "t", 0, 0, b"xyz")  # re-POST after retry
        assert s.stats()["bytes"] == 3
        assert s.complete("t", "q1", {0: 1})

    def test_manifest_mismatch_stays_incomplete(self):
        s = MemorySpoolStore()
        s.put_page("q1", "t", 0, 0, b"a")
        # producer claims 2 pages, only 1 stored (one POST was lost)
        assert not s.complete("t", "q1", {0: 2})
        assert not s.is_complete("t")
        assert s.read("t", 0, 0) is None
        s.put_page("q1", "t", 0, 1, b"b")
        assert s.complete("t", "q1", {0: 2})

    def test_zero_output_task_trivially_complete(self):
        s = MemorySpoolStore()
        assert s.complete("t-empty", "q1", {})
        out = s.read("t-empty", 0, 0)
        assert out["pages"] == [] and out["complete"]

    def test_unknown_task_never_completes(self):
        s = MemorySpoolStore()
        assert not s.complete("ghost", "q1", {0: 1})

    def test_delete_task_drops_pages(self):
        s = MemorySpoolStore()
        s.put_page("q1", "t", 0, 0, b"abcd")
        s.complete("t", "q1", {0: 1})
        s.delete_task("t")
        assert s.read("t", 0, 0) is None
        assert s.stats()["bytes"] == 0

    def test_query_bytes_and_delete_query(self):
        s = MemorySpoolStore()
        s.put_page("q1", "q1.1.0", 0, 0, b"aaaa")
        s.put_page("q1", "q1.2.0", 0, 0, b"bb")
        s.put_page("q2", "q2.1.0", 0, 0, b"c")
        assert s.query_bytes("q1") == 6
        s.delete_query("q1")
        assert s.query_bytes("q1") == 0
        assert s.stats()["bytes"] == 1  # q2 untouched


class TestSpoolEviction:
    """satellite: spool_max_bytes is a hard cap — admission evicts
    oldest-FINISHED-query data first, never a live query, and rejects
    (rather than truncates) when eviction cannot make room."""

    def test_oldest_finished_query_evicted_first(self):
        s = MemorySpoolStore(max_bytes=100)
        s.put_page("q1", "q1.t", 0, 0, b"x" * 40)
        s.complete("q1.t", "q1", {0: 1})
        s.finish_query("q1")
        s.put_page("q2", "q2.t", 0, 0, b"x" * 40)
        s.complete("q2.t", "q2", {0: 1})
        s.finish_query("q2")
        # 80/100 used; +40 must evict exactly q1 (oldest finish ordinal)
        assert s.put_page("q3", "q3.t", 0, 0, b"x" * 40)
        assert s.read("q1.t", 0, 0) is None, "q1 should have been evicted"
        assert s.is_complete("q2.t"), "q2 (newer) must survive"
        st = s.stats()
        assert st["bytes"] == 80 and st["evictedBytes"] == 40

    def test_live_queries_never_evicted_page_rejected(self):
        s = MemorySpoolStore(max_bytes=100)
        s.put_page("q1", "q1.t", 0, 0, b"x" * 60)  # q1 never finished
        assert not s.put_page("q2", "q2.t", 0, 0, b"x" * 60)
        assert s.stats()["rejectedPages"] == 1
        # the rejected task can never publish a matching manifest
        assert not s.complete("q2.t", "q2", {0: 1})
        # q1's data is intact
        s.complete("q1.t", "q1", {0: 1})
        assert s.is_complete("q1.t")

    def test_writing_query_protected_from_self_eviction(self):
        s = MemorySpoolStore(max_bytes=100)
        s.put_page("q1", "q1.t", 0, 0, b"x" * 80)
        s.finish_query("q1")
        # q1 is finished-and-evictable, but it is also the writer: its own
        # next page must not evict it (QUERY retry re-runs under one id)
        assert not s.put_page("q1", "q1.t2", 0, 0, b"x" * 80)

    def test_page_over_cap_always_rejected(self):
        s = MemorySpoolStore(max_bytes=10)
        assert not s.put_page("q1", "t", 0, 0, b"x" * 11)

    def test_new_task_revives_finished_query(self):
        s = MemorySpoolStore(max_bytes=100)
        s.put_page("q1", "q1.a", 0, 0, b"x" * 10)
        s.finish_query("q1")
        # a fresh task under q1 makes the query live again — it must no
        # longer be evictable while new attempts are writing
        s.put_page("q1", "q1.b", 0, 0, b"x" * 10)
        assert not s.put_page("q2", "q2.t", 0, 0, b"x" * 90)


class TestDiskSpoolStore:
    def test_roundtrip_and_cleanup_on_disk(self, tmp_path):
        s = DiskSpoolStore(str(tmp_path), max_bytes=1 << 20)
        s.put_page("q1", "q1.1.0", 0, 0, b"hello")
        s.put_page("q1", "q1.1.0", 0, 1, b"world")
        files = list(tmp_path.rglob("*.page"))
        assert len(files) == 2, "one file per page"
        assert not list(tmp_path.rglob("*.tmp")), "no partial files visible"
        s.complete("q1.1.0", "q1", {0: 2})
        out = s.read("q1.1.0", 0, 0)
        assert [base64.b64decode(p) for p in out["pages"]] == [
            b"hello", b"world",
        ]
        s.delete_query("q1")
        assert not list(tmp_path.rglob("*.page")), "pages deleted with query"

    def test_eviction_removes_files(self, tmp_path):
        s = DiskSpoolStore(str(tmp_path), max_bytes=10)
        s.put_page("q1", "q1.t", 0, 0, b"x" * 8)
        s.finish_query("q1")
        assert s.put_page("q2", "q2.t", 0, 0, b"x" * 8)
        assert len(list(tmp_path.rglob("*.page"))) == 1

    def test_startup_sweep_reaps_debris_and_rehydrates(self, tmp_path):
        """satellite: crash-safety sweep. A first store leaves a complete
        spool (manifest landed); a simulated kill -9 leaves a torn
        ``.tmp``, a loose root file, and a manifest-less task directory.
        A fresh store on the same dir reaps all three and re-registers
        the complete spool — readable AND evictable."""
        first = DiskSpoolStore(str(tmp_path), max_bytes=1 << 20)
        first.put_page("q1", "q1.1.0", 0, 0, b"hello")
        first.put_page("q1", "q1.1.0", 0, 1, b"world")
        assert first.complete("q1.1.0", "q1", {0: 2})
        (tmp_path / "q1.1.0" / "p0.9.page.tmp").write_bytes(b"torn")
        (tmp_path / "stray.tmp").write_bytes(b"junk")
        orphan = tmp_path / "q9.5.0"
        orphan.mkdir()
        (orphan / "p0.0.page").write_bytes(b"half-written, no manifest")

        s = DiskSpoolStore(str(tmp_path), max_bytes=1 << 20)
        assert s.reaped_entries == 3
        assert s.stats()["reapedEntries"] == 3
        assert not orphan.exists()
        assert not (tmp_path / "stray.tmp").exists()
        assert not (tmp_path / "q1.1.0" / "p0.9.page.tmp").exists()
        # the manifest-complete spool survived the sweep, readable as-is
        assert s.is_complete("q1.1.0")
        out = s.read("q1.1.0", 0, 0)
        assert [base64.b64decode(p) for p in out["pages"]] == [
            b"hello", b"world",
        ]
        assert s.stats()["bytes"] == 10
        # ...and arrives finish-marked: new demand can evict it
        assert s.put_page("q2", "q2.t", 0, 0, b"x" * ((1 << 20) - 5))
        assert s.read("q1.1.0", 0, 0) is None

    def test_startup_sweep_reaps_manifest_page_mismatch(self, tmp_path):
        """A directory whose manifest claims pages that are no longer on
        disk is debris, not a readable spool."""
        first = DiskSpoolStore(str(tmp_path), max_bytes=1 << 20)
        first.put_page("q1", "q1.1.0", 0, 0, b"aa")
        first.put_page("q1", "q1.1.0", 0, 1, b"bb")
        assert first.complete("q1.1.0", "q1", {0: 2})
        (tmp_path / "q1.1.0" / "p0.1.page").unlink()

        s = DiskSpoolStore(str(tmp_path), max_bytes=1 << 20)
        assert s.reaped_entries == 1
        assert not s.is_complete("q1.1.0")
        assert not (tmp_path / "q1.1.0").exists()


def test_get_spool_store_pins_backend(tmp_path):
    from trino_tpu_torch.exchange.spool import get_spool_store

    engine = SimpleNamespace()
    first = get_spool_store(engine, spool_dir=str(tmp_path), max_bytes=100)
    assert isinstance(first, DiskSpoolStore)
    # second query without spool_dir reuses the SAME store (switching
    # backends mid-process would orphan live spools); max_bytes re-applies
    second = get_spool_store(engine, spool_dir="", max_bytes=200)
    assert second is first
    assert second.max_bytes == 200


# === unit: spool writer against a live spool endpoint ====================


@pytest.fixture()
def spool_endpoint():
    """Minimal coordinator stand-in: the real /v1/spool routes over a real
    MemorySpoolStore, so SpoolWriter is tested against the actual wire."""
    import http.server
    import urllib.parse

    store = MemorySpoolStore(max_bytes=1 << 20)
    deletes: list = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            u = urllib.parse.urlparse(self.path)
            parts = [p for p in u.path.split("/") if p]
            q = urllib.parse.parse_qs(u.query)
            page = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            ok = store.put_page(
                q["query"][0], parts[2], int(q["partition"][0]),
                int(q["seq"][0]), page,
            )
            self._json({"accepted": ok})

        def do_PUT(self):
            parts = [p for p in self.path.split("/") if p]
            body = json.loads(
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
            )
            ok = store.complete(
                parts[2], body["queryId"],
                {int(p): int(n) for p, n in body["partitions"].items()},
            )
            self._json({"complete": ok})

        def do_DELETE(self):
            parts = [p for p in self.path.split("/") if p]
            deletes.append(parts[2])
            store.delete_task(parts[2])
            self._json({})

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", store, deletes
    finally:
        httpd.shutdown()
        httpd.server_close()


class TestSpoolWriter:
    def test_offer_then_finish_publishes_manifest(self, spool_endpoint):
        base, store, _ = spool_endpoint
        w = SpoolWriter(base, "q1.1.0", "q1")
        w.offer(0, b"aa")
        w.offer(0, b"bb")
        w.offer(1, b"c")
        assert w.finish(timeout=10.0)
        assert w.completed and not w.failed
        assert w.spooled_bytes == 5
        assert store.is_complete("q1.1.0")
        out = store.read("q1.1.0", 0, 0)
        assert [base64.b64decode(p) for p in out["pages"]] == [b"aa", b"bb"]

    def test_finish_idempotent(self, spool_endpoint):
        base, _, _ = spool_endpoint
        w = SpoolWriter(base, "t", "q1")
        w.offer(0, b"x")
        assert w.finish(timeout=10.0)
        assert w.finish(timeout=10.0)  # cached result, no second manifest

    def test_abort_deletes_incomplete_spool(self, spool_endpoint):
        # satellite: DELETE /v1/task and speculative cancels abort the
        # in-flight spool write and delete already-spooled pages
        base, store, deletes = spool_endpoint
        w = SpoolWriter(base, "q1.1.0", "q1")
        w.offer(0, b"payload")
        deadline = time.time() + 5
        while time.time() < deadline and store.stats()["bytes"] == 0:
            time.sleep(0.01)
        w.abort()
        deadline = time.time() + 5
        while time.time() < deadline and not deletes:
            time.sleep(0.01)
        assert deletes == ["q1.1.0"]
        assert store.stats()["bytes"] == 0
        assert not w.finish(timeout=1.0), "aborted writer must not publish"

    def test_abort_after_finish_keeps_complete_spool(self, spool_endpoint):
        # a completed spool belongs to the coordinator's query lifecycle:
        # the producing task's reap/cancel must not yank data recovery
        # may be serving
        base, store, deletes = spool_endpoint
        w = SpoolWriter(base, "t", "q1")
        w.offer(0, b"x")
        assert w.finish(timeout=10.0)
        w.abort()
        time.sleep(0.1)
        assert deletes == []
        assert store.is_complete("t")

    def test_offer_after_abort_is_dropped(self, spool_endpoint):
        base, store, _ = spool_endpoint
        w = SpoolWriter(base, "t", "q1")
        w.abort()
        w.offer(0, b"late")
        time.sleep(0.1)
        assert store.stats()["bytes"] == 0

    def test_rejected_page_marks_writer_failed(self, spool_endpoint):
        base, store, _ = spool_endpoint
        store.max_bytes = 1  # cap rejects everything
        w = SpoolWriter(base, "t", "q1")
        w.offer(0, b"too big for the cap")
        assert not w.finish(timeout=10.0)
        assert w.failed and not w.completed


class TestOutputBufferSpoolHooks:
    class _Recorder:
        def __init__(self):
            self.offers: list = []
            self.aborted = False

        def offer(self, partition, page):
            self.offers.append((partition, page))

        def abort(self):
            self.aborted = True

    def test_enqueue_mirrors_to_writer(self):
        from trino_tpu_torch.server.task import OutputBuffer

        buf = OutputBuffer(2, retain=True)
        rec = buf.spool_writer = self._Recorder()
        buf.enqueue(0, b"a")
        buf.enqueue(1, b"b")
        assert rec.offers == [(0, b"a"), (1, b"b")]

    def test_buffer_abort_aborts_spool(self):
        from trino_tpu_torch.server.task import OutputBuffer

        buf = OutputBuffer(1, retain=True)
        rec = buf.spool_writer = self._Recorder()
        buf.enqueue(0, b"a")
        buf.abort()
        assert rec.aborted


# === unit: latency-aware placement (failure detector EWMA) ===============


class TestLatencyEwma:
    def test_record_blends_latency(self):
        from trino_tpu_torch.server.failuredetector import NodeState

        n = NodeState("w", "uri")
        n.record(success=True, now=100.0, latency_ms=40.0)
        assert n.latency_ewma_ms == pytest.approx(40.0)  # first: raw
        n.record(success=True, now=101.0, latency_ms=80.0)
        assert n.latency_ewma_ms == pytest.approx(0.75 * 40 + 0.25 * 80)

    def test_failed_ping_does_not_touch_latency(self):
        from trino_tpu_torch.server.failuredetector import NodeState

        n = NodeState("w", "uri")
        n.record(success=True, now=100.0, latency_ms=10.0)
        n.record(success=False, now=101.0, latency_ms=2000.0)
        assert n.latency_ewma_ms == pytest.approx(10.0)

    def test_detector_latency_ms_and_info(self):
        from trino_tpu_torch.server.failuredetector import (
            HeartbeatFailureDetector,
        )

        d = HeartbeatFailureDetector(lambda uri: True, interval=10.0)
        d.register("w1", "http://w1")
        assert d.latency_ms("w1") == 0.0  # unknown ranks neutral
        assert d.latency_ms("ghost") == 0.0
        d.ping_all()
        assert d.latency_ms("w1") > 0.0
        info = {e["nodeId"]: e for e in d.info()}
        assert info["w1"]["latencyEwmaMs"] == pytest.approx(
            d.latency_ms("w1"), abs=1e-3
        )


class _LatNodeManager:
    def __init__(self, nodes, latencies, healthy=None):
        self._nodes = nodes
        self.failure_detector = SimpleNamespace(
            is_failed=lambda node_id: False,
            active_nodes=lambda: list(healthy or []),
            latency_ms=lambda node_id: latencies.get(node_id, 0.0),
        )

    def active_nodes(self):
        return list(self._nodes)


def _lat_scheduler(latencies, node_ids=("w0", "w1", "w2"), healthy=None):
    from trino_tpu_torch.server.cluster import ClusterScheduler, WorkerNode

    nodes = [WorkerNode(n, f"http://{n}") for n in node_ids]
    engine = SimpleNamespace(event_listeners=None)
    sched = ClusterScheduler(engine, _LatNodeManager(nodes, latencies, healthy))
    return sched, nodes


class TestLatencyAwarePlacement:
    def test_select_breaks_ties_toward_fast_node(self):
        sched, nodes = _lat_scheduler({"w0": 50.0, "w1": 1.0, "w2": 30.0})
        picked = sched.node_scheduler.select(nodes, 1)
        assert picked[0].node_id == "w1"

    def test_select_load_still_dominates_latency(self):
        sched, nodes = _lat_scheduler({"w0": 50.0, "w1": 1.0})
        ns = sched.node_scheduler
        ns.acquire(nodes[1])  # w1 busy
        picked = ns.select(nodes[:2], 1)
        assert picked[0].node_id == "w0", "load beats latency in ranking"

    def test_prune_slowest_drops_outlier(self):
        sched, nodes = _lat_scheduler({"w0": 100.0, "w1": 2.0, "w2": 3.0})
        kept = sched._prune_slowest(nodes)
        assert [n.node_id for n in kept] == ["w1", "w2"]

    def test_prune_keeps_close_latencies(self):
        # 30ms vs 28ms: inside both the 2x and +25ms bands — no outlier
        sched, nodes = _lat_scheduler({"w0": 30.0, "w1": 28.0})
        assert sched._prune_slowest(nodes[:2]) == nodes[:2]

    def test_prune_needs_two_known_latencies(self):
        sched, nodes = _lat_scheduler({"w0": 100.0})  # w1/w2 unknown (0.0)
        assert sched._prune_slowest(nodes) == nodes

    def test_retry_node_avoids_slowest_healthy(self):
        sched, nodes = _lat_scheduler(
            {"w0": 100.0, "w1": 2.0, "w2": 3.0},
            healthy=["w0", "w1", "w2"],
        )
        # excluding the failed node w1 leaves {w0 (slow), w2}: within-band
        # (100 < 3+... no: 100 > max(6, 28)) — w0 pruned, w2 it is
        picked = sched._retry_node(exclude="w1")
        assert picked.node_id == "w2"

    def test_speculation_node_never_slowest(self):
        sched, nodes = _lat_scheduler(
            {"w0": 100.0, "w1": 2.0, "w2": 3.0},
            healthy=["w0", "w1", "w2"],
        )
        for _ in range(4):
            n = sched._speculation_node(exclude="w1")
            assert n is not None and n.node_id != "w0"


# === unit: heal paths over fake remote tasks =============================


class _FakeRemoteTask:
    """Stand-in for HttpRemoteTask in recovery unit tests."""

    created: list = []
    script: list = []  # status dicts for scheduler-built instances

    def __init__(self, node, task_id, payload, **http):
        self.node = node
        self.task_id = task_id
        self.payload = payload
        self.attempt = 1
        self.span = None
        self.trace = None
        self.speculative = False
        self.recovered = False
        self.start_error = None
        self._obs_done = False
        self.last_status = None
        self.started_mono = None
        self._polls = 0
        _FakeRemoteTask.created.append(self)

    def start(self):
        self.started_mono = time.monotonic()

    def elapsed_ms(self):
        return 0.0

    def status(self, max_wait=0.0):
        script = _FakeRemoteTask.script or [{"state": "FINISHED"}]
        st = script[min(self._polls, len(script) - 1)]
        self._polls += 1
        self.last_status = st
        return st

    def cancel(self, speculative=False):
        pass


class _DeadTask(_FakeRemoteTask):
    """A finished producer whose worker just vanished."""

    def status(self, max_wait=0.0):
        raise ConnectionResetError("worker is gone")


def _recovery_ctx(sched, remote_tasks, fragments, store=None, base_uri=None):
    import itertools

    from trino_tpu_torch.config import Session

    return {
        "query_id": "cq7",
        "fragments": fragments,
        "remote_tasks": remote_tasks,
        "session": Session(properties={"retry_initial_delay_ms": 1,
                                       "retry_max_delay_ms": 2}),
        "http": {},
        "stats": {},
        "store": store,
        "base_uri": base_uri,
        "lineage_seq": itertools.count(1),
        "obs": None,
    }


@pytest.fixture()
def heal_cluster(monkeypatch):
    import trino_tpu_torch.server.cluster as cluster_mod
    from trino_tpu_torch.server.cluster import ClusterScheduler, WorkerNode

    _FakeRemoteTask.created = []
    _FakeRemoteTask.script = []
    monkeypatch.setattr(cluster_mod, "HttpRemoteTask", _FakeRemoteTask)
    live = WorkerNode("w0", "http://w0")
    dead = WorkerNode("w1", "http://w1")  # not in the manager: dead
    engine = SimpleNamespace(event_listeners=None)
    manager = _LatNodeManager([live], {}, healthy=["w0"])
    return ClusterScheduler(engine, manager), live, dead


class TestHealSources:
    def test_alive_producers_untouched(self, heal_cluster):
        sched, live, _ = heal_cluster
        prod = _FakeRemoteTask(live, "cq7.1.0", {})
        rc = _recovery_ctx(sched, {1: [prod]}, {})
        frag = SimpleNamespace(id=0, source_fragment_ids=[1])
        assert not sched._heal_sources(frag, rc)
        assert rc["remote_tasks"][1][0] is prod

    def test_spool_repoint_level_task(self, heal_cluster):
        from trino_tpu_torch.server.cluster import SpoolHandle

        sched, _, dead = heal_cluster
        prod = _FakeRemoteTask(dead, "cq7.1.0", {"k": 1})
        store = MemorySpoolStore()
        store.put_page("cq7", "cq7.1.0", 0, 0, b"pg")
        store.complete("cq7.1.0", "cq7", {0: 1})
        rc = _recovery_ctx(
            sched, {1: [prod]}, {}, store=store, base_uri="http://coord"
        )
        frag = SimpleNamespace(id=0, source_fragment_ids=[1])
        assert sched._heal_sources(frag, rc)
        handle = rc["remote_tasks"][1][0]
        assert isinstance(handle, SpoolHandle)
        assert handle.uri == "http://coord/v1/spool/cq7.1.0"
        assert handle.status()["state"] == "FINISHED"
        assert rc["stats"]["recovered_tasks"] == 1
        assert rc["stats"]["recovered_levels"] == {"task": 1}

    def test_lineage_reexecution_level_lineage(self, heal_cluster):
        sched, _, dead = heal_cluster
        prod = _FakeRemoteTask(dead, "cq7.1.0", {"fragment": "f"})
        # no spool (or incomplete): the producer itself must re-run
        rc = _recovery_ctx(
            sched, {1: [prod]},
            {1: SimpleNamespace(id=1, source_fragment_ids=[])},
        )
        frag = SimpleNamespace(id=0, source_fragment_ids=[1])
        assert sched._heal_sources(frag, rc)
        new = rc["remote_tasks"][1][0]
        assert new is not prod
        assert new.task_id == "cq7.1.0l1"  # l-suffix: lineage attempt
        assert new.recovered and new.attempt == 2
        assert new.node.node_id == "w0"
        assert rc["stats"]["recovered_levels"] == {"lineage": 1}

    def test_lineage_heals_transitive_sources_first(self, heal_cluster):
        sched, _, dead = heal_cluster
        grand = _FakeRemoteTask(dead, "cq7.2.0", {})
        prod = _FakeRemoteTask(dead, "cq7.1.0", {})
        fragments = {
            1: SimpleNamespace(id=1, source_fragment_ids=[2],
                               output_exchange="gather", output_keys=[]),
            2: SimpleNamespace(id=2, source_fragment_ids=[],
                               output_exchange="gather", output_keys=[]),
        }
        rc = _recovery_ctx(sched, {1: [prod], 2: [grand]}, fragments)
        frag = SimpleNamespace(id=0, source_fragment_ids=[1])
        assert sched._heal_sources(frag, rc)
        # both levels re-ran, grandparent first; the parent's rebuilt
        # sources point at the grandparent's NEW attempt
        assert rc["remote_tasks"][2][0].task_id == "cq7.2.0l1"
        assert rc["remote_tasks"][1][0].task_id == "cq7.1.0l2"
        srcs = rc["remote_tasks"][1][0].payload["sources"]
        assert srcs["2"]["locations"] == [rc["remote_tasks"][2][0].uri]

    def test_lineage_failure_exhausts_to_retries_exhausted(self, heal_cluster):
        from trino_tpu_torch.ft.retry import TaskRetriesExhausted

        sched, _, dead = heal_cluster
        prod = _FakeRemoteTask(dead, "cq7.1.0", {})
        _FakeRemoteTask.script = [
            {"state": "FAILED", "error": "boom", "retryable": True}
        ]
        rc = _recovery_ctx(
            sched, {1: [prod]},
            {1: SimpleNamespace(id=1, source_fragment_ids=[])},
        )
        frag = SimpleNamespace(id=0, source_fragment_ids=[1])
        with pytest.raises(TaskRetriesExhausted):
            sched._heal_sources(frag, rc)

# fake tasks need a .uri for source rebuilding after lineage recovery
_FakeRemoteTask.uri = property(
    lambda self: f"{self.node.uri}/v1/task/{self.task_id}"
)


# === unit: fused-unit heal paths =========================================


def _make_unit(root_sources=()):
    """A two-member fused unit: interior frag3 -> root frag2. The root's
    plain sources are interior; the unit's external lineage is whatever
    frag3 pulls from outside."""
    from trino_tpu_torch.planner.fragmenter import FusedFragment

    f3 = SimpleNamespace(id=3, source_fragment_ids=list(root_sources),
                         output_exchange="gather", output_keys=[])
    f2 = SimpleNamespace(id=2, source_fragment_ids=[3],
                         output_exchange="gather", output_keys=[])
    return FusedFragment((f3, f2)), f2, f3


class TestFusedUnitHeal:
    """Recovery boundary = fused unit: the unit's output buffers are the
    spool pages, its task is the recovery unit, and its lineage is the
    members' EXTERNAL sources (interior links are in-jit collectives
    with no tasks of their own)."""

    def test_external_source_ids_skip_interior_links(self):
        unit, _, _ = _make_unit(root_sources=(5,))
        assert unit.member_ids == frozenset({2, 3})
        assert unit.external_source_ids == (5,)

    def test_unit_spool_repoint_level_task(self, heal_cluster):
        """A dead fused-unit task whose unit-boundary output spooled
        completely re-points as ONE SpoolHandle — zero re-execution."""
        from trino_tpu_torch.server.cluster import SpoolHandle

        sched, _, dead = heal_cluster
        unit, f2, _ = _make_unit()
        prod = _FakeRemoteTask(dead, "cq7.2.0", {"fused_fragments": ["..."]})
        store = MemorySpoolStore()
        store.put_page("cq7", "cq7.2.0", 0, 0, b"unit-output")
        store.complete("cq7.2.0", "cq7", {0: 1})
        rc = _recovery_ctx(
            sched, {2: [prod]}, {2: f2}, store=store, base_uri="http://coord"
        )
        rc["units"] = {2: unit}
        consumer = SimpleNamespace(id=1, source_fragment_ids=[2])
        assert sched._heal_sources(consumer, rc)
        handle = rc["remote_tasks"][2][0]
        assert isinstance(handle, SpoolHandle)
        assert handle.uri == "http://coord/v1/spool/cq7.2.0"
        assert rc["stats"]["recovered_levels"] == {"task": 1}

    def test_unit_reexecutes_atomically_level_fused(self, heal_cluster):
        """No complete spool: the whole unit re-runs as ONE task
        (``l{k}`` id), its rebuilt sources spanning the members'
        external producers only — counted at level=fused."""
        sched, live, dead = heal_cluster
        unit, f2, f3 = _make_unit(root_sources=(5,))
        f5 = SimpleNamespace(id=5, source_fragment_ids=[],
                             output_exchange="gather", output_keys=[])
        lost = _FakeRemoteTask(dead, "cq7.2.0", {"fused_fragments": ["..."]})
        ext = _FakeRemoteTask(live, "cq7.5.0", {})
        rc = _recovery_ctx(sched, {2: [lost], 5: [ext]}, {2: f2, 3: f3, 5: f5})
        rc["units"] = {2: unit}
        consumer = SimpleNamespace(id=1, source_fragment_ids=[2])
        assert sched._heal_sources(consumer, rc)
        new = rc["remote_tasks"][2][0]
        assert new is not lost
        assert new.task_id == "cq7.2.0l1"
        assert new.recovered and new.attempt == 2
        assert rc["stats"]["recovered_levels"] == {"fused": 1}
        # the atomic re-run still carries the whole member chain...
        assert new.payload["fused_fragments"] == ["..."]
        # ...and pulls ONLY the unit's external producers (interior
        # member links are in-jit, never wire sources)
        assert set(new.payload["sources"]) == {"5"}
        assert new.payload["sources"]["5"]["locations"] == [ext.uri]

    def test_unit_consumer_heals_external_not_interior(self, heal_cluster):
        """When the CONSUMER is a fused unit, healing walks the unit's
        external sources — a stale interior entry is never touched."""
        sched, _, dead = heal_cluster
        unit, f2, _ = _make_unit(root_sources=(5,))
        f5 = SimpleNamespace(id=5, source_fragment_ids=[],
                             output_exchange="gather", output_keys=[])
        dead_ext = _FakeRemoteTask(dead, "cq7.5.0", {})
        dead_interior = _FakeRemoteTask(dead, "cq7.3.0", {})
        rc = _recovery_ctx(
            sched, {5: [dead_ext], 3: [dead_interior]}, {5: f5}
        )
        rc["units"] = {2: unit}
        assert sched._heal_sources(f2, rc)
        assert rc["remote_tasks"][5][0].task_id == "cq7.5.0l1"
        assert rc["stats"]["recovered_levels"] == {"lineage": 1}
        # interior fragment 3 was not (and must not be) healed
        assert rc["remote_tasks"][3][0] is dead_interior


# === integration: worker death + drain over a real cluster ===============


SPOOL_PROPS = {
    "retry_policy": "TASK",
    "exchange_spooling": True,
    "task_retry_attempts": 8,
    "retry_initial_delay_ms": 20,
    "retry_max_delay_ms": 200,
    # pin the per-fragment path: these classes exercise the per-fragment
    # recovery ladder (and _exit_site_for computes per-fragment sites);
    # the fused-unit ladder has its own classes further down
    "worker_execution": "per_fragment",
}

# the fused ladder: same retry/spool knobs, default (fused) execution
FUSED_SPOOL_PROPS = {
    k: v for k, v in SPOOL_PROPS.items() if k != "worker_execution"
}


@pytest.fixture(scope="module")
def spool_cluster():
    from trino_tpu_torch.testing import MultiProcessQueryRunner

    with MultiProcessQueryRunner(n_workers=3, device="cpu") as runner:
        yield runner


def _query_infos(runner):
    from trino_tpu_torch.server import auth

    req = urllib.request.Request(
        f"{runner.coordinator_uri}/v1/query", headers=auth.headers()
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read().decode())


def _exit_site_for(sql):
    """Fault site 'fragment.partition' of a producer feeding a
    WORKER-side consumer — the worker dies right after finishing that
    task. Paired with ``fault_task_stall_ms`` the (stalled) consumers
    provably pull AFTER the death, so the producer's retained buffers
    are gone and spool/lineage recovery must engage. A producer feeding
    the coordinator root would race the root's (unstallable) pull
    instead."""
    from trino_tpu_torch.planner.fragmenter import fragment_plan
    from trino_tpu_torch.testing import LocalQueryRunner

    r = LocalQueryRunner(device="cpu")
    r.session.set("execution_mode", "distributed")
    sub = fragment_plan(r.plan(sql))
    mid = sub.children[0]
    assert mid.fragment.source_fragment_ids, (
        "need a >=3 level fragment tree for a deterministic death window"
    )
    return f"{mid.fragment.source_fragment_ids[0]}.0"


# all worker tasks stall 1s pre-execute: a worker dying 300ms after its
# producer task finishes is guaranteed dead before any consumer pulls
DEATH_WINDOW = {
    "fault_task_stall_ms": 1000,
    "fault_worker_exit_delay_ms": 300,
}


def _restore_dead_workers(runner):
    for i, p in enumerate(runner._worker_procs):
        if p.poll() is not None:
            runner.restart_worker(i)


@pytest.mark.faults
@pytest.mark.slow
class TestWorkerDeathRecovery:
    def test_tpch_bit_identical_across_worker_death(self, spool_cluster):
        """Acceptance: with exchange_spooling=true + retry_policy=TASK, a
        worker dying mid-query (right after its producer task finished)
        yields bit-identical results with NO query-level retry — the
        spool serves the dead producer's output (level=task)."""
        from tests.test_fault_tolerance import TPCH_CHAOS_QUERIES

        try:
            # all fault-free baselines BEFORE any fault: once a worker
            # dies, only TASK-retry queries can ride out the window until
            # the failure detector flags it
            clean = {
                sql: spool_cluster.execute(sql)[0]
                for sql in TPCH_CHAOS_QUERIES
            }
            for k, sql in enumerate(TPCH_CHAOS_QUERIES):
                props = dict(SPOOL_PROPS)
                if k == 0:
                    # one worker dies during the first query; the
                    # remaining four run on the survivors
                    props.update(
                        DEATH_WINDOW,
                        fault_worker_exit_site=_exit_site_for(sql),
                    )
                chaotic, _ = spool_cluster.execute(
                    sql, session_properties=props
                )
                assert chaotic == clean[sql], (
                    f"diverged after death: {sql[:60]}"
                )
            assert any(
                p.poll() is not None for p in spool_cluster._worker_procs
            ), "the injected worker-exit fault never fired"
            infos = _query_infos(spool_cluster)
            spooled = [q for q in infos if q.get("retryPolicy") == "TASK"]
            assert spooled, "no TASK-retry queries recorded"
            assert all(
                q.get("queryAttempts") == 1 for q in spooled
            ), "worker death must not escalate to a QUERY retry"
            assert sum(q.get("recoveredTasks", 0) for q in spooled) >= 1, (
                "spool/lineage recovery never engaged"
            )
            assert any(
                q.get("spooledBytes", 0) > 0 for q in spooled
            ), "nothing was spooled"
        finally:
            _restore_dead_workers(spool_cluster)

    def test_lineage_reexecution_when_spool_rejected(self, spool_cluster):
        """With the spool cap too small to hold anything, the same death
        recovers by re-executing only the lost producer (level=lineage) —
        still no QUERY retry."""
        from tests.test_fault_tolerance import TPCH_CHAOS_QUERIES

        sql = TPCH_CHAOS_QUERIES[0]
        try:
            clean, _ = spool_cluster.execute(sql)
            props = dict(
                SPOOL_PROPS,
                **DEATH_WINDOW,
                spool_max_bytes=1,  # every page rejected: no task tier
                fault_worker_exit_site=_exit_site_for(sql),
            )
            chaotic, _ = spool_cluster.execute(sql, session_properties=props)
            assert chaotic == clean
            lineage = [
                q for q in _query_infos(spool_cluster)
                if q.get("recoveredTaskLevels", {}).get("lineage", 0) >= 1
            ]
            assert lineage, "no query recovered at level=lineage"
            assert all(q["queryAttempts"] == 1 for q in lineage)
        finally:
            _restore_dead_workers(spool_cluster)


@pytest.mark.faults
@pytest.mark.slow
class TestWorkerDrain:
    def test_rolling_restart_zero_failures(self, spool_cluster):
        """Acceptance: drain (PUT /v1/info/state SHUTTING_DOWN) + restart
        of every worker in sequence, with spooled TASK-retry queries
        flowing throughout — zero failed queries."""
        from tests.test_fault_tolerance import TPCH_CHAOS_QUERIES

        sql = TPCH_CHAOS_QUERIES[3]
        clean, _ = spool_cluster.execute(sql)
        stop = threading.Event()
        failures: list = []
        runs = [0]

        def churn():
            while not stop.is_set():
                try:
                    rows, _ = spool_cluster.execute(
                        sql, session_properties=SPOOL_PROPS
                    )
                    runs[0] += 1
                    if rows != clean:
                        failures.append(f"row mismatch on run {runs[0]}")
                except Exception as e:  # noqa: BLE001
                    failures.append(repr(e))

        t = threading.Thread(target=churn, daemon=True)
        t.start()
        try:
            for i in range(len(spool_cluster.worker_uris)):
                spool_cluster.drain_worker(i)
                spool_cluster.restart_worker(i)
        finally:
            stop.set()
            t.join(timeout=120)
        assert not failures, f"queries failed during rolling restart: {failures[:3]}"
        assert runs[0] >= 1, "no query completed during the restarts"
        # drained nodes deregistered cleanly and rejoined: 3 live workers
        infos = json.loads(
            urllib.request.urlopen(
                f"{spool_cluster.coordinator_uri}/v1/node", timeout=10
            ).read().decode()
        )
        assert len(infos["nodes"]) == len(spool_cluster.worker_uris)

    def test_rolling_restart_with_fusion_on(self, spool_cluster):
        """Acceptance: the same rolling drain/restart with FUSED spooled
        queries flowing. A draining worker's retained fused-unit buffer
        IS the unit-boundary output — force-spooled on drain — so fusion
        adds zero failures and zero drift."""
        sql = _fused_chaos_queries()[3]
        clean, _ = spool_cluster.execute(sql)
        stop = threading.Event()
        failures: list = []
        runs = [0]

        def churn():
            while not stop.is_set():
                try:
                    rows, _ = spool_cluster.execute(
                        sql, session_properties=FUSED_SPOOL_PROPS
                    )
                    runs[0] += 1
                    if rows != clean:
                        failures.append(f"row mismatch on run {runs[0]}")
                except Exception as e:  # noqa: BLE001
                    failures.append(repr(e))

        t = threading.Thread(target=churn, daemon=True)
        t.start()
        try:
            for i in range(len(spool_cluster.worker_uris)):
                spool_cluster.drain_worker(i)
                spool_cluster.restart_worker(i)
        finally:
            stop.set()
            t.join(timeout=120)
        assert not failures, (
            f"fused queries failed during rolling restart: {failures[:3]}"
        )
        assert runs[0] >= 1, "no fused query completed during the restarts"
        ex = _last_exchange_stats(spool_cluster, sql)
        assert ex.get("fusedFragments", 0) >= 1, (
            "the churn traffic never actually fused"
        )

    def test_draining_worker_refuses_new_tasks(self, spool_cluster):
        """A SHUTTING_DOWN worker 503s task POSTs (the coordinator
        re-routes); its /v1/info/state reflects the drain."""
        import urllib.error

        from trino_tpu_torch.server import auth

        i = 0
        spool_cluster.drain_worker(i)
        try:
            req = urllib.request.Request(
                f"{spool_cluster.worker_uris[i]}/v1/task/t-x",
                data=b"{}",
                method="POST",
                headers=auth.headers(),
            )
            with pytest.raises((urllib.error.HTTPError, urllib.error.URLError)):
                # either 503 (still draining) or connection refused (gone)
                urllib.request.urlopen(req, timeout=5)
        finally:
            spool_cluster.restart_worker(i)


# === integration: fused execution × death / batching =====================


def _fused_chaos_queries():
    """The chaos suite with every member fusable: Q6's single worker
    fragment never forms a unit, so it is swapped for a two-stage
    aggregation (partial -> final) that does."""
    from tests.test_fault_tolerance import TPCH_CHAOS_QUERIES

    qs = list(TPCH_CHAOS_QUERIES)
    qs[1] = (
        "select l_shipmode, count(*) as c from lineitem "
        "group by l_shipmode order by l_shipmode"
    )
    return qs


def _last_exchange_stats(runner, sql):
    infos = [
        q for q in _query_infos(runner)
        if q.get("query", "").strip() == sql.strip()
    ]
    assert infos, "query not found in coordinator query list"
    return infos[-1].get("exchangeStats") or {}


def _last_info(runner, sql):
    infos = [
        q for q in _query_infos(runner)
        if q.get("query", "").strip() == sql.strip()
    ]
    assert infos, "query not found in coordinator query list"
    return infos[-1]


def _coordinator_metrics(runner) -> str:
    from trino_tpu_torch.server import auth

    req = urllib.request.Request(
        f"{runner.coordinator_uri}/v1/metrics", headers=auth.headers()
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read().decode()


def _fuse_units(sql, **props):
    """The fused units the cluster scheduler would form for ``sql`` —
    same fuse_groups invocation, computed plan-side so tests can pick
    deterministic fault sites (unit root tasks, external producers)."""
    from trino_tpu_torch.exec.fragments import fragment_fusable
    from trino_tpu_torch.planner.fragmenter import (
        FusedFragment,
        fragment_plan,
        fuse_groups,
        partitioned_join_pairs,
    )
    from trino_tpu_torch.testing import LocalQueryRunner

    r = LocalQueryRunner(device="cpu")
    r.session.set("execution_mode", "distributed")
    for k, v in props.items():
        r.session.set(k, v)
    sub = fragment_plan(r.plan(sql))
    units = fuse_groups(
        sub,
        fusable=fragment_fusable,
        max_fragments=max(1, int(r.session.get("fusion_max_fragments"))),
        skew_pairs=(
            partitioned_join_pairs(sub)
            if bool(r.session.get("skew_handling"))
            else ()
        ),
        include_root=False,
    )
    return [u for u in units if isinstance(u, FusedFragment)]


# two grouped subqueries fuse into two 2-member units feeding a
# worker-side join fragment (PARTITIONED + max=2). The join's tasks are
# stallable, so a unit's own death is provably observed — units feeding
# the coordinator root race its unstallable pull instead
FUSED_JOIN_SQL = (
    "select a.k, a.c, b.s from "
    "(select l_returnflag as k, count(*) as c from lineitem "
    "group by l_returnflag) a "
    "join (select l_returnflag as k, sum(l_quantity) as s from lineitem "
    "group by l_returnflag) b on a.k = b.k "
    "order by a.k"
)
FUSED_JOIN_PROPS = {
    "join_distribution_type": "PARTITIONED",
    "fusion_max_fragments": 2,
}


@pytest.mark.faults
@pytest.mark.slow
class TestFusedWorkerDeathRecovery:
    def test_fused_tpch_bit_identical_across_worker_death(
        self, spool_cluster
    ):
        """Acceptance: all five chaos queries run FUSED with spooling on
        (fusedFragments >= 1, no extra dispatch round-trips vs the
        fused-only path) and one survives a mid-query worker SIGKILL
        bit-identically with queryAttempts == 1."""
        qs = _fused_chaos_queries() + [FUSED_JOIN_SQL]
        extra = {FUSED_JOIN_SQL: FUSED_JOIN_PROPS}
        # the death lands on the join-of-aggregations query: its SECOND
        # unit stage (1s stall) runs between the dead unit's FINISH and
        # the join stage's eager source pull, so the 300ms death window
        # provably elapses before any consumer pulls. A linear chain has
        # no such intervening stage — only barrier latency — and races.
        death_idx = len(qs) - 1
        death_units = _fuse_units(FUSED_JOIN_SQL, **FUSED_JOIN_PROPS)
        assert death_units, "join-of-aggregations no longer fuses"
        death_site = f"{death_units[0].id}.0"
        try:
            clean, fused_ex = {}, {}
            for sql in qs:
                # the session DEFAULTS are the fused path: this baseline
                # is the pre-spooling fused schedule (PR-10 round-trip
                # counts) the spooled runs must not regress
                clean[sql] = spool_cluster.execute(
                    sql, session_properties=extra.get(sql, {})
                )[0]
                fused_ex[sql] = _last_exchange_stats(spool_cluster, sql)
                assert fused_ex[sql].get("fusedFragments", 0) >= 1, (
                    f"baseline did not fuse: {sql[:60]}"
                )
            for k, sql in enumerate(qs):
                props = dict(FUSED_SPOOL_PROPS, **extra.get(sql, {}))
                if k == death_idx:
                    props.update(
                        DEATH_WINDOW,
                        fault_worker_exit_site=death_site,
                    )
                chaotic, _ = spool_cluster.execute(
                    sql, session_properties=props
                )
                assert chaotic == clean[sql], (
                    f"diverged after death: {sql[:60]}"
                )
                ex = _last_exchange_stats(spool_cluster, sql)
                if k == death_idx:
                    # the SIGKILLed worker takes its tasks' reported
                    # stats with it, so the death query can only prove
                    # it still ran fused (one 2-member unit at minimum)
                    assert ex.get("fusedFragments", 0) >= 2, (sql[:60], ex)
                else:
                    assert ex.get("fusedFragments", 0) == fused_ex[
                        sql
                    ].get("fusedFragments", 0), (sql[:60], ex, fused_ex[sql])
                if k != death_idx:
                    # recovery attempts legitimately add dispatches on
                    # the death query; everywhere else spooling must
                    # cost zero extra round-trips
                    assert ex.get("dispatchRoundTrips", 0) <= fused_ex[
                        sql
                    ].get("dispatchRoundTrips", 0), (sql[:60], ex)
                else:
                    assert any(
                        p.poll() is not None
                        for p in spool_cluster._worker_procs
                    ), "the injected worker-exit fault never fired"
                    # bring the killed worker back so the remaining
                    # queries' round-trip counts reflect spooling alone,
                    # not placement retries against a dead node
                    _restore_dead_workers(spool_cluster)
            spooled = [
                q for q in _query_infos(spool_cluster)
                if q.get("retryPolicy") == "TASK"
            ]
            assert all(
                q.get("queryAttempts") == 1 for q in spooled
            ), "worker death must not escalate to a QUERY retry"
            assert sum(q.get("recoveredTasks", 0) for q in spooled) >= 1, (
                "recovery never engaged"
            )
            assert any(q.get("spooledBytes", 0) > 0 for q in spooled), (
                "nothing was spooled"
            )
        finally:
            _restore_dead_workers(spool_cluster)

    def test_lost_unit_spool_repoints_without_reexecution(
        self, spool_cluster
    ):
        """A killed worker that finished a whole fused unit: the unit's
        unit-boundary output spooled completely, so its consumers
        re-point at ONE SpoolHandle (level=task) — zero re-execution."""
        try:
            clean, _ = spool_cluster.execute(
                FUSED_JOIN_SQL, session_properties=FUSED_JOIN_PROPS
            )
            units = _fuse_units(FUSED_JOIN_SQL, **FUSED_JOIN_PROPS)
            assert units, "join-of-aggregations no longer fuses"
            props = dict(
                FUSED_SPOOL_PROPS,
                **FUSED_JOIN_PROPS,
                **DEATH_WINDOW,
                fault_worker_exit_site=f"{units[0].id}.0",
            )
            chaotic, _ = spool_cluster.execute(
                FUSED_JOIN_SQL, session_properties=props
            )
            assert chaotic == clean
            info = _last_info(spool_cluster, FUSED_JOIN_SQL)
            assert info.get("queryAttempts") == 1
            assert info.get("recoveredTasks", 0) >= 1
            assert info.get("recoveredTaskLevels", {}).get("task", 0) >= 1
            assert (info.get("exchangeStats") or {}).get(
                "fusedFragments", 0
            ) >= 2
        finally:
            _restore_dead_workers(spool_cluster)

    def test_fused_unit_reexecution_when_spool_rejected(self, spool_cluster):
        """With every spool page cap-rejected the lost unit cannot
        re-point — the whole unit re-executes atomically on a survivor
        (recoveredTaskLevels.fused, counted in the fused recovery
        metric) and the rows stay bit-identical, still queryAttempts==1."""
        try:
            clean, _ = spool_cluster.execute(
                FUSED_JOIN_SQL, session_properties=FUSED_JOIN_PROPS
            )
            units = _fuse_units(FUSED_JOIN_SQL, **FUSED_JOIN_PROPS)
            assert units, "join-of-aggregations no longer fuses"
            props = dict(
                FUSED_SPOOL_PROPS,
                **FUSED_JOIN_PROPS,
                **DEATH_WINDOW,
                spool_max_bytes=1,  # every page rejected: no task tier
                fault_worker_exit_site=f"{units[0].id}.0",
            )
            chaotic, _ = spool_cluster.execute(
                FUSED_JOIN_SQL, session_properties=props
            )
            assert chaotic == clean
            info = _last_info(spool_cluster, FUSED_JOIN_SQL)
            assert info.get("queryAttempts") == 1
            assert info.get("recoveredTaskLevels", {}).get("fused", 0) >= 1, (
                info.get("recoveredTaskLevels")
            )
            # the observability satellite: the per-level recovery counter
            # carries the new fused level on /v1/metrics
            assert 'trino_tpu_recovered_tasks_total{level="fused"}' in (
                _coordinator_metrics(spool_cluster)
            )
        finally:
            _restore_dead_workers(spool_cluster)


@pytest.mark.faults
@pytest.mark.slow
class TestBatchedRecoveryUnderWorkerDeath:
    def test_batch_members_bit_identical_across_worker_death(
        self, spool_cluster
    ):
        """satellite: cross-query batching × recovery. Two literal-variant
        queries join one batch window on the cluster coordinator; the
        batched path falls back to sequential member execution there, a
        worker SIGKILLed mid-run is absorbed by TASK retry/recovery —
        every member bit-identical, queryAttempts == 1, and the batch
        really formed (size=2 dispatch counted)."""
        variants = [
            "select sum(l_extendedprice * l_discount) as revenue "
            "from lineitem where l_quantity < 24",
            "select sum(l_extendedprice * l_discount) as revenue "
            "from lineitem where l_quantity < 30",
        ]
        try:
            clean = {
                sql: spool_cluster.execute(sql)[0] for sql in variants
            }
            assert clean[variants[0]] != clean[variants[1]], (
                "variants must differ so member isolation is provable"
            )
            before = _coordinator_metrics(spool_cluster).count(
                'trino_tpu_batched_dispatches_total{size="2"}'
            )
            # identical props (the group key includes the session
            # signature). The window only bounds the WAIT for a straggler
            # member — max_size=2 flushes the instant the second member
            # arrives — so a generous window costs nothing on success and
            # absorbs scheduling lag between the two submit threads on a
            # loaded machine
            props = dict(
                FUSED_SPOOL_PROPS,
                batch_window_ms=10000,
                batch_max_size=2,
                **DEATH_WINDOW,
                fault_worker_exit_site="1.0",  # the lineitem scan stage
            )
            results: dict = {}
            errors: list = []

            def run(sql):
                try:
                    results[sql] = spool_cluster.execute(
                        sql, session_properties=props
                    )[0]
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))

            threads = [
                threading.Thread(target=run, args=(sql,), daemon=True)
                for sql in variants
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
            assert not errors, f"batch members failed: {errors}"
            for sql in variants:
                assert results[sql] == clean[sql], (
                    f"batch member diverged: {sql[:60]}"
                )
            assert any(
                p.poll() is not None for p in spool_cluster._worker_procs
            ), "the injected worker-exit fault never fired"
            for sql in variants:
                assert _last_info(spool_cluster, sql).get(
                    "queryAttempts"
                ) == 1, "death during a batched run escalated to QUERY retry"
            metrics = _coordinator_metrics(spool_cluster)
            assert metrics.count(
                'trino_tpu_batched_dispatches_total{size="2"}'
            ) >= max(before, 1), "the two members never shared a batch"
        finally:
            _restore_dead_workers(spool_cluster)


# === the port's own: the spool against the reference's ===================


def _pages():
    """Serialized pages of a small batch: the port's bytes (the two
    packages' pages are byte-equal for the same batch)."""
    import numpy as np

    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import batch_from_numpy
    from trino_tpu_torch.serde import serialize_batch

    out = []
    for k in range(3):
        vals = np.arange(k * 100, k * 100 + 50 + k, dtype=np.int64)
        out.append(serialize_batch(batch_from_numpy([T.BIGINT], [vals])))
    return out


def _fill(store, pages):
    trail = []
    for t, task in enumerate(("q1.1.0", "q1.1.1", "q2.2.0")):
        q = task.split(".")[0]
        for seq, page in enumerate(pages[: t + 1]):
            trail.append(store.put_page(q, task, seq % 2, seq, page))
        trail.append(store.put_page(q, task, 0, 0, pages[0]))  # replay: idempotent
        parts = {}
        for seq in range(t + 1):
            parts[seq % 2] = parts.get(seq % 2, 0) + 1
        trail.append(store.complete(task, q, parts))
    trail.append(store.read("q1.1.1", 1, 0))
    trail.append(store.read("q2.2.0", 0, 1))
    trail.append(store.query_bytes("q1"))
    store.finish_query("q1")
    trail.append(store.stats())
    return trail


@pytest.mark.parametrize("backend", ["memory", "disk"])
def test_store_answers_equal_the_reference(tmp_path, backend):
    """The same pages, manifests and reads through the port's store and
    the reference's give the same acceptances, wire documents, byte
    counts and ``stats()``."""
    from trino_tpu.exchange import spool as RS

    pages = _pages()
    if backend == "memory":
        port, ref = MemorySpoolStore(max_bytes=1 << 20), RS.MemorySpoolStore(max_bytes=1 << 20)
    else:
        port = DiskSpoolStore(str(tmp_path / "port"), max_bytes=1 << 20)
        ref = RS.DiskSpoolStore(str(tmp_path / "ref"), max_bytes=1 << 20)
    assert _fill(port, pages) == _fill(ref, pages)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_spool_directory_reads_in_the_other_package(tmp_path, writer):
    """A spool directory written by one package (pages, manifests, then
    a store that goes away) rehydrates in the other's store: the same
    complete tasks and the same pages."""
    from trino_tpu.exchange import spool as RS

    pages = _pages()
    make = {"port": DiskSpoolStore, "reference": RS.DiskSpoolStore}
    other = "reference" if writer == "port" else "port"
    first = make[writer](str(tmp_path), max_bytes=1 << 20)
    _fill(first, pages)
    del first
    second = make[other](str(tmp_path), max_bytes=1 << 20)
    for task in ("q1.1.0", "q1.1.1", "q2.2.0"):
        assert second.is_complete(task), task
    assert second.read("q2.2.0", 0, 0) == make[writer](str(tmp_path), 1 << 20).read("q2.2.0", 0, 0)
    got = second.read("q1.1.1", 1, 0)
    assert [base64.b64decode(p) for p in got["pages"]] == [pages[1]]
