"""The flight journal, the SLO sentinel and operator telemetry through
trino_tpu_torch, against the reference.

The cases of ``tests/test_flight.py``:

- the journal (``obs/flight.py``): framing, torn-tail and corrupt-record
  replay, segment roll and byte budget, restart; a journal written by
  either package replays record for record through the other's
  ``replay_dir``;
- crash safety: a real ``SIGKILL`` of one port coordinator process
  mid-query, its journal replayed by a fresh port server through
  ``GET /v1/query/{id}/flight?dir=``;
- the lifecycle through the port's server (created → completed with
  queryStats and spans);
- the SLO sentinel (``obs/slo.py``): the same evaluations through both
  packages' sentinels give the same verdicts, snapshots and counters, and
  ``GET /v1/slo`` serves them;
- operator telemetry: rows identical with ``operator_stats`` on and off,
  and the reduction ratio folded into history.
"""

import json
import os
import signal
import struct
import subprocess
import sys
import time
import urllib.parse
import urllib.request
import zlib

import pytest
import torch

from trino_tpu.obs import flight as ref_flight
from trino_tpu.obs import slo as ref_slo
from trino_tpu_torch.config import Session
from trino_tpu_torch.obs import flight as port_flight
from trino_tpu_torch.obs import slo as port_slo
from trino_tpu_torch.obs.flight import FlightRecorder

from torch_server_fixtures import port_loop_under_lockdep  # noqa: F401

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLIGHT = {"reference": ref_flight, "port": port_flight}


def _both_replay(directory, query_id=None):
    """The port's replay, checked equal to the reference's."""
    got = port_flight.replay_dir(directory, query_id)
    assert got == ref_flight.replay_dir(directory, query_id)
    return got


class TestFlightJournal:
    def test_roundtrip_and_query_filter(self, tmp_path):
        rec = FlightRecorder(str(tmp_path))
        for i in range(10):
            rec.record(f"q{i % 2}", "created", {"n": i})
        assert rec.flush()
        assert len(_both_replay(str(tmp_path))) == 10
        q1 = _both_replay(str(tmp_path), "q1")
        assert [e["n"] for e in q1] == [1, 3, 5, 7, 9]
        assert all(e["queryId"] == "q1" and e["ts"] > 0 for e in q1)
        rec.close()

    def test_torn_tail_replays_intact_prefix(self, tmp_path):
        rec = FlightRecorder(str(tmp_path))
        for i in range(5):
            rec.record("q", "event", {"n": i})
        rec.flush()
        rec.close()
        seg = sorted(tmp_path.iterdir())[-1]
        body = json.dumps({"queryId": "q", "event": "torn"}).encode()
        with open(seg, "ab") as f:  # SIGKILL mid-write: header + half body
            f.write(struct.pack("<II", len(body), zlib.crc32(body)))
            f.write(body[: len(body) // 2])
        assert [e["n"] for e in _both_replay(str(tmp_path))] == [0, 1, 2, 3, 4]

    def test_corrupt_record_ends_prefix(self, tmp_path):
        rec = FlightRecorder(str(tmp_path))
        for i in range(4):
            rec.record("q", "event", {"n": i})
        rec.flush()
        rec.close()
        seg = sorted(tmp_path.iterdir())[-1]
        data = bytearray(seg.read_bytes())
        off = 0
        for _ in range(2):
            length = struct.unpack_from("<II", data, off)[0]
            off += 8 + length
        data[off + 8 + 2] ^= 0xFF
        seg.write_bytes(bytes(data))
        assert [e["n"] for e in _both_replay(str(tmp_path))] == [0, 1]

    def test_segment_roll_and_byte_budget(self, tmp_path):
        rec = FlightRecorder(str(tmp_path), max_bytes=4096, segment_bytes=1024)
        for i in range(200):
            rec.record("q", "event", {"n": i, "pad": "x" * 64})
        rec.flush()
        segs = [p for p in tmp_path.iterdir() if p.suffix == ".seg"]
        assert len(segs) > 1
        assert sum(p.stat().st_size for p in segs) < 3 * 4096
        assert rec.segments_deleted > 0
        ns = [e["n"] for e in _both_replay(str(tmp_path))]
        assert ns == list(range(ns[0], 200))
        rec.close()

    def test_restart_never_appends_to_old_segment(self, tmp_path):
        rec = FlightRecorder(str(tmp_path))
        rec.record("q", "before", {})
        rec.flush()
        rec.close()
        old = sorted(tmp_path.iterdir())
        rec2 = FlightRecorder(str(tmp_path))
        rec2.record("q", "after", {})
        rec2.flush()
        rec2.close()
        assert len(sorted(tmp_path.iterdir())) == len(old) + 1
        assert [e["event"] for e in _both_replay(str(tmp_path))] == ["before", "after"]

    @pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
    def test_a_journal_replays_in_the_other_package(self, tmp_path, writer, reader):
        """Byte compatibility: one package's segments, framing and JSON are
        what the other's replay reads, across a segment roll."""
        rec = FLIGHT[writer].FlightRecorder(str(tmp_path), segment_bytes=512)
        for i in range(40):
            rec.record(f"q{i % 3}", "event", {"n": i, "s": "ü" * (i % 5)})
        rec.flush()
        rec.close()
        mine = FLIGHT[writer].replay_dir(str(tmp_path))
        theirs = FLIGHT[reader].replay_dir(str(tmp_path))
        assert theirs == mine and [e["n"] for e in mine] == list(range(40))
        assert FLIGHT[reader].replay_dir(str(tmp_path), "q1") == \
            FLIGHT[writer].replay_dir(str(tmp_path), "q1")


# A real port coordinator process: its QueryManager journals to
# flight_dir, one query parked inside the engine, killed with SIGKILL.
_CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from trino_tpu_torch.config import Session
from trino_tpu_torch.server.querymanager import QueryManager

class StuckEngine:
    def execute_statement(self, sql, session):
        time.sleep(600)  # parked "mid-query" until the SIGKILL

qm = QueryManager(StuckEngine())
q = qm.create_query("select 1", Session(properties={"flight_dir": sys.argv[2]}))
time.sleep(0.3)  # let the dispatch thread journal "running"
q._flight.flush()
print("READY " + q.query_id, flush=True)
time.sleep(600)
"""


class TestFlightCrashSafety:
    def test_sigkill_mid_query_then_replay_via_endpoint(self, tmp_path):
        flight_dir = str(tmp_path / "flight")
        proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD, REPO_ROOT, flight_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        try:
            line = ""
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                line = proc.stdout.readline()
                if line.startswith("READY"):
                    break
            assert line.startswith("READY"), f"child never ready: {line!r}"
            qid = line.split()[1]
            os.kill(proc.pid, signal.SIGKILL)
        finally:
            proc.wait(timeout=30)
        events = _both_replay(flight_dir, qid)
        names = [e["event"] for e in events]
        assert names[:2] == ["created", "running"]
        assert "completed" not in names
        assert events[0]["query"] == "select 1"

        from trino_tpu_torch.server.http import TrinoTpuServer

        s = TrinoTpuServer(device="cpu").start()
        try:
            url = (f"{s.base_uri}/v1/query/{qid}/flight?"
                   + urllib.parse.urlencode({"dir": flight_dir}))
            with urllib.request.urlopen(url, timeout=10) as r:
                body = json.loads(r.read().decode())
            assert body["queryId"] == qid
            assert [e["event"] for e in body["events"]] == names
        finally:
            s.stop()


def _post(base, sql, headers):
    req = urllib.request.Request(f"{base}/v1/statement", data=sql.encode(),
                                 method="POST", headers=headers)
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read().decode())


def _wait_done(base, qid):
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        with urllib.request.urlopen(f"{base}/v1/query/{qid}", timeout=5) as r:
            if json.loads(r.read().decode())["state"] in ("FINISHED", "FAILED"):
                return
        time.sleep(0.05)


class TestFlightLifecycle:
    def test_completed_query_journals_stats(self, tmp_path):
        from trino_tpu_torch.server.http import TrinoTpuServer

        flight_dir = str(tmp_path / "flight")
        s = TrinoTpuServer(device="cpu").start()
        try:
            out = _post(s.base_uri, "select 1", {
                "X-Trino-User": "test", "X-Trino-Session": "flight_dir=" + flight_dir})
            qid = out["id"]
            _wait_done(s.base_uri, qid)
            with urllib.request.urlopen(f"{s.base_uri}/v1/query/{qid}/flight",
                                        timeout=10) as r:
                body = json.loads(r.read().decode())
        finally:
            s.stop()
        events = {e["event"]: e for e in body["events"]}
        assert "created" in events and "completed" in events
        done = events["completed"]
        assert done["state"] == "FINISHED"
        assert done["queryStats"]["elapsedMs"] >= 0
        assert done["error"] is None
        assert isinstance(done.get("spans"), list) and done["spans"]
        assert [e["event"] for e in body["events"]] == [
            "created", "admitted", "running", "completed"]


# --- the SLO sentinel ---------------------------------------------------------

_BASELINE = {"elapsed_samples": [100.0, 100.0, 110.0, 90.0, 100.0]}


def _sessions():
    from trino_tpu.config import Session as RefSession

    return {"reference": RefSession, "port": Session}


# (session properties, fingerprint, elapsed ms, history entry) sequences
SLO_SEQUENCES = {
    "warmup_below_min_samples_is_silent": [
        ({}, "fp1", 10_000.0, {"elapsed_samples": [100.0, 100.0]})],
    "fire_minor_then_clear": [
        ({}, "fp1", 250.0, _BASELINE), ({}, "fp1", 105.0, _BASELINE)],
    "severity_buckets": [({}, "fp", 300.0, _BASELINE), ({}, "fp", 450.0, _BASELINE)],
    "absolute_slo_violation": [({"slo_elapsed_ms": 50.0}, "fp", 80.0, None)],
    "custom_multipliers": [
        ({"slo_regression_multiplier": 1.2, "slo_min_samples": 3}, "fp", 130.0, _BASELINE),
        ({"slo_severe_multiplier": 2.0}, "fp2", 260.0, _BASELINE)],
}


def _snap(sentinel):
    snap = sentinel.snapshot()
    for row in snap.get("regressed", []):
        row.pop("ts", None)
        row.pop("firstMs", None)
        row.pop("lastMs", None)
    return snap


class TestSloSentinel:
    @pytest.mark.parametrize("seq", sorted(SLO_SEQUENCES))
    def test_verdicts_equal_the_reference(self, seq):
        out = {}
        for name, mod in (("reference", ref_slo), ("port", port_slo)):
            sen = mod.SloSentinel()
            sess = _sessions()[name]
            verdicts = [sen.evaluate(sess(properties=p), fp, ms, ent)
                        for p, fp, ms, ent in SLO_SEQUENCES[seq]]
            out[name] = (verdicts, _snap(sen))
        assert out["port"] == out["reference"]
        verdicts, snap = out["port"]
        if seq == "warmup_below_min_samples_is_silent":
            assert verdicts == [None] and snap["regressed"] == []
        if seq == "fire_minor_then_clear":
            assert verdicts[0]["severity"] == "minor" and verdicts[0]["magnitude"] == 2.5
            assert verdicts[0]["baselineP50Ms"] == 100.0 and verdicts[1] is None
            assert snap["regressed"] == [] and snap["regressions"] == 1
        if seq == "severity_buckets":
            assert [v["severity"] for v in verdicts] == ["minor", "severe"]
        if seq == "absolute_slo_violation":
            assert verdicts == [{"sloViolation": 1, "sloElapsedMs": 50.0, "elapsedMs": 80.0}]
            assert snap["violations"] == 1

    def test_metrics_counters(self):
        from trino_tpu_torch.obs.metrics import get_registry

        sen = port_slo.SloSentinel()
        before = get_registry().snapshot()["counters"]
        sen.evaluate(Session(), "fp", 500.0, _BASELINE)
        sen.evaluate(Session(properties={"slo_elapsed_ms": 10.0}), "fp2", 20.0, None)
        after = get_registry().snapshot()["counters"]

        def delta(name):
            return sum(v for k, v in after.items() if k.startswith(name)) - sum(
                v for k, v in before.items() if k.startswith(name))

        assert delta("trino_tpu_query_regressions_total") == 1
        assert delta("trino_tpu_slo_violations_total") == 1

    def test_slo_endpoint(self):
        from trino_tpu_torch.obs.slo import get_sentinel
        from trino_tpu_torch.server.http import TrinoTpuServer

        get_sentinel().evaluate(Session(), "fp-endpoint", 999.0, _BASELINE, query_id="q9")
        s = TrinoTpuServer(device="cpu").start()
        try:
            with urllib.request.urlopen(f"{s.base_uri}/v1/slo", timeout=10) as r:
                body = json.loads(r.read().decode())
        finally:
            s.stop()
            get_sentinel().reset()
        fps = [row["fingerprint"] for row in body["regressed"]]
        assert "fp-endpoint" in fps
        row = body["regressed"][fps.index("fp-endpoint")]
        assert row["queryId"] == "q9" and row["severity"] == "severe"


# --- operator telemetry -------------------------------------------------------

@pytest.fixture(scope="module")
def runner():
    from trino_tpu_torch.testing import LocalQueryRunner

    return LocalQueryRunner(device="cpu")


def _tpch(n):
    from trino_tpu_torch.benchmarks.tpch import queries

    return queries("tpch.tiny")[n]


class TestOperatorStatsBitIdentity:
    @pytest.mark.parametrize("n", [1, 5])
    def test_rows_identical_on_off(self, runner, n):
        sql = _tpch(n)
        base = {"execution_mode": "distributed"}
        on = runner.engine.execute_statement(sql, Session(properties=dict(base)))
        off = runner.engine.execute_statement(
            sql, Session(properties={**base, "operator_stats": False}))
        assert on.rows == off.rows
        assert off.operator_stats is None and on.operator_stats
        kinds = {"scan", "filter", "join", "semijoin", "partial-agg", "final-agg",
                 "agg", "exchange"}
        for site, ent in on.operator_stats.items():
            assert "@" in site and ent["kind"] in kinds
            assert ent["rows_in"] >= 0 and ent["rows_out"] >= 0


class TestOperatorHistoryFold:
    def test_reduction_ratio_lands_in_history(self, tmp_path):
        from trino_tpu_torch.testing import LocalQueryRunner

        props = {"execution_mode": "distributed", "history_dir": str(tmp_path)}
        r = LocalQueryRunner(device="cpu")
        sql = ("select l_returnflag, count(*) c from tpch.tiny.lineitem"
               " group by l_returnflag")
        for _ in range(2):
            r.engine.execute_statement(sql, Session(properties=dict(props)))
        entries = r.engine.history_snapshot()["stores"][0]["fingerprints"]
        ops = entries[0].get("operators") or {}
        pagg = [ent for ent in ops.values() if ent.get("kind") == "partial-agg"]
        assert pagg and all(0 < ent["reduction_ratio"] <= 1.0 for ent in pagg)
        assert all("rows_in" in ent and "rows_out" in ent for ent in pagg)
