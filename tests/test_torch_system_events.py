"""Query events and the ``system`` catalog in the port
(``trino_tpu_torch/events.py``, ``connectors/system.py``) against the
reference's on the same statements: the event classes and the fields
the engine fills, ``SHOW CATALOGS``, ``system.metadata.catalogs``, the
deterministic columns of ``system.runtime.queries``, ``nodes`` and
``programs``, the tables that wait for the cluster (``tasks``,
``metrics``, ``history``), and EXPLAIN ANALYZE's operator section.
"""

import dataclasses

import pytest
import torch

from trino_tpu import events as RE
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import events as E
from trino_tpu_torch.testing import LocalQueryRunner

torch.set_num_threads(1)

SQL = ("select l_returnflag, count(*), sum(l_quantity) from tpch.tiny.lineitem"
       " where l_quantity < 20 group by l_returnflag order by l_returnflag")


class _Recorder:
    def __init__(self):
        self.created, self.completed = [], []

    def query_created(self, event):
        self.created.append(event)

    def query_completed(self, event):
        self.completed.append(event)

    def stage_completed(self, event):
        pass

    def task_completed(self, event):
        pass


def _pair(mode="local"):
    ref, port = RefRunner(), LocalQueryRunner(device="cpu")
    for r in (ref, port):
        r.session.set("execution_mode", mode)
        r.session.set("query_history", False)
    # the one codegen property whose default differs (the port sizes its
    # device chunks by the card's free memory when it is unset): the
    # reference's value, so that the fingerprints compare
    port.session.set("stream_device_chunk_rows", ref.session.get("stream_device_chunk_rows"))
    return ref, port


def test_event_classes_equal_the_reference():
    for name in ("QueryCreatedEvent", "QueryCompletedEvent", "StageCompletedEvent",
                 "TaskCompletedEvent"):
        got = [(f.name, str(f.type)) for f in dataclasses.fields(getattr(E, name))]
        want = [(f.name, str(f.type)) for f in dataclasses.fields(getattr(RE, name))]
        assert got == want, name


def test_engine_fires_the_reference_events():
    ref, port = _pair()
    recs = []
    for r in (ref, port):
        rec = _Recorder()
        r.engine.event_listeners.add(rec)
        r.engine.execute_statement(SQL, r.session)
        with pytest.raises(Exception):
            r.engine.execute_statement("select nope from tpch.tiny.nation", r.session)
        recs.append(rec)

    def fields(ev):
        d = dataclasses.asdict(ev)
        for k in ("create_time", "end_time", "wall_seconds", "peak_memory_bytes",
                  "error_message"):
            d.pop(k, None)
        return d

    for which in ("created", "completed"):
        got = [fields(e) for e in getattr(recs[1], which)]
        want = [fields(e) for e in getattr(recs[0], which)]
        assert got == want, which
    assert recs[1].completed[1].error_message and recs[1].completed[1].state == "FAILED"


def test_show_catalogs_and_metadata_catalogs():
    ref, port = _pair()
    assert ("system",) in port.execute("show catalogs")[0]
    assert port.execute("show catalogs") == ref.execute("show catalogs")
    sql = "select * from system.metadata.catalogs order by catalog_name"
    assert port.execute(sql) == ref.execute(sql)


def test_runtime_queries_and_nodes():
    ref, port = _pair()
    stmts = [SQL, "select count(*) from tpch.tiny.nation"]
    out = []
    for r in (ref, port):
        for s in stmts:
            r.execute(s)
        rows, names = r.execute(
            "select query_id, state, user, source, query, output_rows"
            " from system.runtime.queries order by query_id")
        out.append((rows, names))
    assert out[1] == out[0]
    sql = "select * from system.runtime.nodes"
    assert port.execute(sql) == ref.execute(sql)


def test_cluster_tables_have_the_reference_rows():
    """``tasks`` and ``history`` (with the history store off) give the
    reference's rows on a bare engine: none. ``metrics`` reads each
    package's process-wide metrics registry, where every statement counts
    itself: after a query, both list its ``trino_tpu_queries_total``
    counter, with the same columns."""
    ref, port = _pair()
    for table in ("tasks", "history"):
        sql = f"select * from system.runtime.{table}"
        assert port.execute(sql) == ref.execute(sql)
    key = 'trino_tpu_queries_total{state="FINISHED"}'
    names = []
    for r in (ref, port):
        r.execute("select 1")
        rows, cols = r.execute("select * from system.runtime.metrics")
        assert any(row[0] == key and row[1] == "counter" and row[2] >= 1 for row in rows)
        names.append(cols)
    assert names[1] == names[0]
    for table in ("tasks", "metrics", "history", "programs", "queries", "nodes"):
        sql = f"show columns from system.runtime.{table}"
        assert port.execute(sql) == ref.execute(sql)


def test_runtime_programs_and_operator_section():
    """One distributed query in both packages: the program-cache rows
    (fingerprint, program labels, hit and miss counters) and EXPLAIN
    ANALYZE's operator section (every site the port counts, with the
    reference's kind and row counts). The reference also counts its
    exchanges (``exch`` sites); the port's exchanges wait for the
    N-shard mesh (ROADMAP item 8b)."""
    ref, port = _pair("distributed")
    for r in (ref, port):
        r.execute(SQL)
        r.execute(SQL)
    sql = "select fingerprint, program, hits, misses from system.runtime.programs"
    got, want = port.execute(sql)[0], ref.execute(sql)[0]
    assert sorted(got) == sorted(want)
    text = {}
    for name, r in (("ref", ref), ("port", port)):
        lines = [row[0] for row in r.execute("explain analyze " + SQL)[0]]
        start = lines.index("Operators (in-program row flow, by stable site):")
        section = []
        for line in lines[start + 1:]:
            if not line.startswith("  ") or "reduction ratio" in line:
                break
            section.append(line.strip())
        text[name] = section
    ports = {line.split(":")[0]: line for line in text["port"]}
    refs = {line.split(":")[0]: line for line in text["ref"]}
    assert ports and set(ports) <= set(refs)
    assert {s for s in refs if not s.startswith("exch")} == set(ports)
    for site, line in ports.items():
        assert line == refs[site]
