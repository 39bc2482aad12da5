"""The semantic result cache through trino_tpu_torch, against the reference.

The sixteen cases of ``tests/test_result_cache.py`` run each scenario on
both packages over the same seeded tables (``memory.default.t``, BIGINT
keys and values from numpy): the rows (as a multiset: a GROUP BY without
ORDER BY has no order), the ``result_cache_stats`` of every statement and
the cache's ``snapshot()`` counters must be equal, and each case's own
assertions hold on the port. Every value is BIGINT, so equality is exact.
"""

import threading
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

AGG = (
    "select k, sum(v) as s, count(*) as c, min(v) as mn, max(v) as mx "
    "from t group by k"
)
COUNTERS = ("hits", "misses", "evictions", "maintained", "invalidations", "memoSize")


def _package(name: str):
    if name == "reference":
        from trino_tpu import types as T
        from trino_tpu.columnar import Batch, Column
        from trino_tpu.config import Session
        from trino_tpu.connectors.api import ColumnSchema, TableSchema
        from trino_tpu.connectors.file import FileConnector
        from trino_tpu.engine import Engine
        from trino_tpu.ingest import parts_delta
        from trino_tpu.security import AccessDeniedError, FileBasedAccessControl
        from trino_tpu.server.querymanager import QueryManager
        from trino_tpu.server.statemachine import TERMINAL_QUERY_STATES

        return types.SimpleNamespace(
            name=name, T=T, Batch=Batch, Column=Column, Session=Session,
            ColumnSchema=ColumnSchema, TableSchema=TableSchema,
            FileConnector=FileConnector, parts_delta=parts_delta,
            engine=Engine, array=lambda a: a, AccessDeniedError=AccessDeniedError,
            FileBasedAccessControl=FileBasedAccessControl, QueryManager=QueryManager,
            TERMINAL=TERMINAL_QUERY_STATES,
        )
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch, Column, as_tensor
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
    from trino_tpu_torch.connectors.file import FileConnector
    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.ingest import parts_delta
    from trino_tpu_torch.security import AccessDeniedError, FileBasedAccessControl
    from trino_tpu_torch.server.querymanager import QueryManager
    from trino_tpu_torch.server.statemachine import TERMINAL_QUERY_STATES

    return types.SimpleNamespace(
        name=name, T=T, Batch=Batch, Column=Column, Session=Session,
        ColumnSchema=ColumnSchema, TableSchema=TableSchema,
        FileConnector=FileConnector, parts_delta=parts_delta,
        engine=lambda: Engine(device="cpu"), array=as_tensor,
        AccessDeniedError=AccessDeniedError,
        FileBasedAccessControl=FileBasedAccessControl, QueryManager=QueryManager,
        TERMINAL=TERMINAL_QUERY_STATES,
    )


def _batch(pkg, n, seed):
    r = np.random.default_rng(seed)
    return pkg.Batch(
        [
            pkg.Column(pkg.T.BIGINT, pkg.array(r.integers(0, 8, n).astype(np.int64))),
            pkg.Column(pkg.T.BIGINT, pkg.array(r.integers(0, 100, n).astype(np.int64))),
        ],
        n,
    )


def _schema(pkg):
    return pkg.TableSchema(
        "t", (pkg.ColumnSchema("k", pkg.T.BIGINT), pkg.ColumnSchema("v", pkg.T.BIGINT))
    )


def _engine(pkg, parts=((2000, 0),)):
    engine = pkg.engine()
    mem = engine.catalogs.get("memory")
    mem.create_table("default", "t", _schema(pkg))
    for n, seed in parts:
        mem.insert("default", "t", _batch(pkg, n, seed))
    return engine, mem


def _sess(pkg, **props):
    return pkg.Session(
        catalog="memory", schema="default", properties={"result_cache": True, **props}
    )


def _sorted(rows):
    return sorted(tuple(r) for r in rows)


class Log:
    """What one package observed: each statement's rows and cache stats,
    and the cache's counters at the end."""

    def __init__(self):
        self.seen: list = []

    def run(self, engine, sql, session):
        res = engine.execute_statement(sql, session)
        stats = dict(res.result_cache_stats) if res.result_cache_stats else None
        self.seen.append((sql, _sorted(res.rows), stats))
        return res

    def close(self, engine):
        snap = engine.result_cache.snapshot()
        self.seen.append({k: snap[k] for k in COUNTERS})
        self.seen.append(sorted(
            (e["rows"], e["hits"], e["maintainable"], e["maintainedCount"], e["query"])
            for e in snap["entries"]
        ))
        return self.seen


def case_warm_repeat_pure_hit(pkg):
    log = Log()
    engine, _ = _engine(pkg)
    s = _sess(pkg)
    cold = log.run(engine, AGG, s)
    assert cold.result_cache_stats is None
    warm = log.run(engine, AGG, s)
    rc = warm.result_cache_stats
    assert rc is not None and rc["resultCacheHit"] == 1
    assert warm.ingest_stats is None
    assert warm.trace_count == 0 and warm.compile_ms == 0.0
    assert _sorted(warm.rows) == _sorted(cold.rows)
    assert warm.column_names == cold.column_names
    snap = engine.result_cache.snapshot()
    assert snap["hits"] == 1 and snap["entries"][0]["maintainable"]
    return log.close(engine)


def case_bit_identical_on_off_invalidated(pkg):
    log = Log()
    engine, mem = _engine(pkg)
    on = log.run(engine, AGG, _sess(pkg))
    off = log.run(engine, AGG, _sess(pkg, result_cache=False))
    hit = log.run(engine, AGG, _sess(pkg))
    assert hit.result_cache_stats["resultCacheHit"] == 1
    mem.truncate("default", "t")
    mem.insert("default", "t", _batch(pkg, 2000, 0))
    inval = log.run(engine, AGG, _sess(pkg))
    assert inval.result_cache_stats is None
    assert _sorted(on.rows) == _sorted(off.rows) == _sorted(hit.rows) == _sorted(inval.rows)
    return log.close(engine)


def case_param_vector_miss(pkg):
    log = Log()
    engine, _ = _engine(pkg)
    s = _sess(pkg)
    a = log.run(engine, "select sum(v) as s from t where k < 3", s)
    b = log.run(engine, "select sum(v) as s from t where k < 5", s)
    assert b.result_cache_stats is None and a.rows != b.rows
    a2 = log.run(engine, "select sum(v) as s from t where k < 3", s)
    b2 = log.run(engine, "select sum(v) as s from t where k < 5", s)
    assert a2.result_cache_stats["resultCacheHit"] == 1
    assert b2.result_cache_stats["resultCacheHit"] == 1
    assert a2.rows == a.rows and b2.rows == b.rows
    return log.close(engine)


def case_coarse_version_bump_invalidates(pkg):
    log = Log()
    engine, mem = _engine(pkg)
    mem.data_versions = lambda schema, table: None
    s = _sess(pkg)
    log.run(engine, AGG, s)
    assert log.run(engine, AGG, s).result_cache_stats is not None
    mem._version += 1  # a catalog version bump without a data change
    assert log.run(engine, AGG, s).result_cache_stats is None
    assert engine.result_cache.snapshot()["invalidations"] == 1
    return log.close(engine)


def case_acl_generation_bump_drops_entry(pkg):
    log = Log()
    engine, _ = _engine(pkg)
    s = _sess(pkg)
    log.run(engine, AGG, s)
    assert log.run(engine, AGG, s).result_cache_stats is not None
    engine.access_control.add(pkg.FileBasedAccessControl({"catalogs": [{"allow": "all"}]}))
    assert log.run(engine, AGG, s).result_cache_stats is None
    assert log.run(engine, AGG, s).result_cache_stats is not None
    return log.close(engine)


def case_acl_denied_user_never_served_from_cache(pkg):
    log = Log()
    engine, _ = _engine(pkg)
    engine.access_control.add(pkg.FileBasedAccessControl(
        {"catalogs": [{"user": "alice", "catalog": ".*", "allow": "all"}]}
    ))
    alice = pkg.Session(user="alice", catalog="memory", schema="default",
                        properties={"result_cache": True})
    log.run(engine, AGG, alice)
    assert log.run(engine, AGG, alice).result_cache_stats is not None
    bob = pkg.Session(user="bob", catalog="memory", schema="default",
                      properties={"result_cache": True})
    with pytest.raises(pkg.AccessDeniedError):
        engine.execute_statement(AGG, bob)
    return log.close(engine)


def case_lru_eviction_order(pkg):
    log = Log()
    engine, _ = _engine(pkg)
    s = _sess(pkg)
    qa = "select sum(v) as s from t where k < 2"
    qb = "select sum(v) as s from t where k < 4"
    qc = "select sum(v) as s from t where k < 6"
    log.run(engine, qa, s)
    per_entry = engine.result_cache.snapshot()["entries"][0]["nbytes"]
    s2 = _sess(pkg, result_cache_max_bytes=per_entry * 2 + per_entry // 2)
    log.run(engine, qb, s2)
    assert log.run(engine, qa, s2).result_cache_stats is not None
    log.run(engine, qc, s2)  # evicts B, keeps A and C
    snap = engine.result_cache.snapshot()
    assert snap["evictions"] == 1 and len(snap["entries"]) == 2
    assert log.run(engine, qa, s2).result_cache_stats is not None
    assert log.run(engine, qc, s2).result_cache_stats is not None
    assert log.run(engine, qb, s2).result_cache_stats is None
    return log.close(engine)


def case_incremental_maintenance_append(pkg):
    log = Log()
    engine, mem = _engine(pkg)
    s = _sess(pkg)
    cold = log.run(engine, AGG, s)
    assert (cold.ingest_stats or {}).get("splits_decoded", 0) >= 1
    mem.insert("default", "t", _batch(pkg, 500, 1))
    maintained = log.run(engine, AGG, s)
    rc = maintained.result_cache_stats
    assert rc is not None and rc["incrementalMaintenance"] == 1
    assert rc["deltaSplits"] == 1
    assert maintained.ingest_stats["splits_decoded"] == 1
    ref_engine, _ = _engine(pkg, parts=((2000, 0), (500, 1)))
    ref = ref_engine.execute_statement(AGG, pkg.Session(catalog="memory", schema="default"))
    assert _sorted(maintained.rows) == _sorted(ref.rows)
    again = log.run(engine, AGG, s)
    assert again.result_cache_stats["resultCacheHit"] == 1
    assert "incrementalMaintenance" not in again.result_cache_stats
    assert again.result_cache_stats["maintainedCount"] == 1
    assert _sorted(again.rows) == _sorted(ref.rows)
    return log.close(engine)


def case_maintenance_disabled_falls_back_to_invalidation(pkg):
    log = Log()
    engine, mem = _engine(pkg)
    s = _sess(pkg, incremental_maintenance=False)
    log.run(engine, AGG, s)
    mem.insert("default", "t", _batch(pkg, 500, 1))
    assert log.run(engine, AGG, s).result_cache_stats is None
    assert log.run(engine, AGG, s).result_cache_stats is not None
    return log.close(engine)


def case_rewrite_invalidates_not_maintains(pkg):
    log = Log()
    engine, mem = _engine(pkg)
    s = _sess(pkg)
    log.run(engine, AGG, s)
    mem.truncate("default", "t")
    mem.insert("default", "t", _batch(pkg, 2500, 2))
    fresh = log.run(engine, AGG, s)
    assert fresh.result_cache_stats is None
    ref_engine, _ = _engine(pkg, parts=((2500, 2),))
    ref = ref_engine.execute_statement(AGG, pkg.Session(catalog="memory", schema="default"))
    assert _sorted(fresh.rows) == _sorted(ref.rows)
    return log.close(engine)


def case_non_maintainable_shapes_invalidate(pkg):
    log = Log()
    engine, mem = _engine(pkg)
    s = _sess(pkg)
    for seed, sql in enumerate((
        "select k, avg(v) as a from t group by k",  # avg: not mergeable
        AGG + " order by k",  # a sort above the aggregate
        "select count(distinct v) as d from t",  # exact distinct
    )):
        first = log.run(engine, sql, s)
        mem.insert("default", "t", _batch(pkg, 100, 10 + seed))
        second = log.run(engine, sql, s)
        assert second.result_cache_stats is None
        third = log.run(engine, sql, s)
        assert third.result_cache_stats["resultCacheHit"] == 1
        assert _sorted(third.rows) == _sorted(second.rows)
        assert first.column_names == second.column_names
    return log.close(engine)


def case_uncacheable_sql_and_cache_off(pkg):
    log = Log()
    engine, _ = _engine(pkg)
    off = pkg.Session(catalog="memory", schema="default")
    log.run(engine, AGG, off)
    log.run(engine, AGG, off)
    assert engine.result_cache.snapshot()["entries"] == []
    assert not engine._sql_cacheable("select now()")
    assert engine._result_cache_begin("select now()", _sess(pkg), None) is None
    return log.close(engine)


def case_file_connector_parts_delta(pkg, tmp_path):
    conn = pkg.FileConnector(str(tmp_path / pkg.name))
    conn.create_table("default", "t", _schema(pkg))
    conn.insert("default", "t", _batch(pkg, 100, 0))
    v1 = conn.data_versions("default", "t")
    conn.insert("default", "t", _batch(pkg, 50, 1))
    v2 = conn.data_versions("default", "t")
    verdict, appended = pkg.parts_delta(v1, v2)
    assert verdict == "append" and len(appended) == 1
    splits = conn.splits_for_parts("default", "t", appended)
    assert len(splits) == 1 and splits[0].info == appended[0]
    conn.truncate("default", "t")
    conn.insert("default", "t", _batch(pkg, 150, 2))
    v3 = conn.data_versions("default", "t")
    assert pkg.parts_delta(v2, v3)[0] == "changed"
    assert pkg.parts_delta(v2, v2)[0] == "same"
    rows = conn.read_split("default", "t", ["k", "v"], conn.get_splits("default", "t", 4)[0])
    return [len(v1), len(v2), len(v3), verdict, rows.num_rows]


def case_memory_restore_state_invalidates(pkg):
    log = Log()
    engine, mem = _engine(pkg)
    s = _sess(pkg)
    snap = mem.snapshot_state()
    log.run(engine, AGG, s)
    mem.restore_state(snap)  # a rollback: same bytes, fresh part ids
    assert log.run(engine, AGG, s).result_cache_stats is None
    return log.close(engine)


def case_concurrent_readers_see_consistent_snapshots(pkg):
    engine, mem = _engine(pkg, parts=((4000, 0),))
    snap_a = _sorted(engine.execute_statement(AGG, _sess(pkg)).rows)
    ref_engine, _ = _engine(pkg, parts=((4000, 0), (1000, 1)))
    snap_b = _sorted(ref_engine.execute_statement(
        AGG, pkg.Session(catalog="memory", schema="default")).rows)
    bad: list = []
    hits = [0]
    lock = threading.Lock()
    start = threading.Barrier(5)

    def reader():
        start.wait()
        for _ in range(12):
            res = engine.execute_statement(AGG, _sess(pkg))
            got = _sorted(res.rows)
            with lock:
                if res.result_cache_stats is not None:
                    hits[0] += 1
                if got != snap_a and got != snap_b:
                    bad.append(got)

    def writer():
        start.wait()
        mem.insert("default", "t", _batch(pkg, 1000, 1))

    threads = [threading.Thread(target=reader) for _ in range(4)]
    threads.append(threading.Thread(target=writer))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad, f"inconsistent snapshot observed: {bad[:1]}"
    assert hits[0] >= 1
    final = engine.execute_statement(AGG, _sess(pkg))
    assert _sorted(final.rows) == snap_b
    # the interleaving is the threads', so only the end states compare
    return [snap_a, snap_b, _sorted(final.rows)]


def case_query_manager_fast_path_bypasses_admission(pkg):
    engine, _ = _engine(pkg)
    engine.execute_statement(AGG, _sess(pkg))  # warm the entry
    qm = pkg.QueryManager(engine)
    q = qm.create_query(AGG, _sess(pkg))
    # a pure hit completes inside create_query: no admission, no thread
    assert q.state.get().value == "FINISHED"
    info = q.info()
    assert info["queryStats"]["resultCacheHit"] == 1
    assert info["resultCacheStats"]["resultCacheHit"] == 1
    q2 = qm.create_query("select count(*) as c from t where k < 7", _sess(pkg))
    q2.state.wait_for(lambda st: st in pkg.TERMINAL, timeout=30.0)
    assert q2.state.get().value == "FINISHED"
    assert q2.info()["queryStats"]["resultCacheHit"] == 0
    return [_sorted(q.result.rows), _sorted(q2.result.rows),
            info["resultCacheStats"], q2.info()["queryStats"]["resultCacheHit"]]


CASES = {name[5:]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_result_cache_case_equals_reference(case, tmp_path):
    fn = CASES[case]
    kwargs = {"tmp_path": tmp_path} if "tmp_path" in fn.__code__.co_varnames else {}
    want = fn(_package("reference"), **kwargs)
    got = fn(_package("port"), **kwargs)
    assert got == want


def test_a_pure_hit_runs_nothing_on_the_device():
    """A hit stages nothing, reserves no memory and launches no kernel:
    neither the plain versions of the kernels nor the memory pool move."""
    from trino_tpu_torch import _kernels

    pkg = _package("port")
    engine, _ = _engine(pkg)
    s = _sess(pkg, execution_mode="distributed")
    cold = engine.execute_statement(AGG, s)
    plain = dict(_kernels.PLAIN_CALLS)
    launches = dict(_kernels.LAUNCHES)
    reserved = engine.memory_pool.reserved
    hit = engine.execute_statement(AGG, s)
    assert hit.result_cache_stats["resultCacheHit"] == 1
    assert dict(_kernels.PLAIN_CALLS) == plain and dict(_kernels.LAUNCHES) == launches
    assert hit.peak_memory_bytes == 0 and hit.exchange_stats is None
    assert engine.memory_pool.reserved == reserved
    assert _sorted(hit.rows) == _sorted(cold.rows)
