"""The port's cross-query program cache (``planner/canonicalize.py``,
``Engine._query_cache_entry``, ``exec/programs.py``) against the
reference's (``tests/test_program_cache.py``): cacheability by whole
lexer tokens, fingerprints stable across the plan serde and blind to
literals and symbol counters, literal variants served by the cached
programs with 0 retraces and rows equal to the baked path and to the
reference's, invalidation on a data-version bump and on an
access-control generation bump, and the LRU bound on the entry map. The
reference's own distributed runs give the counts of the first case.
"""

import numpy as np
import pytest
import torch

from trino_tpu import types as RT
from trino_tpu.columnar import Batch as RBatch, Column as RColumn
from trino_tpu.config import Session as RSession
from trino_tpu.connectors.api import ColumnSchema as RColumnSchema, TableSchema as RTableSchema
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import batch_from_numpy
from trino_tpu_torch.config import Session
from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
from trino_tpu_torch.testing import LocalQueryRunner

torch.set_num_threads(1)

Q = "select k, sum(v) from memory.default.pc_facts where v < {} group by k"


def _columns(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 32, rows).astype(np.int64),
            rng.integers(0, 1000, rows).astype(np.int64))


def _add_table(runner, name: str, rows: int = 1024, seed: int = 3) -> None:
    mem = runner.catalogs.get("memory")
    mem.create_table("default", name, TableSchema(
        name, (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))))
    mem.insert("default", name, batch_from_numpy([T.BIGINT, T.BIGINT], list(_columns(rows, seed))))


def _port_runner() -> LocalQueryRunner:
    r = LocalQueryRunner(Session(user="t", catalog="memory", schema="default"), device="cpu")
    r.session.set("execution_mode", "distributed")
    return r


@pytest.fixture(scope="module")
def runner():
    r = _port_runner()
    _add_table(r, "pc_facts")
    return r


@pytest.fixture(scope="module")
def reference():
    """The reference in distributed mode over the same table."""
    ref = RefRunner(RSession(user="t", catalog="memory", schema="default"))
    ref.session.set("execution_mode", "distributed")
    mem = ref.catalogs.get("memory")
    mem.create_table("default", "pc_facts", RTableSchema(
        "pc_facts", (RColumnSchema("k", RT.BIGINT), RColumnSchema("v", RT.BIGINT))))
    k, v = _columns(1024, 3)
    mem.insert("default", "pc_facts", RBatch([RColumn(RT.BIGINT, k), RColumn(RT.BIGINT, v)], 1024))
    return ref


def _baked_session(runner) -> Session:
    s = Session(user="t", catalog="memory", schema="default")
    s.properties.update(runner.session.properties)
    s.set("program_cache", False)
    return s


def test_sql_cacheable_tokenizes(runner, reference):
    texts = ["select brand(x) from t", "select randomness from t", "select known from t",
             "select random() from t", "select rand() from t", "select current_timestamp",
             "select uuid()", "select 'unterminated"]
    got = [runner.engine._sql_cacheable(s) for s in texts]
    assert got == [reference.engine._sql_cacheable(s) for s in texts]
    assert got == [True, True, True, False, False, False, False, False]


def test_fingerprint_stable_across_serde_roundtrip(runner):
    from trino_tpu_torch.planner.canonicalize import canonicalize_plan, plan_fingerprint
    from trino_tpu_torch.planner.serde import node_from_json, node_to_json

    plan = runner.plan(Q.format(100))
    canonical, params, fp = canonicalize_plan(plan, runner.session)
    assert fp is not None and [v for v, _ in params] == [100]
    # a wire round trip of the canonical plan fingerprints identically
    again = node_from_json(node_to_json(canonical))
    assert plan_fingerprint(again, runner.session, 1, nparams=len(params)) == fp


def test_fingerprint_ignores_literals_and_symbol_counters(runner, reference):
    eng = runner.engine
    fp1, p1 = eng.fingerprint(Q.format(100), runner.session)
    fp2, p2 = eng.fingerprint(Q.format(900), runner.session)
    assert fp1 == fp2
    assert [v for v, _ in p1] == [100] and [v for v, _ in p2] == [900]
    fp3, _ = eng.fingerprint(
        "select k, count(*) from memory.default.pc_facts where v < 100 group by k",
        runner.session)
    assert fp3 != fp1
    # the reference hoists the same literals
    assert [v for v, _ in reference.engine.fingerprint(Q.format(900), reference.session)[1]] == [900]


def test_literal_variation_hits_cache(runner, reference):
    eng = runner.engine
    cold = eng.execute_statement(Q.format(100), runner.session)
    assert cold.trace_count >= 1 and cold.program_cache_misses >= 1
    warm = eng.execute_statement(Q.format(250), runner.session)
    assert warm.program_cache_hits >= 1
    assert warm.trace_count == 0 and warm.program_cache_misses == 0
    baked = eng.execute_statement(Q.format(250), _baked_session(runner))
    assert sorted(warm.rows) == sorted(baked.rows)
    assert baked.trace_count >= 1 and baked.program_cache_hits == 0
    # the reference's counts and rows for the same two runs
    rcold = reference.engine.execute_statement(Q.format(100), reference.session)
    rwarm = reference.engine.execute_statement(Q.format(250), reference.session)
    assert (rcold.trace_count >= 1, rwarm.trace_count, rwarm.program_cache_misses) == (
        cold.trace_count >= 1, warm.trace_count, warm.program_cache_misses)
    assert rwarm.program_cache_hits >= 1
    assert sorted(rwarm.rows) == sorted(warm.rows)
    assert sorted(rcold.rows) == sorted(cold.rows)


def test_repeat_execution_zero_retrace(runner):
    eng = runner.engine
    sql = "select count(*), min(v), max(v) from memory.default.pc_facts"
    first = eng.execute_statement(sql, runner.session)
    second = eng.execute_statement(sql, runner.session)
    assert first.rows == second.rows
    assert second.trace_count == 0 and second.program_cache_hits >= 1
    assert second.compile_ms == 0.0


def test_invalidation_on_catalog_version_bump(runner):
    eng = runner.engine
    sql = "select k, max(v) from memory.default.pc_facts group by k"
    eng.execute_statement(sql, runner.session)
    assert eng.execute_statement(sql, runner.session).program_cache_hits >= 1
    _add_table(runner, "pc_bump", rows=8, seed=9)  # bumps the memory catalog's version
    cold = eng.execute_statement(sql, runner.session)
    assert cold.program_cache_hits == 0 and cold.trace_count >= 1


def test_invalidation_on_access_control_generation(runner):
    eng = runner.engine
    sql = "select k, min(v) from memory.default.pc_facts group by k"
    eng.execute_statement(sql, runner.session)
    assert eng.execute_statement(sql, runner.session).program_cache_hits >= 1
    eng.access_control.generation += 1
    cold = eng.execute_statement(sql, runner.session)
    assert cold.program_cache_hits == 0 and cold.trace_count >= 1


def test_lru_eviction_bound():
    r = _port_runner()
    _add_table(r, "pc_lru", rows=256, seed=5)
    eng = r.engine
    eng._QUERY_CACHE_MAX = 3
    shapes = [
        "select count(*) from memory.default.pc_lru",
        "select sum(v) from memory.default.pc_lru",
        "select k, count(*) from memory.default.pc_lru group by k",
        "select k, sum(v) from memory.default.pc_lru group by k",
        "select k, min(v) from memory.default.pc_lru group by k",
    ]
    for sql in shapes:
        eng.execute_statement(sql, r.session)
    assert len(eng._query_cache) <= 3
    again = eng.execute_statement(shapes[-1], r.session)
    assert again.trace_count == 0 and again.program_cache_hits >= 1


def test_tpch_programs_capture_without_host_reads():
    """Every program the 22 TPC-H queries store at ``tpch.tiny`` passes
    the CPU rehearsal of its capture (no host read, no data-dependent
    shape inside it, ``exec/programs.py::HostReadGuard``), and the warm
    runs trace nothing, equal the cold ones and run whole under
    ``checked_syncs``: outside the counted reads (the programs' words,
    dynamic-filter lookups, the result's read) nothing reads the device
    on the host."""
    from trino_tpu_torch.benchmarks.tpch import queries
    from trino_tpu_torch.exec.programs import checked_syncs

    r = LocalQueryRunner(device="cpu")
    r.session.set("execution_mode", "distributed")
    r.engine.program_pool.rehearse = True
    for q, sql in queries("tpch.tiny").items():
        cold = r.engine.execute_statement(sql, r.session)
        with checked_syncs("cpu"):
            warm = r.engine.execute_statement(sql, r.session)
        assert warm.rows == cold.rows, q
        assert cold.trace_count >= 1 and warm.trace_count == 0, q
        assert warm.program_cache_hits >= 1, q
        assert warm.exchange_stats["result_reads"] == 1, q


@pytest.mark.parametrize("q", [1, 3, 5, 17, 21])
def test_streamed_and_eager_fragments_are_the_only_other_syncs(q):
    """With lineitem past the streaming threshold (as at SF1 on the
    card), a warm run's streamed chunk loops and eager fragments are the
    only host-synchronizing work outside the counted reads, each counted
    in ``host_synced_fragments``; the run passes ``checked_syncs``."""
    from trino_tpu_torch.benchmarks.tpch import queries
    from trino_tpu_torch.exec.programs import checked_syncs

    r = LocalQueryRunner(device="cpu")
    r.session.set("execution_mode", "distributed")
    r.session.set("stream_scan_threshold_rows", 1 << 14)
    sql = queries("tpch.tiny")[q]
    cold = r.engine.execute_statement(sql, r.session)
    with checked_syncs("cpu"):
        warm = r.engine.execute_statement(sql, r.session)
    assert warm.rows == cold.rows and warm.trace_count == 0
    modes = list((warm.fragment_modes or {}).values())
    synced = warm.exchange_stats.get("host_synced_fragments", 0)
    assert synced >= modes.count("streamed") and synced >= 1


def test_checked_syncs_raise_outside_the_counted_reads():
    """``checked_syncs`` (on the CPU through ``HostReadGuard``) raises on a
    host read and lets ``allow_sync`` and ``host_read`` through, nested
    or not; a capture rehearsal's guard is not lifted by them."""
    from trino_tpu_torch.exec.programs import (
        CaptureError, HostReadGuard, allow_sync, checked_syncs, host_read,
    )

    x = torch.arange(4)
    stats = {}
    with checked_syncs("cpu"):
        with pytest.raises(CaptureError):
            x.sum().item()
        with allow_sync("cpu"):
            assert int(x.sum()) == 6
        assert host_read(x, stats) == [0, 1, 2, 3] and stats["host_reads"] == 1
        with pytest.raises(CaptureError):
            x.tolist()
    assert x.tolist() == [0, 1, 2, 3]
    with checked_syncs("cpu"), allow_sync("cpu"), HostReadGuard():
        with pytest.raises(CaptureError):
            x.tolist()


def test_pool_evicts_least_recently_used_to_a_byte_target():
    """``ProgramPool.evict_lru(target)`` drops programs least recently
    used first until those left hold at most ``target`` bytes; 0 drops
    them all."""
    from trino_tpu_torch.exec.programs import Program, ProgramPool

    pool, store = ProgramPool("cpu"), {}
    for k in range(4):
        store[k] = Program(("frag", k), f"frag:{k}", None, None)
        store[k].held_bytes = 100
        pool.touch(store, k)
    pool.touch(store, 0)  # 0 is now the most recently used
    assert pool.held_bytes() == 400
    assert pool.evict_lru(250) == 2 and sorted(store) == [0, 3]
    assert pool.evict_lru(200) == 0 and pool.held_bytes() == 200
    pool.touch(store, 3)
    assert pool.evict_lru(100) == 1 and sorted(store) == [3]
    assert pool.evict_lru() == 1 and not store and pool.evicted == 4


def test_pool_generations_release_least_recently_used_first():
    """Before a capture, past the budget, ``ProgramPool.make_room`` drops
    the graphs of least recently used programs until an older generation
    holds none (it is released, its segments back to the card); the
    programs stay stored, without a graph. The newest generation closes
    to captures once its graphs' live blocks pass half the budget; the
    freed scratch in its segments does not close it. The segment and
    live sizes are given here; on the card they come from the
    allocator."""
    from trino_tpu_torch.exec.programs import Program, ProgramPool

    class Pool(ProgramPool):
        sizes: dict = {}
        live: dict = {}

        def _segments_by_generation(self):
            return {id(g): (self.sizes[g["name"]], self.live.get(g["name"], 0))
                    for g in self._gens}

    pool, store = Pool("cpu"), {}
    pool.budget_bytes = 100
    gens = {n: {"handle": (0, i), "programs": set(), "open": n == "b", "name": n}
            for i, n in enumerate("ab")}
    pool._gens = [gens["a"], gens["b"]]
    for k, g in ((0, "a"), (1, "a"), (2, "b"), (3, "a"), (4, "b")):
        store[k] = Program(("frag", k), f"frag:{k}", None, None)
        store[k].generation = gens[g]
        gens[g]["programs"].add(id(store[k]))
        pool.touch(store, k)
    pool.touch(store, 1)  # a's 1 used last: a is released only after it
    Pool.sizes = {"a": 70, "b": 40}
    pool.make_room()
    # the graphs of 0, 2, 3, 4 went in LRU order: 4 emptied b, which was
    # released; 1, the most recently used, keeps its graph in a
    assert [k for k in store if store[k].generation is not None] == [1]
    assert sorted(store) == [0, 1, 2, 3, 4] and pool._gens == [gens["a"]]
    assert pool.dropped == 4 and pool.evicted == 0
    store2 = {}
    pool._gens = [gens["a"], gens["b"]]
    for g in gens.values():
        g["programs"].clear()
    gens["b"]["open"] = True
    for k, g in ((0, "a"), (1, "b"), (2, "a"), (3, "b")):
        store2[k] = Program(("frag", k), f"frag:{k}", None, None)
        store2[k].generation = gens[g]
        gens[g]["programs"].add(id(store2[k]))
        pool.touch(store2, k)
    Pool.sizes, Pool.live = {"a": 30, "b": 60}, {"b": 10}
    pool.make_room()
    # within the budget, and b's segments mostly freed scratch: it stays
    # open, every graph kept
    assert gens["b"]["open"] and pool.dropped == 4
    Pool.sizes, Pool.live = {"a": 70, "b": 60}, {"b": 60}
    pool.make_room()
    # b's live blocks passed half the budget: closed; the graphs of 0, 1
    # and 2 went, which emptied a (released); 3 keeps its graph in b
    assert [k for k in store2 if store2[k].generation is not None] == [3]
    assert sorted(store2) == [0, 1, 2, 3] and pool._gens == [gens["b"]]
    assert not gens["b"]["open"]
    Pool.sizes = {"b": 60}
    pool.make_room()
    # one generation within the budget keeps its graphs
    assert [k for k in store2 if store2[k].generation is not None] == [3]


def test_pool_budget_is_a_bound_with_one_generation():
    """The generations' segments stay within the budget after every
    capture and eviction, one generation alone too: ``make_room`` and
    ``settle`` drop the graphs of least recently used programs until the
    generations fit (a generation left with no graph is released), a new
    graph whose generation alone passes the budget goes with its
    generation's, and a program whose graph went stays stored (a later
    hit runs it, and captures it again once what its capture took fits).
    The allocator's segments come from a given snapshot."""
    from trino_tpu_torch.exec.programs import Program, ProgramPool

    sizes: dict = {}
    pool, store = ProgramPool("cpu"), {}
    pool.snapshot = lambda: [
        {"segment_pool_id": g["handle"], "total_size": sizes[g["name"]]}
        for g in pool._gens
    ]
    pool.budget_bytes = 100

    def reserved():
        return sum(pool._reserved_by_generation().values())

    def add(k, gen):
        store[k] = Program(("frag", k), f"frag:{k}", None, None)
        store[k].generation, store[k].graph = gen, object()
        if gen is not None:
            gen["programs"].add(id(store[k]))
        pool.touch(store, k)

    def holders():
        return sorted(k for k in store if store[k].graph is not None)

    gen = {"handle": (0, 1), "programs": set(), "open": True, "name": "a"}
    pool._gens = [gen]
    for k in range(3):
        add(k, gen)
    sizes["a"] = 150  # one generation past the budget
    pool.make_room()
    assert holders() == [] and sorted(store) == [0, 1, 2]
    assert pool._gens == [] and reserved() == 0 and pool.dropped == 3
    # a capture (5) in a generation with an older program (4): the older
    # graphs go, least recently used first, until the generations fit
    gen = {"handle": (0, 2), "programs": set(), "open": True, "name": "b"}
    other = {"handle": (0, 3), "programs": set(), "open": False, "name": "c"}
    pool._gens = [other, gen]
    add(4, gen)
    add(5, gen)
    add(6, other)
    sizes.update(b=60, c=70)
    pool.settle(store[5])
    # 4's graph went, freeing nothing; then 6's emptied c (released)
    assert holders() == [5] and sorted(store) == [0, 1, 2, 4, 5, 6]
    assert pool._gens == [gen] and reserved() == 60 <= pool.budget_bytes
    assert store[5].pool_bytes == 60 and pool.evicted == 0
    # a graph whose generation alone passes the budget goes too
    sizes["b"] = 120
    pool.settle(store[5])
    assert holders() == [] and 5 in store and pool._gens == [] and reserved() == 0
    assert pool.dropped == 6
    # its capture size is now its generation's: no room for it again
    assert store[5].capture_bytes == 120 and not pool.may_recapture(store[5])
    # programs without a graph hold no segment: the budget passes them by
    # (5 is the least recently used here) and takes the graphs
    pool.touch(store, 5)
    for k, name in ((7, "d"), (8, "e")):
        g = {"handle": (0, k), "programs": set(), "open": False, "name": name}
        pool._gens.append(g)
        add(k, g)
    sizes.update(d=50, e=70)
    pool.settle(store[8])
    assert holders() == [8] and reserved() == 70 and pool.dropped == 7
    # a program whose graph went is captured again on a hit once what its
    # capture took fits beside the generations' segments
    store[6].capture_bytes = 30
    assert store[6].graph is None and pool.may_recapture(store[6])
    store[6].capture_bytes = 31
    assert not pool.may_recapture(store[6])
    assert not pool.may_recapture(store[8])  # it holds its graph
    assert pool.evict_lru() == 8 and not store and pool.evicted == 8
