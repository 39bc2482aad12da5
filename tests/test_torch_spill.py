"""Query memory accounting, the memory pool and the spilled operators of
trino_tpu_torch against the JAX reference, on the CPU.

The cases of ``tests/test_memory_spill.py``, with the port beside the
reference: the pool and context semantics run on both packages' classes;
each spill case runs through the port's interpreter
(``execution_mode=local``) with a low ``spill_threshold_rows``, and its
rows must equal the reference's interpreter's (unspilled; the reference's
own tests hold its spilled rows equal to those) and the port's unspilled
rows exactly, ORDER BY order included, while the port reports the
operator it spilled. For the window cases (the reference compiles its
window for about 20 s on a CPU) the reference's rows are committed as
their count and digest; the port's unspilled windows are held against
the live reference in ``tests/test_torch_window.py``. A query over ``query_max_memory_bytes`` fails with
``ExceededMemoryLimitError``, classified as the reference classifies it.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from trino_tpu import errors as ref_errors
from trino_tpu import memory as ref_memory
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import errors, memory
from trino_tpu_torch.benchmarks.tpch import canonical_rows
from trino_tpu_torch.config import Session
from trino_tpu_torch.testing import LocalQueryRunner

torch.set_num_threads(1)

BOTH = pytest.mark.parametrize("mod", [ref_memory, memory], ids=["reference", "port"])


@BOTH
def test_pool_reserve_free_and_largest_query(mod):
    pool = mod.MemoryPool(1000)
    assert pool.try_reserve("q1", 600)
    assert not pool.try_reserve("q2", 600)
    assert pool.try_reserve("q2", 400)
    assert pool.largest_query() == "q1"
    pool.free("q1", 600)
    assert pool.free_bytes == 600 and pool.largest_query() == "q2"


@BOTH
def test_query_limit_and_pool_exhaustion_raise(mod):
    ctx = mod.QueryMemoryContext(mod.MemoryPool(10_000), "q", max_bytes=100)
    ctx.reserve(80)
    with pytest.raises(mod.ExceededMemoryLimitError):
        ctx.reserve(50)
    with pytest.raises(mod.ExceededMemoryLimitError):
        mod.QueryMemoryContext(mod.MemoryPool(100), "q").reserve(200)


@BOTH
def test_revoke_hook_and_peak(mod):
    pool = mod.MemoryPool(100)
    pool.try_reserve("other", 80)
    freed = []

    def revoke(n):
        pool.free("other", 80)
        freed.append(n)
        return 80

    ctx = mod.QueryMemoryContext(pool, "q", on_revoke=revoke)
    ctx.reserve(60)
    ctx.free(40)
    ctx.reserve(10)
    assert freed == [60] and ctx.peak_bytes == 60


def test_batch_nbytes_is_the_ingest_one():
    from trino_tpu_torch import ingest
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch, Column

    assert memory.batch_nbytes is ingest.batch_nbytes
    b = Batch([Column(T.BIGINT, torch.zeros(100, dtype=torch.int64))], 100)
    assert memory.batch_nbytes(b) == 800


@pytest.fixture(scope="module")
def ref():
    return RefRunner()


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner(device="cpu")


def test_query_accounting_peaks_and_frees(port):
    res = port.engine.execute_statement(
        "select o_orderpriority, count(*) from tpch.tiny.orders group by o_orderpriority",
        port.session,
    )
    assert len(res.rows) == 5
    assert res.peak_memory_bytes >= 15000 * 8  # the scanned column at least
    assert port.engine.memory_pool.reserved == 0


def test_query_over_its_limit_is_killed(port):
    session = Session()
    session.set("query_max_memory_bytes", 1000)
    runner = LocalQueryRunner(session, engine=port.engine)
    with pytest.raises(memory.ExceededMemoryLimitError) as err:
        runner.execute("select count(o_custkey) from tpch.tiny.orders")
    assert port.engine.memory_pool.reserved == 0
    assert errors.classify_error(err.value) == ref_errors.classify_error(
        ref_memory.ExceededMemoryLimitError("x")
    ) == (131075, "EXCEEDED_MEMORY_LIMIT", "INSUFFICIENT_RESOURCES")


K5 = "case when o_custkey % 5 = 0 then null else o_custkey % 5 end"
K4 = "case when o_custkey % 4 = 0 then null else o_custkey % 4 end"

# name -> (sql, spill_threshold_rows, spill_partitions, spilled kinds,
# ordered); the cases of test_memory_spill.py
CASES = {
    "join": (
        "select o.o_orderpriority, count(*) c from tpch.tiny.lineitem l "
        "join tpch.tiny.orders o on l.l_orderkey = o.o_orderkey "
        "group by o.o_orderpriority", 1000, 4, {"join", "aggregate"}, False),
    "left-join": (
        "select count(*), count(o.o_orderkey) from tpch.tiny.customer c "
        "left join tpch.tiny.orders o on c.c_custkey = o.o_custkey", 500, 8, {"join"}, True),
    "aggregate": (
        "select l_orderkey, sum(l_quantity) q, count(*) c "
        "from tpch.tiny.lineitem group by l_orderkey", 1000, 4, {"aggregate"}, False),
    "string-keys": (
        "select l_shipmode, l_returnflag, count(*) c from tpch.tiny.lineitem "
        "group by l_shipmode, l_returnflag", 1000, 8, {"aggregate"}, False),
    "null-keys": (
        f"select {K5} k, count(*), sum(o_totalprice) from tpch.tiny.orders group by {K5}",
        1000, 4, {"aggregate"}, False),
    "sort": (
        "select l_orderkey, l_extendedprice from tpch.tiny.lineitem"
        " order by l_extendedprice desc, l_orderkey", 1000, 4, {"sort"}, True),
    "sort-nulls-last": (
        f"select {K4} k, o_orderkey from tpch.tiny.orders order by {K4}, o_orderkey",
        1000, 4, {"sort"}, True),
    "sort-nulls-first": (
        f"select {K4} k, o_orderkey from tpch.tiny.orders order by {K4} nulls first, o_orderkey",
        1000, 4, {"sort"}, True),
    "topn": (
        "select l_orderkey, l_extendedprice from tpch.tiny.lineitem"
        " order by l_extendedprice desc, l_linenumber, l_orderkey limit 50",
        1000, 4, {"sort"}, True),
    "window": (
        "select o_custkey, o_orderkey,"
        " rank() over (partition by o_custkey order by o_totalprice desc) r,"
        " sum(o_totalprice) over (partition by o_custkey) s"
        " from tpch.tiny.orders order by o_custkey, r, o_orderkey",
        1000, 4, {"window", "sort"}, True),
    "window-string-min": (
        "select o_custkey, min(o_orderpriority) over (partition by o_custkey) mn"
        " from tpch.tiny.orders order by o_custkey, mn limit 100",
        1000, 4, {"window", "sort"}, True),
}


# the reference interpreter's rows, committed: their count and the SHA-256
# of their canonical JSON (``json.dumps(canonical_rows(rows))``), as
# ``trino_tpu.testing.LocalQueryRunner().execute(CASES[name][0])[0]`` gives
# them
COMMITTED = {
    "window": (15000, "61dfc750806ad381b831c8b6eb9cd879627f1c35194dd0c356bb799264a32716"),
    "window-string-min": (
        100, "c4335084a2e56e7b082a22c67913eba035a7d8957ba85d22f760cc370fbdbfe2"),
}


def _digest(rows) -> tuple[int, str]:
    text = json.dumps(canonical_rows(rows))
    return len(rows), hashlib.sha256(text.encode()).hexdigest()


def _run(port, sql, props):
    session = Session()
    for k, v in props.items():
        session.set(k, v)
    return port.engine.execute_statement(sql, session)


@pytest.mark.parametrize("name", sorted(CASES))
def test_spilled_rows_equal_unspilled_and_reference(ref, port, name):
    sql, threshold, parts, kinds, ordered = CASES[name]
    base = _run(port, sql, {})
    spilled = _run(port, sql, {"spill_threshold_rows": threshold, "spill_partitions": parts})
    assert base.spill_stats is None
    assert set(spilled.spill_stats["operators"]) == kinds
    assert spilled.spill_stats["partitions"] >= parts
    if name in COMMITTED:
        assert spilled.rows == base.rows
        assert _digest(spilled.rows) == COMMITTED[name]
        return
    want = ref.execute(sql)[0]
    if not ordered:
        want, base.rows, spilled.rows = (
            sorted(r, key=repr) for r in (want, base.rows, spilled.rows)
        )
    assert spilled.rows == base.rows == want
    if name == "aggregate":
        assert len(want) > 10_000


def test_spill_disabled_by_session(port):
    res = _run(port, (
        "select count(*) from tpch.tiny.orders o "
        "join tpch.tiny.customer c on o.o_custkey = c.c_custkey"
    ), {"spill_enabled": False, "spill_threshold_rows": 10})
    assert res.rows == [(15000,)] and res.spill_stats is None


def test_semi_and_full_joins_never_spill(ref, port):
    """The reference spills neither a semi join (the interpreter's EXISTS
    and IN) nor a FULL join, whose unmatched build rows a partition
    without probe rows would drop."""
    for sql in (
        "select count(*) from tpch.tiny.orders where o_orderkey in "
        "(select l_orderkey from tpch.tiny.lineitem where l_quantity > 49)",
        "select count(*), count(c_custkey), count(o_orderkey) from tpch.tiny.customer "
        "full join tpch.tiny.orders on c_custkey = o_custkey",
    ):
        res = _run(port, sql, {"spill_threshold_rows": 100})
        assert "join" not in (res.spill_stats or {}).get("operators", {})
        assert res.rows == ref.execute(sql)[0]


def test_spill_partitions_by_the_reference_hash():
    from trino_tpu.spill import partition_assignment as ref_assignment
    from trino_tpu_torch.ops import join as J
    from trino_tpu_torch.spill import partition_assignment

    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(-(2**62), 2**62, 4096))
    sel = rng.random(4096) < 0.7
    h = J.hash_keys([(keys, torch.ones(4096, dtype=torch.bool))])[0].numpy()
    got = partition_assignment(h, sel, 8)
    assert np.array_equal(got, ref_assignment(h.view(np.uint64), sel, 8))
    assert set(np.unique(got)) == {-1, *range(8)}
