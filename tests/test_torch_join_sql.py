"""SQL equi-joins through trino_tpu_torch against the JAX reference, on the CPU.

TPC-H-shaped customer, orders and lineitem tables (``chip_smoke.tpch_tables``
at scale factor 0.002) load into both engines' memory connectors. Q-J1
(TPC-H Q3), Q-J2 (a LEFT join leaving about half the probe rows
unmatched) and Q-J3 (TPC-H Q4, an EXISTS semi join) run through the port
in both execution modes and under every ``join_strategy``; the rows must
equal the reference's ``LocalQueryRunner`` rows (local mode) exactly. All
results are integers: the tolerance is zero.

In distributed mode the INNER and LEFT joins build their dense table
through the K2 wrapper, which on CPU tensors runs its plain version and
counts the run in ``_kernels.PLAIN_CALLS["dense_join_build"]``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import Q_J1, Q_J2, Q_J3, TPCH_COLUMNS, tpch_oracle, tpch_tables
from trino_tpu import types as RT
from trino_tpu.columnar import Batch as RBatch, Column as RColumn
from trino_tpu.connectors.api import (
    ColumnSchema as RColumnSchema,
    TableSchema as RTableSchema,
)
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import _kernels
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, batch_from_numpy
from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
from trino_tpu_torch.testing import LocalQueryRunner

QUERIES = {"Q-J1": Q_J1, "Q-J2": Q_J2, "Q-J3": Q_J3}


def load(ref_mem, port_mem, name, cols) -> None:
    """The same numpy columns into both engines' memory catalogs (all
    BIGINT)."""
    names = list(cols)
    n = len(cols[names[0]])
    ref_mem.create_table(
        "default", name,
        RTableSchema(name, tuple(RColumnSchema(c, RT.BIGINT) for c in names)),
    )
    ref_mem.insert(
        "default", name, RBatch([RColumn(RT.BIGINT, cols[c]) for c in names], n)
    )
    port_mem.create_table(
        "default", name,
        TableSchema(name, tuple(ColumnSchema(c, T.BIGINT) for c in names)),
    )
    port_mem.insert(
        "default", name,
        batch_from_numpy([T.BIGINT] * len(names), [cols[c] for c in names]),
    )


@pytest.fixture(scope="module")
def engines():
    ref = RefRunner()
    port = LocalQueryRunner(device="cpu")
    tables = tpch_tables(0.002, seed=7)
    for name, cols in tables.items():
        assert tuple(cols) == TPCH_COLUMNS[name]
        load(ref.catalogs.get("memory"), port.catalogs.get("memory"), name, cols)
    # a build key repeated past the dense table's 16-slot probe window
    rng = np.random.default_rng(3)
    load(
        ref.catalogs.get("memory"), port.catalogs.get("memory"), "dup",
        {"d_key": np.r_[np.full(40, 12345), rng.integers(0, 500, 60)],
         "d_val": rng.integers(0, 100, 100)},
    )
    load(
        ref.catalogs.get("memory"), port.catalogs.get("memory"), "probe",
        {"p_key": np.r_[np.full(5, 12345), rng.integers(0, 500, 200)]},
    )
    want = {}
    return ref, port, want


def reference_rows(engines, key, sql):
    ref, _, want = engines
    if key not in want:
        want[key] = ref.execute(sql)[0]
    return want[key]


def run_port(port, sql, mode, strategy="auto"):
    port.session.set("execution_mode", mode)
    port.session.set("join_strategy", strategy)
    # auto runs as the reference's test runs it: without a history entry,
    # which would promote a seeded site to matmul
    port.session.set("query_history", strategy != "auto")
    before = _kernels.PLAIN_CALLS["dense_join_build"]
    res = port.engine.execute_statement(sql, port.session)
    return res, _kernels.PLAIN_CALLS["dense_join_build"] - before


@pytest.mark.parametrize(
    "mode,strategy",
    [("local", "auto"), ("distributed", "sort"), ("distributed", "dense"),
     ("distributed", "matmul"), ("distributed", "auto")],
)
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_join_queries_match_reference(engines, query, mode, strategy):
    _, port, _ = engines
    want = reference_rows(engines, query, QUERIES[query])
    res, dense_builds = run_port(port, QUERIES[query], mode, strategy)
    if query == "Q-J1":  # ORDER BY ... LIMIT 10: ordered, with no ties at 10
        assert res.rows == want and len(want) == 10
    else:
        assert sorted(res.rows) == sorted(want) and len(want) > 0
    table_joins = query != "Q-J3"  # Q-J3's semi join probes the sort tier
    if mode == "local":
        assert res.exchange_stats is None and dense_builds == 0
        return
    strategies = set(res.exchange_stats["joinStrategy"].values())
    if strategy in ("dense", "matmul", "auto") and table_joins:
        # auto resolves to dense with no history entry (query_history off)
        assert strategies == {"dense" if strategy == "auto" else strategy}
        assert dense_builds >= 1
        assert res.exchange_stats["overflow_retries"] == 0
    else:
        assert dense_builds == 0


def test_numpy_oracle_matches_reference(engines):
    """The oracle that holds the port's rows on the card gives the
    reference's rows on the same tables."""
    want = tpch_oracle(tpch_tables(0.002, seed=7))
    for name, sql in QUERIES.items():
        got = reference_rows(engines, name, sql)
        assert (got if name == "Q-J1" else sorted(got)) == want[name]


def test_right_join_is_the_flipped_left_join(engines):
    sql = ("select o_orderkey, count(l_orderkey) from (select l_orderkey from "
           "memory.default.lineitem where l_quantity > 45) l right join "
           "memory.default.orders on l_orderkey = o_orderkey group by o_orderkey")
    ref, port, _ = engines
    want = ref.execute(sql)[0]
    for mode in ("local", "distributed"):
        res, _ = run_port(port, sql, mode)
        assert sorted(res.rows) == sorted(want)


def test_anti_join_and_in_semi_join_match_reference(engines):
    ref, port, _ = engines
    for sql in (
        "select count(*) from memory.default.orders where not exists (select * "
        "from memory.default.lineitem where l_orderkey = o_orderkey and l_quantity > 48)",
        "select count(*) from memory.default.customer where c_custkey in (select "
        "o_custkey from memory.default.orders where o_orderpriority = 2)",
    ):
        want = ref.execute(sql)[0]
        for mode in ("local", "distributed"):
            res, _ = run_port(port, sql, mode)
            assert res.rows == want


def test_duplicate_chain_demotes_to_sort(engines):
    """40 copies of one build key can never fit the 16-slot probe window:
    the dense site overflows, grows twice and is demoted to the sort tier,
    and the rows still equal the reference's."""
    sql = ("select p_key, count(*), sum(d_val) from memory.default.probe "
           "join memory.default.dup on p_key = d_key group by p_key")
    ref, port, _ = engines
    want = ref.execute(sql)[0]
    res, dense_builds = run_port(port, sql, "distributed", "dense")
    assert sorted(res.rows) == sorted(want)
    assert list(res.exchange_stats["joinStrategy"].values()) == ["sort"]
    assert res.exchange_stats["overflow_retries"] == 2
    assert dense_builds == 2


def test_scan_without_columns_keeps_its_device():
    """A batch with no columns and no selection (a scan that reads no
    column) reports the device it was moved to, not the CPU."""
    meta = torch.device("meta")
    b = Batch([], 5).to(meta)
    assert b.device == meta
    assert b.selection_mask().device == meta
    assert Batch([Column(T.BIGINT, torch.zeros(3, dtype=torch.int64))], 3).to(
        meta
    ).device == meta


SCALAR_SUBQUERIES = {
    # a correlated scalar subquery over an aggregate: a LEFT single-row join
    "correlated": (
        "select p_key, (select max(d_val) from memory.default.dup "
        "where d_key = p_key) from memory.default.probe"
    ),
    # an uncorrelated one: a single-row CROSS join
    "uncorrelated": (
        "select count(*) from memory.default.lineitem where l_quantity > "
        "(select avg(l_quantity) from memory.default.lineitem)"
    ),
    # an uncorrelated one over no rows is NULL
    "empty": (
        "select o_orderkey, (select c_custkey from memory.default.customer "
        "where c_custkey < 0) from memory.default.orders where o_orderkey < 40"
    ),
}
SCALAR_ERRORS = {
    # 40 build rows share the key 12345 that five probe rows carry
    "correlated": (
        "select p_key, (select d_val from memory.default.dup where d_key = p_key) "
        "from memory.default.probe"
    ),
    "uncorrelated": (
        "select o_orderkey, (select c_custkey from memory.default.customer) "
        "from memory.default.orders"
    ),
}
OTHER_JOINS = {
    "cross": (
        "select count(*), sum(c_custkey * o_orderkey) from (select c_custkey from "
        "memory.default.customer where c_custkey < 30) c cross join (select "
        "o_orderkey from memory.default.orders where o_orderkey < 200) o"
    ),
    # the ON filter drops matches, never probe rows
    "left-filter": (
        "select c_custkey, count(o_orderkey) from memory.default.customer left "
        "join memory.default.orders on c_custkey = o_custkey and o_orderdate < 9000 "
        "group by c_custkey"
    ),
    "left-filter-both-sides": (
        "select c_custkey, count(o_orderkey), sum(o_orderkey) from "
        "memory.default.customer left join memory.default.orders on "
        "c_custkey = o_custkey and o_orderdate < 8100 + c_custkey group by c_custkey"
    ),
    # DECIMAL(38) keys at two scales: (hi, lo) lanes, scales aligned
    "decimal38-keys": (
        "select count(*), sum(o_orderkey) from (select o_orderkey, "
        "cast(o_custkey as decimal(38,2)) k from memory.default.orders) o join "
        "(select cast(c_custkey as decimal(38,0)) k2 from memory.default.customer "
        "where c_mktsegment = 1) c on o.k = c.k2"
    ),
}


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("case", sorted(SCALAR_SUBQUERIES) + sorted(OTHER_JOINS))
def test_scalar_cross_left_filter_and_wide_key_joins_match_reference(
    engines, case, mode
):
    sql = {**SCALAR_SUBQUERIES, **OTHER_JOINS}[case]
    want = reference_rows(engines, case, sql)
    res, _ = run_port(engines[1], sql, mode)
    assert sorted(res.rows, key=repr) == sorted(want, key=repr) and len(want) > 0


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("case", sorted(SCALAR_ERRORS))
def test_scalar_subquery_of_many_rows_raises_as_the_reference(engines, case, mode):
    ref, port, _ = engines
    sql = SCALAR_ERRORS[case]
    with pytest.raises(Exception, match="multiple rows") as ref_err:
        ref.execute(sql)
    port.session.set("execution_mode", mode)
    with pytest.raises(Exception, match="multiple rows") as err:
        port.engine.execute_statement(sql, port.session)
    assert str(err.value) == str(ref_err.value)
