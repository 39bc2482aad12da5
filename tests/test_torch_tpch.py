"""TPC-H through trino_tpu_torch's tpch connector against the JAX
reference, on the CPU.

- The port's generator (``connectors/dbgen.py``, a copy of the
  reference's) gives the reference connector's lineitem and orders
  columns split by split, dictionaries included; comment columns raise
  until the native loader builds their text pool.
- TPC-H Q1 and Q6 (spec text, ``tpch.tiny``) return exactly the
  reference's rows and column types, through the port's local executor
  and through its distributed executor, whose lineitem fragment streams
  through the sort-based step (``stream_device_chunk_rows`` 2^16 in both
  engines: one chunk of live rows). The reference rows come from its
  distributed run; both of its modes give the same rows.
- Their optimized plans equal the reference's, symbol counters aside.
- A narrow-DECIMAL GROUP BY over ``tpch.tiny`` (a slab of exactly 2^22
  rows) takes the dense path once with exact 128-bit (``pair128``) sums.
"""

import re
from decimal import Decimal

import numpy as np
import pytest

from trino_tpu.benchmarks.tpch import queries as ref_queries
from trino_tpu.connectors.tpch import TpchConnector as RefTpch
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import _kernels
from trino_tpu_torch.benchmarks.tpch import queries
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.ops import dense_groupby as DG
from trino_tpu_torch.testing import LocalQueryRunner

PROPS = {
    "execution_mode": "distributed",
    "stream_scan_threshold_rows": 1 << 14,
    "stream_device_chunk_rows": 1 << 16,
}
Q_D = ("select l_returnflag, l_linestatus, sum(l_quantity), "
       "sum(l_extendedprice), count(*) from tpch.tiny.lineitem group by 1, 2")


def _normalised(plan_text: str) -> str:
    """Plan text with the planner's global symbol counters stripped."""
    return re.sub(r"_\d+\b", "_#", plan_text)


@pytest.fixture(scope="module")
def runners():
    ref = RefRunner()
    port = LocalQueryRunner(device="cpu")
    for r in (ref, port):
        for k, v in PROPS.items():
            r.session.set(k, v)
    return ref, port


@pytest.fixture(scope="module")
def want(runners):
    """The reference's rows and column types of Q1 and Q6, once."""
    ref, _ = runners
    out = {}
    for q in (1, 6):
        res = ref.engine.execute_statement(ref_queries("tpch.tiny")[q], ref.session)
        out[q] = (res.rows, [t.name for t in res.column_types])
    return out


def test_query_texts_match_reference():
    assert queries("tpch.sf10") == ref_queries("tpch.sf10")


NON_COMMENT = {
    "lineitem": [
        "l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
        "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
        "l_linestatus", "l_shipdate", "l_commitdate", "l_receiptdate",
        "l_shipinstruct", "l_shipmode",
    ],
    "orders": [
        "o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
        "o_orderdate", "o_orderpriority", "o_clerk", "o_shippriority",
    ],
}


@pytest.mark.parametrize("table", ["lineitem", "orders"])
def test_generated_columns_match_reference(table):
    ref, port = RefTpch(split_rows=1 << 12), TpchConnector(split_rows=1 << 12)
    cols = NON_COMMENT[table]
    splits = port.get_splits("tiny", table, 4)
    assert len(splits) == 4
    assert [(s.table, s.index, s.total) for s in splits] == [
        (s.table, s.index, s.total) for s in ref.get_splits("tiny", table, 4)
    ]
    assert port.estimate_rows("tiny", table) == ref.estimate_rows("tiny", table)
    for split in splits:
        got = port.read_split("tiny", table, cols, split)
        exp = ref.read_split("tiny", table, cols, split)
        assert got.num_rows == exp.num_rows > 0
        for name, g, e in zip(cols, got.columns, exp.columns):
            assert g.type.name == e.type.name, name
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(e.data), name)
            assert g.valid is None and e.valid is None
            if e.dictionary is not None:
                assert g.dictionary.values == list(e.dictionary.values), name


def test_table_stats_match_reference():
    ref, port = RefTpch(), TpchConnector()
    for table in ("lineitem", "orders", "customer", "nation"):
        got, exp = port.table_stats("tiny", table), ref.table_stats("tiny", table)
        assert got.row_count == exp.row_count
        assert {k: tuple(vars(v).values()) for k, v in got.columns.items()} == {
            k: tuple(vars(v).values()) for k, v in exp.columns.items()
        }


def test_comment_column_waits_for_the_native_loader():
    port = TpchConnector()
    split = port.get_splits("tiny", "lineitem", 1)[0]
    with pytest.raises(NotImplementedError, match="native loader"):
        port.read_split("tiny", "lineitem", ["l_orderkey", "l_comment"], split)


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("q", [1, 6])
def test_tpch_query_matches_reference(runners, want, q, mode):
    _, port = runners
    port.session.set("execution_mode", mode)
    try:
        res = port.engine.execute_statement(queries("tpch.tiny")[q], port.session)
    finally:
        port.session.set("execution_mode", "distributed")
    rows, types = want[q]
    assert res.rows == rows  # ORDER BY (Q1) or one row (Q6): ordered
    assert [t.name for t in res.column_types] == types
    if mode == "distributed":
        assert "streamed" in res.fragment_modes.values()
    else:
        assert res.fragment_modes is None


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_plan_matches_reference(runners, q):
    ref, port = runners
    sql = queries("tpch.tiny")[q]
    assert _normalised(port.explain(sql)) == _normalised(ref.explain(sql))


def test_narrow_decimal_group_by_takes_the_dense_path(runners, monkeypatch):
    """Q-D's query at tpch.tiny: its slab is exactly 2^22 rows, so the
    dense path runs once, with exact 128-bit sums for both DECIMAL sums;
    the rows equal an exact oracle over the reference connector's data."""
    _, port = runners
    plans = []
    real = DG.dense_groupby_device

    def spy(plan, *args, **kwargs):
        plans.append(plan)
        return real(plan, *args, **kwargs)

    monkeypatch.setattr(DG, "dense_groupby_device", spy)
    before = _kernels.PLAIN_CALLS["dense_groupby"]
    res = port.engine.execute_statement(Q_D, port.session)
    assert _kernels.PLAIN_CALLS["dense_groupby"] - before == 1
    assert len(plans) == 1 and plans[0].pair128 == (True, True)
    ref = RefTpch()
    cols = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice"]
    oracle: dict = {}
    for split in ref.get_splits("tiny", "lineitem", 1):
        b = ref.read_split("tiny", "lineitem", cols, split)
        rf, ls, qty, price = (np.asarray(c.data) for c in b.columns)
        for i in range(b.num_rows):
            key = (b.columns[0].dictionary.values[rf[i]],
                   b.columns[1].dictionary.values[ls[i]])
            acc = oracle.setdefault(key, [0, 0, 0])
            acc[0] += int(qty[i])
            acc[1] += int(price[i])
            acc[2] += 1
    expect = sorted(
        (f, s, Decimal(a) / 100, Decimal(b) / 100, c)
        for (f, s), (a, b, c) in oracle.items()
    )
    assert sorted(res.rows) == expect
