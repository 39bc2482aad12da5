"""TPC-H through trino_tpu_torch's tpch connector against the JAX
reference, on the CPU.

- The port's generator (``connectors/dbgen.py``, a copy of the
  reference's) gives the reference connector's columns of all eight
  tables split by split, dictionaries included; the comment columns too,
  sliced from the text pool that the port's native loader builds.
- The 22 TPC-H queries (spec text, ``tpch.tiny``) return exactly the
  reference's rows and column types, through the port's local executor
  and through its distributed executor, whose lineitem fragments stream
  through the sort-based step (``stream_device_chunk_rows`` 2^16 in both
  engines: one chunk of live rows). Rows are compared in ORDER BY order,
  rows whose ORDER BY keys tie as a multiset. The reference rows are its
  answers at ``tpch.tiny`` committed in ``tpch_tiny_answers.json``
  (``scripts/tpch_sf1_answers.py --schema tpch.tiny``; the ``slow`` test
  below recomputes them); Q1-Q11 run here and Q12-Q22 in
  ``test_torch_tpch22.py``.
- Their optimized plans equal the reference's, symbol counters aside.
- The committed SF1 answers (``tpch_sf1_answers.json``, which
  ``chip_smoke.py`` holds the card's rows against) equal the reference's
  rows computed anew (marked ``slow``: about 15 minutes).
- A narrow-DECIMAL GROUP BY over ``tpch.tiny`` (a slab of exactly 2^22
  rows) takes the dense path once with exact 128-bit (``pair128``) sums.
"""

import importlib.util
import json
import os
import re
from decimal import Decimal

import numpy as np
import pytest
import torch

from trino_tpu.benchmarks.tpch import queries as ref_queries
from trino_tpu.connectors.tpch import TpchConnector as RefTpch
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import _kernels
from trino_tpu_torch.benchmarks import tpch as B
from trino_tpu_torch.benchmarks.tpch import queries
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.ops import dense_groupby as DG
from trino_tpu_torch.testing import LocalQueryRunner

# one torch thread a test process: xdist workers' pools oversubscribe
torch.set_num_threads(1)

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


QUERIES_HERE = range(1, 12)  # Q12-Q22: test_torch_tpch22.py


ANSWERS_TINY = B.ANSWERS_SF1.replace("tpch_sf1_answers", "tpch_tiny_answers")


def reference_rows(runners, qs) -> dict:
    """The reference's rows (canonical text) and column types of queries
    ``qs`` at ``tpch.tiny``, as committed."""
    answers = B.load_answers(ANSWERS_TINY)["queries"]
    return {q: (answers[str(q)]["rows"], answers[str(q)]["types"]) for q in qs}


@pytest.fixture(scope="module")
def want(runners):
    return reference_rows(runners, QUERIES_HERE)


def check_query(runners, want, q, mode) -> None:
    """Query ``q`` through the port in ``mode`` gives the reference's rows
    and column types."""
    _, port = runners
    sql = queries("tpch.tiny")[q]
    port.session.set("execution_mode", mode)
    try:
        res = port.engine.execute_statement(sql, port.session)
    finally:
        port.session.set("execution_mode", "distributed")
    rows, types = want[q]
    assert [t.name for t in res.column_types] == types
    bad = B.first_mismatch(
        B.canonical_rows(res.rows), rows, B.order_positions(port.plan(sql)),
    )
    assert bad is None, f"Q{q}: {bad}"
    if mode == "local":
        assert res.fragment_modes is None
    elif q in (1, 6):  # a lineitem scan->aggregate fragment streams
        assert "streamed" in res.fragment_modes.values()


def test_query_texts_match_reference():
    assert queries("tpch.sf10") == ref_queries("tpch.sf10")


NON_COMMENT = {
    "region": ["r_regionkey", "r_name"],
    "nation": ["n_nationkey", "n_name", "n_regionkey"],
    "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone",
                 "s_acctbal"],
    "customer": ["c_custkey", "c_name", "c_address", "c_nationkey", "c_phone",
                 "c_acctbal", "c_mktsegment"],
    "part": ["p_partkey", "p_name", "p_mfgr", "p_brand", "p_type", "p_size",
             "p_container", "p_retailprice"],
    "partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost"],
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
COMMENT = {t: [f"{t[0] if t != 'partsupp' else 'ps'}_comment"] for t in NON_COMMENT}
# splits of each tiny table at 4096 rows a split and 4 wanted: the
# split-by-split comparison covers several splits where the table has them
SPLITS = {"lineitem": 4, "orders": 4, "partsupp": 2}


def _same_split_columns(table, cols):
    """The port's columns of ``table`` equal the reference connector's,
    split by split, dictionaries included."""
    ref, port = RefTpch(split_rows=1 << 12), TpchConnector(split_rows=1 << 12)
    splits = port.get_splits("tiny", table, 4)
    assert len(splits) == SPLITS.get(table, 1)
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


@pytest.mark.parametrize("table", sorted(NON_COMMENT))
def test_generated_columns_match_reference(table):
    _same_split_columns(table, NON_COMMENT[table])


def test_table_stats_match_reference():
    ref, port = RefTpch(), TpchConnector()
    for table in ("lineitem", "orders", "customer", "nation"):
        got, exp = port.table_stats("tiny", table), ref.table_stats("tiny", table)
        assert got.row_count == exp.row_count
        assert {k: tuple(vars(v).values()) for k, v in got.columns.items()} == {
            k: tuple(vars(v).values()) for k, v in exp.columns.items()
        }


def test_split_cache_evicts_least_recently_read():
    """The host cache of generated splits keeps what was read last: at a
    limit of two splits, reading a third evicts the one read longest ago,
    and a split larger than the whole limit is not cached."""
    one = TpchConnector(split_rows=1 << 12)
    split_bytes = sum(
        c.data.numel() * c.data.element_size()
        for c in one.read_split("tiny", "orders", ["o_orderkey"],
                                one.get_splits("tiny", "orders", 4)[0]).columns
    )
    port = TpchConnector(split_rows=1 << 12, cache_bytes=2 * split_bytes)
    s0, s1, s2, _ = port.get_splits("tiny", "orders", 4)

    def read(split, cols=("o_orderkey",)):
        return port.read_split("tiny", "orders", list(cols), split)

    b0, b1 = read(s0), read(s1)
    assert read(s0) is b0  # a hit, now the most recent
    b2 = read(s2)  # evicts s1
    assert read(s0) is b0 and read(s2) is b2
    assert read(s1) is not b1
    wide = read(s0, ("o_orderkey", "o_custkey", "o_orderdate"))
    assert read(s0, ("o_orderkey", "o_custkey", "o_orderdate")) is not wide
    assert port._batch_cache_bytes <= 2 * split_bytes


@pytest.mark.parametrize("table", sorted(COMMENT))
def test_comment_column_matches_reference(table):
    """Comment columns slice the text pool the port's native loader
    builds: values and dictionaries equal the reference connector's."""
    _same_split_columns(table, COMMENT[table])


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("q", QUERIES_HERE)
def test_tpch_query_matches_reference(runners, want, q, mode):
    check_query(runners, want, q, mode)


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_plan_matches_reference(runners, q):
    ref, port = runners
    sql = queries("tpch.tiny")[q]
    assert _normalised(port.explain(sql)) == _normalised(ref.explain(sql))


@pytest.mark.slow
def test_sf1_answers_equal_the_reference():
    """``tpch_sf1_answers.json`` equals the reference's SF1 rows computed
    anew by ``scripts/tpch_sf1_answers.py`` (about 15 minutes on 8 CPU
    cores, so out of tier-1)."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "scripts", "tpch_sf1_answers.py")
    spec = importlib.util.spec_from_file_location("tpch_sf1_answers", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    fresh = json.loads(json.dumps(script.compute("tpch.sf1")))
    assert fresh == B.load_answers()


@pytest.mark.slow
def test_tiny_answers_equal_the_reference():
    """``tpch_tiny_answers.json`` equals the reference's rows at
    ``tpch.tiny`` computed anew (about 2 minutes)."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "scripts", "tpch_sf1_answers.py")
    spec = importlib.util.spec_from_file_location("tpch_sf1_answers", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    fresh = json.loads(json.dumps(script.compute("tpch.tiny")))
    assert fresh == B.load_answers(ANSWERS_TINY)


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
