"""TPC-DS through trino_tpu_torch's tpcds connector against the JAX
reference, on the CPU.

- The port's corpus (``benchmarks/tpcds.py``) is the reference's: the 64
  queries of ``tests/test_tpcds_suite.py`` and ``tests/test_tpcds_oracle.py``,
  Q64 and Q95 as in ``trino_tpu/benchmarks/tpcds.py``.
- The port's generator (``connectors/tpcds.py``, a copy of the
  reference's) gives the reference connector's columns of all 24 tables,
  split by split, dictionaries included, and its statistics.
- The optimized plans of all 64 queries equal the reference's, symbol
  counters aside.
- Live against the reference on the same tables (its ``LocalQueryRunner``,
  execution_mode=local): Q33 (UNION ALL) and Q38 (INTERSECT) here, Q98 (a
  window), Q87 (EXCEPT) and Q97 (FULL OUTER) in
  ``test_torch_tpcds_live.py`` (two files, so that two test processes
  share the reference's compilation), give equal rows and column types
  through the port in both execution modes. The other queries are held
  against the reference's committed rows in ``test_torch_tpcds_q*.py``.
- The committed answers (``tpcds_tiny_answers.json``, which those files
  hold the port against, and ``tpcds_sf1_answers.json``, which
  ``chip_smoke.py`` holds the card against) equal the reference's rows
  computed anew (marked ``slow``: about 30 minutes).
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from trino_tpu.benchmarks.tpcds import queries as ref_bench_queries
from trino_tpu.connectors.tpcds import TpcdsConnector as RefTpcds
from trino_tpu.ops import decimal128 as RD
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch.benchmarks import tpch as B
from trino_tpu_torch.benchmarks.tpcds import ANSWERS_SF1, ANSWERS_TINY, queries
from trino_tpu_torch.connectors.tpcds import _SCHEMAS, TpcdsConnector
from trino_tpu_torch.ops import decimal128 as D
from trino_tpu_torch.testing import LocalQueryRunner

# one intra-op thread: test processes run side by side (pytest-xdist), and
# torch's CPU thread pools then oversubscribe the cores, which slows the
# port's many small tensor ops ten- to a hundredfold
torch.set_num_threads(1)

LIVE = (33, 38)  # the set operations; Q98, Q87, Q97: test_torch_tpcds_live.py


def _normalised(plan_text: str) -> str:
    """Plan text with the planner's global symbol counters stripped (set
    operations chain them: ``x_12_34``)."""
    return re.sub(r"(?:_\d+)+\b", "_#", plan_text)


def test_corpus_is_the_references():
    from test_tpcds_oracle import QUERIES as ORACLE
    from test_tpcds_suite import QUERIES as SUITE

    corpus = dict(SUITE)
    corpus.update(ORACLE)
    assert queries("tpcds.tiny") == corpus
    ref = ref_bench_queries("tpcds.sf10")
    assert {q: queries("tpcds.sf10")[q] for q in ref} == ref


@pytest.mark.parametrize("table", sorted(_SCHEMAS))
def test_generated_columns_match_reference(table):
    ref, port = RefTpcds(split_rows=1 << 12), TpcdsConnector(split_rows=1 << 12)
    cols = [c for c, _ in _SCHEMAS[table]]
    splits = port.get_splits("tiny", table, 3)
    assert [(s.index, s.total) for s in splits] == [
        (s.index, s.total) for s in ref.get_splits("tiny", table, 3)
    ]
    assert port.estimate_rows("tiny", table) == ref.estimate_rows("tiny", table)
    got_stats, exp_stats = port.table_stats("tiny", table), ref.table_stats("tiny", table)
    assert got_stats.row_count == exp_stats.row_count
    assert {k: tuple(vars(v).values()) for k, v in got_stats.columns.items()} == {
        k: tuple(vars(v).values()) for k, v in exp_stats.columns.items()
    }
    for split in splits:
        assert port.split_stats("tiny", table, split) == ref.split_stats("tiny", table, split)
        got = port.read_split("tiny", table, cols, split)
        exp = ref.read_split("tiny", table, cols, split)
        assert got.num_rows == exp.num_rows > 0
        for name, g, e in zip(cols, got.columns, exp.columns):
            assert g.type.name == e.type.name, name
            np.testing.assert_array_equal(
                g.data.numpy(), np.asarray(e.data).astype(g.data.numpy().dtype), name
            )
            assert (g.valid is None) == (e.valid is None), name
            if e.dictionary is not None:
                assert g.dictionary.values == list(e.dictionary.values), name


def test_split_cache_serves_every_column_subset():
    """A generated split is cached with all its columns: another column
    subset of it is served without generating, and the least recently
    read split goes first when the limit is reached."""
    one = TpcdsConnector(split_rows=1 << 12)
    s0, s1, *_ = one.get_splits("tiny", "store_sales", 8)
    first = one.read_split("tiny", "store_sales", ["ss_item_sk"], s0)
    split_bytes = one._batch_cache_bytes
    other = one.read_split("tiny", "store_sales", ["ss_sold_date_sk", "ss_item_sk"], s0)
    assert one._batch_cache_bytes == split_bytes and len(one._batch_cache) == 1
    assert other.columns[1] is first.columns[0]
    small = TpcdsConnector(split_rows=1 << 12, cache_bytes=split_bytes)
    small.read_split("tiny", "store_sales", ["ss_item_sk"], s0)
    small.read_split("tiny", "store_sales", ["ss_item_sk"], s1)
    assert list(small._batch_cache) == [("tiny", "store_sales", s1.index, s1.total)]


@pytest.fixture(scope="module")
def runners():
    ref = RefRunner()
    ref.session.set("execution_mode", "local")
    return ref, LocalQueryRunner(device="cpu")


@pytest.mark.parametrize("q", sorted(queries()))
def test_tpcds_plan_matches_reference(runners, q):
    ref, port = runners
    sql = queries("tpcds.tiny")[q]
    assert _normalised(port.explain(sql)) == _normalised(ref.explain(sql))


@pytest.mark.parametrize("q", LIVE)
def test_live_rows_match_reference(runners, q):
    """The window, set-operation and FULL OUTER queries against the
    reference's interpreter run on the same generated tables."""
    ref, port = runners
    sql = queries("tpcds.tiny")[q]
    want = ref.engine.execute_statement(sql, ref.session)
    positions = B.order_positions(port.plan(sql))
    for mode in ("local", "distributed"):
        port.session.set("execution_mode", mode)
        try:
            got = port.engine.execute_statement(sql, port.session)
        finally:
            port.session.set("execution_mode", "local")
        assert [t.name for t in got.column_types] == [t.name for t in want.column_types]
        bad = B.first_mismatch(
            B.canonical_rows(got.rows), B.canonical_rows(want.rows), positions
        )
        assert bad is None, f"Q{q} ({mode}): {bad}"


def test_narrow_wide_division_matches_reference():
    """DECIMAL(38) quotients whose scaled dividends and divisors fit 63
    bits (Q2's weekly ratios) take one int64 division in the port; they
    equal the reference's bit loop, rounding and division by zero
    included."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n = 4096
    a = rng.integers(-10**12, 10**12, n)
    b = rng.integers(-10**6, 10**6, n)
    b[::13] = 0
    for shift in (0, 2, 6):
        ahi, alo = a >> 63, a
        bhi, blo = b >> 63, b
        port = D.div128_round(*(torch.from_numpy(x) for x in (ahi, alo, bhi, blo)), shift)
        ref = RD.div128_round(*(jnp.asarray(x) for x in (ahi, alo, bhi, blo)), shift)
        for p, r in zip(port, ref):
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def _answers_script():
    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "tpcds_answers.py")
    spec = importlib.util.spec_from_file_location("tpcds_answers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
@pytest.mark.parametrize("scale,path", [("tiny", ANSWERS_TINY), ("sf1", ANSWERS_SF1)])
def test_committed_answers_equal_the_reference(scale, path):
    """The committed answers are the reference's rows computed anew
    (``scripts/tpcds_answers.py``)."""
    assert _answers_script().compute(scale) == B.load_answers(path)
