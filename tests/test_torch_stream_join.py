"""Joins streamed on the probe spine in trino_tpu_torch against the JAX
reference, on the CPU.

The cases of ``tests/test_streaming.py::TestStreamingJoins``: over
``tpch.tiny`` with ``stream_scan_threshold_rows`` at 1000 and chunks of
2^14 rows, a fragment whose probe spine scans ``lineitem`` through joins
into an aggregate streams in the port (``exec/streaming.py``): its build
sides materialize once, each join builds its table once, and the four
probe chunks flow through join→aggregate. Rows must equal the reference
interpreter's (``LocalQueryRunner``, ``execution_mode=local``) exactly,
and the port must report the join stream (``exchange_stats
["join_streams"]``). The reference's rows of the Q3, Q10 and Q5 shapes
and of the build-side string key are committed below (the reference
compiles each of them for 4-9 s on a CPU); the other cases compute
theirs live, at least one for each kind of join. SEMI and ANTI joins on
the spine (which the fragmenter never plans: it gathers both sides of
them) stream as an aggregate fragment cut from the interpreter's plan.
Further: the host chunk source, TPC-DS inventory streams, a join
capacity that overflows on a later chunk (grown, rerun, the same rows, no
retry on the repeat), and one table build per join site whatever the
chunk count.
"""

import pytest
import torch

from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import _kernels
from trino_tpu_torch.benchmarks.tpch import canonical_rows
from trino_tpu_torch.exec.streaming import streamable_chain
from trino_tpu_torch.planner.fragmenter import fragment_plan
from trino_tpu_torch.testing import LocalQueryRunner

torch.set_num_threads(1)

PROPS = {
    "execution_mode": "distributed",
    "stream_scan_threshold_rows": 1000,
    "stream_device_chunk_rows": 1 << 14,
    "stream_chunk_rows": 1 << 14,
}

CASES = {
    "q3": """select l_orderkey, sum(l_extendedprice * (1 - l_discount)),
                    o_orderdate, o_shippriority
             from customer, orders, lineitem
             where c_mktsegment = 'BUILDING'
               and c_custkey = o_custkey and l_orderkey = o_orderkey
               and o_orderdate < date '1995-03-15'
               and l_shipdate > date '1995-03-15'
             group by l_orderkey, o_orderdate, o_shippriority
             order by 2 desc, o_orderdate, l_orderkey limit 10""",
    "q10": """select c_custkey, c_name,
                     sum(l_extendedprice * (1 - l_discount)) as revenue
              from customer, orders, lineitem, nation
              where c_custkey = o_custkey and l_orderkey = o_orderkey
                and o_orderdate >= date '1993-10-01'
                and o_orderdate < date '1994-01-01'
                and l_returnflag = 'R' and c_nationkey = n_nationkey
              group by c_custkey, c_name
              order by revenue desc, c_custkey limit 20""",
    "q5": """select n_name, sum(l_extendedprice * (1 - l_discount))
             from customer, orders, lineitem, supplier, nation, region
             where c_custkey = o_custkey and l_orderkey = o_orderkey
               and l_suppkey = s_suppkey and c_nationkey = s_nationkey
               and s_nationkey = n_nationkey and n_regionkey = r_regionkey
               and r_name = 'ASIA'
               and o_orderdate >= date '1994-01-01'
               and o_orderdate < date '1995-01-01'
             group by n_name order by 2 desc""",
    "left": """select l_linenumber, count(*), count(o_orderkey), sum(l_quantity)
               from lineitem left join
                 (select o_orderkey from orders where o_orderdate < date '1994-01-01') o
                 on l_orderkey = o_orderkey
               group by l_linenumber order by l_linenumber""",
    "build-string-key": """select n_name, count(*), sum(l_quantity)
                           from lineitem, supplier, nation
                           where l_suppkey = s_suppkey and s_nationkey = n_nationkey
                           group by n_name order by n_name""",
    # a GROUP BY without aggregates (TPC-DS Q37 and Q82 have this shape)
    "keys-only": """select l_returnflag, o_orderpriority
                    from lineitem join orders on l_orderkey = o_orderkey
                    where o_orderdate < date '1993-01-01'
                    group by l_returnflag, o_orderpriority order by 1, 2""",
}
# the reference interpreter's rows of the costliest cases, in canonical
# form (``benchmarks.tpch.canonical_rows``), as
# ``trino_tpu.testing.LocalQueryRunner().execute(CASES[name])[0]`` gives them
COMMITTED = {'build-string-key': [['ALGERIA', 1846, '46352'], ['ARGENTINA', 1772, '45608'],
                      ['BRAZIL', 1235, '32063'], ['CANADA', 1759, '44901'],
                      ['CHINA', 4290, '110124'], ['EGYPT', 3606, '91424'],
                      ['ETHIOPIA', 1734, '43700'], ['FRANCE', 1260, '32719'],
                      ['GERMANY', 3004, '78007'], ['INDIA', 3098, '78674'],
                      ['INDONESIA', 2988, '75812'], ['IRAN', 1175, '29489'],
                      ['IRAQ', 1221, '31585'], ['JAPAN', 2447, '62383'],
                      ['JORDAN', 597, '15018'], ['KENYA', 3560, '90467'],
                      ['MOROCCO', 1227, '30932'], ['MOZAMBIQUE', 4154, '104849'],
                      ['PERU', 2430, '62636'], ['ROMANIA', 2918, '74228'],
                      ['RUSSIA', 2980, '76519'], ['SAUDI ARABIA', 615, '15418'],
                      ['UNITED KINGDOM', 1819, '47006'],
                      ['UNITED STATES', 4799, '123584'], ['VIETNAM', 3641, '92629']],
 'q10': [[679, 'Customer#000000679', '378211.3252'],
         [1201, 'Customer#000001201', '374331.534'],
         [422, 'Customer#000000422', '366451.0126'],
         [334, 'Customer#000000334', '360370.755'],
         [805, 'Customer#000000805', '359448.9036'],
         [932, 'Customer#000000932', '341608.2753'],
         [853, 'Customer#000000853', '341236.6246'],
         [872, 'Customer#000000872', '338328.7808'],
         [737, 'Customer#000000737', '338185.3365'],
         [1118, 'Customer#000001118', '319875.728'],
         [223, 'Customer#000000223', '319564.275'],
         [808, 'Customer#000000808', '314774.6167'],
         [478, 'Customer#000000478', '299651.8026'],
         [1441, 'Customer#000001441', '294705.3935'],
         [1478, 'Customer#000001478', '294431.9178'],
         [211, 'Customer#000000211', '287905.6368'],
         [197, 'Customer#000000197', '283190.4807'],
         [1030, 'Customer#000001030', '282557.3566'],
         [1049, 'Customer#000001049', '281134.1117'],
         [1094, 'Customer#000001094', '274877.444']],
 'q3': [[47714, '267010.5894', '1995-03-11', 0],
        [22276, '266351.5562', '1995-01-29', 0],
        [32965, '263768.3414', '1995-02-25', 0],
        [21956, '254541.1285', '1995-02-02', 0], [1637, '243512.7981', '1995-02-08', 0],
        [10916, '241320.0814', '1995-03-11', 0],
        [30497, '208566.6969', '1995-02-07', 0], [450, '205447.4232', '1995-03-05', 0],
        [47204, '204478.5213', '1995-03-13', 0],
        [9696, '201502.2188', '1995-02-20', 0]],
 'q5': [['VIETNAM', '1000926.6999'], ['CHINA', '740210.757'], ['JAPAN', '660651.2425'],
        ['INDONESIA', '566379.5276'], ['INDIA', '422874.6844']]}
# SEMI and ANTI joins: the fragmenter gathers both sides of these joins
# (as the reference's does), so no SQL plan puts them on a streamed spine;
# their aggregate is streamed as a fragment of its own below
SPINE = {
    "semi": """select l_returnflag, count(*), sum(l_quantity) from lineitem
               where l_orderkey in (select o_orderkey from orders
                                    where o_orderpriority = '1-URGENT')
               group by l_returnflag""",
    "anti": """select l_linestatus, count(*) from lineitem
               where l_orderkey not in (select o_orderkey from orders
                                        where o_orderstatus = 'F')
               group by l_linestatus""",
}
# the join sizes its output from the first chunk's matches, and later
# chunks (lineitem is generated in order key order) match more
OVERFLOW = """select o_orderpriority, count(*), sum(l_quantity)
              from lineitem join orders on l_orderkey = o_orderkey
              where o_orderkey > 40000
              group by o_orderpriority order by o_orderpriority"""


@pytest.fixture(scope="module")
def ref():
    return RefRunner()


class _Rows(dict):
    """The reference's rows by case in canonical form: committed, or
    computed when a test first asks (a test process computes only its own
    cases' rows)."""

    def __init__(self, ref):
        super().__init__(COMMITTED)
        self.ref = ref

    def __missing__(self, name):
        sql = {**CASES, **SPINE, "overflow": OVERFLOW}[name]
        self[name] = canonical_rows(self.ref.execute(sql)[0])
        return self[name]


@pytest.fixture(scope="module")
def want(ref):
    return _Rows(ref)


def port_runner(**props) -> LocalQueryRunner:
    r = LocalQueryRunner(device="cpu")
    for k, v in {**PROPS, **props}.items():
        r.session.set(k, v)
    return r


@pytest.fixture(scope="module")
def port():
    return port_runner()


def run(r, sql):
    return r.engine.execute_statement(sql, r.session)


def spine_joins(r, sql) -> int:
    """Joins on the probe spine of the plan's streamable fragments."""
    total = 0
    todo = [fragment_plan(r.plan(sql), r.session)]
    while todo:
        sub = todo.pop()
        todo += sub.children
        chain = streamable_chain(sub.fragment.root)
        total += len(chain[2]) if chain else 0
    return total


@pytest.mark.parametrize("name", sorted(CASES))
def test_join_stream_equals_reference(port, want, name):
    res = run(port, CASES[name])
    assert canonical_rows(res.rows) == want[name]
    streams = res.exchange_stats["join_streams"]
    assert streams and all(s["chunks"] == 4 for s in streams)
    assert "streamed" in res.fragment_modes.values()


@pytest.mark.parametrize("name", ["q3", "build-string-key", "left"])
def test_host_chunk_source_equals_reference(want, name):
    r = port_runner(stream_device_cache_bytes=0)
    res = run(r, CASES[name])
    assert canonical_rows(res.rows) == want[name]
    assert res.exchange_stats["join_streams"]


@pytest.mark.parametrize("name", sorted(SPINE))
def test_semi_and_anti_joins_on_the_spine(port, want, name):
    """The query's aggregate as a fragment of its own, over the plan the
    interpreter runs: Aggregate→Project→Filter→Join SEMI|ANTI→TableScan,
    streamed in four chunks against the build materialized once."""
    from trino_tpu_torch.exec.fragments import FragmentedExecutor
    from trino_tpu_torch.planner import plan as P
    from trino_tpu_torch.planner.fragmenter import SINGLE, PlanFragment, Partitioning

    plan = port.plan(SPINE[name])
    agg = next(n for n in P.walk_plan(plan) if isinstance(n, P.Aggregate))
    frag = PlanFragment(1, agg, Partitioning(SINGLE))
    kinds = [n.join_type for n in P.walk_plan(agg.source) if isinstance(n, P.Join)]
    assert kinds == [name.upper()] and len(streamable_chain(agg)[2]) == 1
    ex = port.engine._executor(port.session, plan)
    assert isinstance(ex, FragmentedExecutor)
    res = ex._try_streaming(frag, {}, {})
    assert sorted(canonical_rows(res.batch.to_pylist())) == sorted(want[name])
    assert ex.exchange_stats["join_streams"] == [{"fragment": 1, "chunks": 4, "builds": 1}]


def test_chunk_join_overflow_grows_and_reruns(want):
    r = port_runner()
    cold, warm = run(r, OVERFLOW), run(r, OVERFLOW)
    assert canonical_rows(cold.rows) == canonical_rows(warm.rows) == want["overflow"]
    assert cold.exchange_stats["overflow_retries"] >= 1
    assert warm.exchange_stats["overflow_retries"] == 0
    assert warm.exchange_stats["join_streams"][0]["chunks"] == 4


@pytest.mark.parametrize("name", ["q3", "q5", "build-string-key"])
def test_one_table_build_per_join_site(port, name):
    """A warm run (no retry) builds each spine join's table once, over four
    chunks: the dense builds (K2's plain version here) of the streamed
    fragment equal its join sites."""
    sql = CASES[name]
    run(port, sql)
    before = _kernels.PLAIN_CALLS["dense_join_build"]
    res = run(port, sql)
    builds = _kernels.PLAIN_CALLS["dense_join_build"] - before
    streams = res.exchange_stats["join_streams"]
    assert res.exchange_stats["overflow_retries"] == 0
    assert sum(s["builds"] for s in streams) == spine_joins(port, sql) >= 1
    materialized_joins = sum(
        1 for k, v in res.exchange_stats["joinStrategy"].items() if v == "dense"
    ) - sum(s["builds"] for s in streams)
    assert builds == sum(s["builds"] for s in streams) + materialized_joins


@pytest.mark.parametrize("slab_bytes", [4 << 30, 0], ids=["slab", "host-chunks"])
@pytest.mark.parametrize("q", [21, 37, 82])
def test_tpcds_inventory_streams_equal_committed_answers(q, slab_bytes):
    """TPC-DS Q21, Q37 and Q82 at tiny stream inventory through their
    joins: views of the tpcds connector's device slab or, when the slab
    may hold no byte, host chunks; rows equal the reference's committed
    answers."""
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.benchmarks.tpcds import ANSWERS_TINY, queries

    want = B.load_answers(ANSWERS_TINY)["queries"][str(q)]
    r = port_runner(stream_device_cache_bytes=slab_bytes)
    res = run(r, queries("tpcds.tiny")[q])
    bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"], want["order_by"])
    assert bad is None, f"Q{q}: {bad}"
    streams = res.exchange_stats["join_streams"]
    assert streams and streams[0]["chunks"] >= 2


def test_unset_chunk_rows_stream_the_whole_slab(want):
    """With ``stream_device_chunk_rows`` unset (its default) a fragment
    whose working set fits the device's free memory streams its slab in
    one chunk: the step's per-chunk host work is paid once."""
    r = port_runner(stream_device_chunk_rows=None)
    res = run(r, CASES["left"])
    assert canonical_rows(res.rows) == want["left"]
    assert [s["chunks"] for s in res.exchange_stats["join_streams"]] == [1]


@pytest.mark.parametrize("free_rows, chunk", [
    (3_000_000, 3_000_000),    # the live rows fit: one chunk of them
    ((1 << 20) + 5, 1 << 20),  # the largest power of two that fits
    (10, 1 << 16),             # never below 2^16 rows
])
def test_chunk_rows_follow_the_free_memory(monkeypatch, free_rows, chunk):
    """A slab of 3,000,000 live rows of one BIGINT column, padded to 2^22
    (9 bytes a row staged, 72 estimated in the working set), in half the
    free memory."""
    from types import SimpleNamespace

    from trino_tpu_torch import memory
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch, Column
    from trino_tpu_torch.exec.streaming import StreamingAggregator

    slab = Batch([Column(T.BIGINT, torch.zeros(1 << 22, dtype=torch.int64))], 1 << 22)
    monkeypatch.setattr(memory, "device_free_bytes", lambda dev, pool=None: 2 * 72 * free_rows)
    stream = SimpleNamespace(
        executor=SimpleNamespace(memory_ctx=None), device="cpu", build_roots=[]
    )
    assert StreamingAggregator._fitting_chunk_rows(stream, slab, 3_000_000) == chunk


def test_tpcds_slab_holds_the_scanned_rows():
    """The tpcds connector's device slab holds the rows of the splits a
    table scan reads, in split order, and stages a column once."""
    from trino_tpu_torch.columnar import concat_batches
    from trino_tpu_torch.connectors.tpcds import TpcdsConnector

    conn = TpcdsConnector(split_rows=1 << 12)
    cols = ["inv_item_sk", "inv_quantity_on_hand"]
    slab, rows = conn.device_slab("tiny", "inventory", cols, 1 << 12, 1 << 30, "cpu")
    splits = conn.get_splits("tiny", "inventory", 64)
    assert len(splits) > 1
    want = concat_batches([conn.read_split("tiny", "inventory", cols, s) for s in splits])
    assert rows == want.num_rows == conn.estimate_rows("tiny", "inventory")
    for got, exp in zip(slab.columns, want.columns):
        assert torch.equal(got.data[:rows], exp.data[:rows])
        assert torch.equal(got.valid_mask()[:rows], exp.valid_mask()[:rows])
    again, _ = conn.device_slab("tiny", "inventory", cols[:1], 1 << 12, 1 << 30, "cpu")
    assert again.columns[0].data is slab.columns[0].data
