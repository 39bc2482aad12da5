"""One streamed chunk a shard on the N-shard mesh, against the reference.

On a mesh of N > 1 shards a streamed fragment takes N host parts a step,
each padded to one per-shard capacity (``StreamingAggregator._host_parts``
in the port, ``_chunks`` in the reference, ``trino_tpu/exec/streaming.py:
204-250``), steps each shard over its own part, and hands N x G rows to
its output exchange. Held here:

- on 4 shards, the port's host-part sequence equals the reference's over
  the same splits: the parts a step, the per-shard capacity, each part's
  live rows (their first column's values) and the empty parts that pad a
  short last step, over three split shapes;
- on 8 shards with streaming forced, TPC-H Q1 and Q6 at ``tpch.tiny``:
  the rows equal the committed answers, the lineitem fragment streams 8
  parts a step and never reaches the dense group-by (K1), and the
  exchange counters (padded rows, bytes and ratio included) and the
  exchange sites' capacities equal the reference's run with the same
  session properties.
"""

import pytest
import torch

from trino_tpu_torch.benchmarks import tpch as B

torch.set_num_threads(1)

ANSWERS = B.ANSWERS_SF1.replace("tpch_sf1_answers", "tpch_tiny_answers")
# a stream forced on tpch.tiny's lineitem: 60,175 rows past the threshold,
# 2^13-row parts
FORCED = {"stream_scan_threshold_rows": 1 << 14, "stream_chunk_rows": 1 << 13}
COUNTERS = ("exchanges", "shuffle_rows", "padded_shuffle_rows", "shuffle_bytes",
            "padding_ratio", "overflow_retries", "hot_keys", "salted_rows")

# (table, columns, stream_chunk_rows): full steps, a short last step over
# one split, and uneven memory-table parts whose first sets a small cap
SPLIT_SHAPES = {
    "lineitem_full_steps": ("tpch", "tiny", "lineitem",
                            ["l_orderkey", "l_returnflag", "l_quantity"], 1 << 13),
    "orders_short_tail": ("tpch", "tiny", "orders",
                          ["o_orderkey", "o_orderstatus", "o_totalprice"], 1 << 10),
    "memory_uneven_parts": ("memory", "default", "parts",
                            ["o_orderkey", "o_orderstatus"], 1 << 11),
}
# the memory table's parts: one INSERT each, by order-key range (about
# 1,000, 9,000 and 3,000 rows)
PART_RANGES = ((0, 4000), (4001, 40000), (40001, 52000))


def _memory_parts(engine, session):
    engine.execute_statement(
        "create table memory.default.parts as select o_orderkey, o_orderstatus "
        "from tpch.tiny.orders where o_orderkey < 0", session)
    for lo, hi in PART_RANGES:
        engine.execute_statement(
            "insert into memory.default.parts select o_orderkey, o_orderstatus "
            f"from tpch.tiny.orders where o_orderkey between {lo} and {hi}", session)


@pytest.fixture(scope="module")
def engines():
    """The port's and the reference's local engines, each with the memory
    table of uneven parts."""
    from trino_tpu.testing import LocalQueryRunner as RefRunner
    from trino_tpu_torch.testing import LocalQueryRunner

    port, ref = LocalQueryRunner(device="cpu"), RefRunner()
    _memory_parts(port.engine, port.session)
    _memory_parts(ref.engine, ref.session)
    return port, ref


def _scan(P, types, catalog, schema, table, columns, connector):
    cols = {c.name: c.type for c in connector.get_table(schema, table).columns}
    syms = [P.Symbol(c, cols[c]) for c in columns]
    return P.TableScan(catalog, schema, table, syms, list(columns))


def _port_steps(runner, shape, n):
    from trino_tpu_torch.exec.local import LocalExecutor
    from trino_tpu_torch.exec.streaming import StreamingAggregator
    from trino_tpu_torch.planner import plan as P
    from trino_tpu_torch import types as T

    catalog, schema, table, columns, rows = shape
    agg = StreamingAggregator.__new__(StreamingAggregator)
    agg.executor = LocalExecutor(runner.catalogs, runner.session, "cpu")
    agg.n, agg._running_dicts = n, None
    agg.scan = _scan(P, T, catalog, schema, table, columns, runner.catalogs.get(catalog))
    return [(cap, [(p.num_rows, p.columns[0].data[: p.num_rows].tolist()) for p in parts])
            for parts, cap in agg._host_parts(rows)]


def _ref_steps(runner, shape, n):
    import numpy as np

    from trino_tpu import types as T
    from trino_tpu.exec.local import LocalExecutor
    from trino_tpu.exec.streaming import StreamingAggregator
    from trino_tpu.planner import plan as P

    catalog, schema, table, columns, rows = shape
    agg = StreamingAggregator.__new__(StreamingAggregator)
    agg.executor = LocalExecutor(runner.catalogs, runner.session)
    agg.n, agg._running_dicts, agg._sensitive_dicts = n, None, set()
    agg.scan = _scan(P, T, catalog, schema, table, columns, runner.catalogs.get(catalog))
    return [(cap, [(p.num_rows, np.asarray(p.columns[0].data)[: p.num_rows].tolist())
                   for p in parts])
            for parts, cap in agg._chunks(rows)]


@pytest.mark.parametrize("shape", sorted(SPLIT_SHAPES))
def test_host_parts_equal_the_reference_chunks(engines, shape):
    """4 shards: every step's parts, per-shard capacity, live rows and
    tail padding equal the reference's ``_chunks`` over the same splits."""
    port, ref = engines
    got = _port_steps(port, SPLIT_SHAPES[shape], 4)
    want = _ref_steps(ref, SPLIT_SHAPES[shape], 4)
    assert [len(parts) for _, parts in got] == [4] * len(got)
    assert got == want
    if shape != "lineitem_full_steps":
        # a short last step: its tail parts are empty
        assert got[-1][1][-1] == (0, [])
    if shape == "memory_uneven_parts":
        # the first (1,000-row) split sets the cap; later splits are cut
        assert {cap for cap, _ in got} == {1024} and len(got) > 3


@pytest.fixture(scope="module")
def mesh_runs():
    """A query of TPC-H on 8 shards with the lineitem fragment streamed, in
    both packages, run once a module (the reference's programs compile
    once). The port's dense group-by is watched: it must not run on a
    mesh. ``run(q)`` gives (the port's result, the reference's, the dense
    group-by's calls)."""
    import jax

    from trino_tpu.benchmarks.tpch import queries as ref_queries
    from trino_tpu.config import Session as RefSession
    from trino_tpu.testing import DistributedQueryRunner as RefDistributed
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.ops import dense_groupby as DG
    from trino_tpu_torch.testing import DistributedQueryRunner

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    port, ref = DistributedQueryRunner(n_devices=8, device="cpu"), RefDistributed(n_devices=8)
    cache = {}

    def run(q):
        if q not in cache:
            dense_calls = []
            orig = DG.dense_groupby_device

            def watched(*a, **k):
                dense_calls.append(1)
                return orig(*a, **k)

            DG.dense_groupby_device = watched
            try:
                got = port.engine.execute_statement(
                    B.queries("tpch.tiny")[q],
                    Session(properties={**port.session.properties, **FORCED,
                                        "stream_device_chunk_rows": 1 << 16}))
            finally:
                DG.dense_groupby_device = orig
            want = ref.engine.execute_statement(
                ref_queries("tpch.tiny")[q],
                RefSession(properties={**ref.session.properties, **FORCED}))
            cache[q] = got, want, dense_calls
        return cache[q]

    run.port = port
    return run


@pytest.mark.parametrize("q", [1, 6])
def test_streamed_tpch_on_eight_shards_equals_the_reference(mesh_runs, q):
    from test_torch_distributed_mesh import exchange_capacities

    got, want, dense_calls = mesh_runs(q)
    ans = B.load_answers(ANSWERS)["queries"][str(q)]
    bad = B.first_mismatch(B.canonical_rows(got.rows), ans["rows"], ans["order_by"])
    assert bad is None, f"Q{q}: {bad}"
    assert got.rows == want.rows
    [stream] = got.exchange_stats["streams"]
    assert got.fragment_modes[stream["fragment"]] == "streamed"
    # 60,175 lineitem rows: 8 splits, one 2^13-row part a shard, one step
    assert (stream["parts"], stream["shard_cap"], stream["steps"]) == (8, 1 << 13, 1)
    assert dense_calls == []
    for f in COUNTERS:
        assert got.exchange_stats[f] == want.exchange_stats[f], f
    assert exchange_capacities(got.exchange_stats) == exchange_capacities(want.exchange_stats)
    if q == 1:  # the partial aggregate's n x G rows through a hash exchange
        assert got.exchange_stats["exchanges"] == 1
        assert exchange_capacities(got.exchange_stats)


@pytest.mark.parametrize("shape", ["lineitem_full_steps", "orders_short_tail"])
def test_slab_views_take_the_host_stream_shape(engines, shape):
    """4 shards, a table the connector stages: the slab streams in the
    host parts' shape (steps, N parts a step, the per-shard capacity),
    every live row once, with no row through the host."""
    from trino_tpu_torch.exec.local import LocalExecutor
    from trino_tpu_torch.exec.streaming import StreamingAggregator
    from trino_tpu_torch.planner import plan as P
    from trino_tpu_torch import types as T

    port, _ = engines
    catalog, schema, table, columns, rows = SPLIT_SHAPES[shape]
    port.session.set("stream_chunk_rows", rows)
    try:
        host = _port_steps(port, SPLIT_SHAPES[shape], 4)
        agg = StreamingAggregator.__new__(StreamingAggregator)
        agg.executor = LocalExecutor(port.catalogs, port.session, "cpu")
        agg.n = 4
        connector = port.catalogs.get(catalog)
        agg.scan = _scan(P, T, catalog, schema, table, columns, connector)
        slab, num_rows = connector.device_slab(schema, table, columns, 1 << 22, 1 << 30,
                                               device="cpu")
        steps = list(agg._slab_shard_chunks(slab, num_rows))
    finally:
        port.session.set("stream_chunk_rows", 1 << 20)
    cap = host[0][0]
    assert agg.shard_cap == cap and len(steps) == len(host)
    assert all(b.shards == 4 and b.capacity == 4 * cap for b in steps)
    live = [int(b.sel.sum()) for b in steps]
    assert sum(live) == num_rows == sum(r for _, parts in host for r, _ in parts)
    keys = torch.cat([b.columns[0].data[b.sel] for b in steps])
    assert keys.tolist() == slab.columns[0].data[:num_rows].tolist()


def test_group_budget_overflows_per_shard_and_grows(mesh_runs):
    """8 shards, ~1,900 orders a shard against a budget of 256 groups a
    shard: the step's shard-keyed group-bys flag the overflow, the budget
    grows, and the rows equal the interpreter's."""
    from trino_tpu_torch.config import Session

    port = mesh_runs.port
    sql = ("select l_orderkey, count(*), sum(l_quantity) from tpch.tiny.lineitem "
           "group by l_orderkey")
    props = {**port.session.properties, **FORCED, "stream_group_budget": 256}
    got = port.engine.execute_statement(sql, Session(properties=props))
    [stream] = got.exchange_stats["streams"]
    assert stream["parts"] == 8
    assert got.exchange_stats["overflow_retries"] >= 1
    want = port.engine.execute_statement(
        sql, Session(properties={**props, "execution_mode": "local"}))
    assert sorted(got.rows) == sorted(want.rows) and len(got.rows) == 15000
