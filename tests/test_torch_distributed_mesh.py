"""SQL on a mesh of 8 shards through trino_tpu_torch, against the reference.

``DistributedQueryRunner(n_devices=8, device="cpu")`` runs every query in
``execution_mode=distributed`` over 8 shards of the CPU: scans split over
the shards, per-shard aggregates and joins, and the hash and broadcast
exchanges between them (``parallel/exchange.py``). Held here:

- the cases of ``tests/test_distributed.py``: the rows equal the
  reference's on its 8-device mesh and the port's local executor's,
  through the fused fragment path and the interpreter
  (``fragment_execution=false``);
- the 22 TPC-H queries at ``tpch.tiny``: rows and column types equal the
  reference's rows committed in ``benchmarks/tpch_tiny_answers.json``
  (which the reference's fused runner equals, ``tests/test_tpch_fused.py``),
  and the fused-path fallback census is {13, 15, 21};
- the exchange counters of TPC-H Q3, Q5 and Q18 and of the skew suite's
  JOIN and GROUP queries equal the reference's fused runner's on its
  8-device mesh, field by field for the counters that the data decides
  (``exchanges``, ``shuffle_rows``, ``hot_keys``, ``salted_rows``, and
  the ``operators`` rows in and out). Where every exchanged input is a
  scan (the JOIN query, on and off, and the GROUP query on) or a streamed
  fragment (one chunk a shard, ``tests/test_torch_streaming_shards.py``),
  the exchange sites' capacities and provenance, the padded rows and
  bytes, the padding ratio and the overflow retries are equal too.
  Downstream of a join or a partial aggregate that does not stream they
  are not, and that difference is final: an exchange's capacity follows
  its input's, which the port sizes to the counted matches and groups
  where the reference sizes it from its probe's capacity (ROADMAP,
  reference quirks: first capacities); TPC-H Q3 pins it;
- ``tests/test_skew.py::TestSkewedJoin`` at 2^12 rows: rows equal with
  skew handling on, off and locally; on, hot keys are found, rows are
  salted; the join alone (its sides' exchanges are the only ones) has
  no capacity overflow on, and off overflows and pads at least twice as
  much.
"""

import numpy as np
import pytest
import torch

from trino_tpu_torch.benchmarks import tpch as B

torch.set_num_threads(1)

N = 8
SKEW_ROWS = 1 << 12
ANSWERS = B.ANSWERS_SF1.replace("tpch_sf1_answers", "tpch_tiny_answers")
STAT_FIELDS = ("exchanges", "shuffle_rows", "hot_keys", "salted_rows", "operators")
# the counters that the exchanges' capacities decide: equal where every
# exchanged input is a scan (see the module docstring)
PADDED_FIELDS = ("padded_shuffle_rows", "shuffle_bytes", "padding_ratio", "overflow_retries")


def exchange_capacities(stats) -> dict:
    """The exchange sites' capacities (``exch@``, its spill tier
    ``spill@`` and hot-key buffers ``hot@``) by site: value, provenance."""
    return {
        c["site"]: (c["value"], c["provenance"]) for c in stats["capacities"].values()
        if c["site"].split("@")[0] in ("exch", "spill", "hot")
    }


@pytest.fixture(scope="module")
def dist():
    from trino_tpu_torch.testing import DistributedQueryRunner

    return DistributedQueryRunner(n_devices=N, device="cpu")


@pytest.fixture(scope="module")
def local(dist):
    from trino_tpu_torch.testing import LocalQueryRunner

    return LocalQueryRunner(engine=dist.engine)


@pytest.fixture(scope="module")
def ref_dist():
    import jax

    from trino_tpu.testing import DistributedQueryRunner

    if len(jax.devices()) < N:
        pytest.skip("needs the 8-device virtual mesh")
    return DistributedQueryRunner(n_devices=N)


DISTRIBUTED_CASES = {
    "global_count": "select count(*) from lineitem",
    "global_sum_min_max": "select sum(l_quantity), min(l_quantity), max(l_quantity), "
                          "count(l_quantity) from lineitem",
    "group_by_flag": "select l_returnflag, count(*), sum(l_extendedprice) "
                     "from lineitem group by l_returnflag",
    "filter_project": "select count(*), sum(l_extendedprice * l_discount) from lineitem "
                      "where l_shipdate >= date '1994-01-01' and l_shipdate < date "
                      "'1995-01-01' and l_discount between 0.05 and 0.07 and l_quantity < 24",
    "avg_decimal": "select l_linestatus, avg(l_extendedprice) from lineitem "
                   "group by l_linestatus",
    "broadcast_join": "select n_name, count(*) from customer, nation "
                      "where c_nationkey = n_nationkey group by n_name",
    "partitioned_join": "select o_orderpriority, count(*) from orders, lineitem "
                        "where l_orderkey = o_orderkey and o_orderdate >= date '1995-01-01' "
                        "group by o_orderpriority",
    "q3": B.queries("tpch.tiny")[3].replace("tpch.tiny.", ""),
}


def _props(runner, **props):
    from trino_tpu_torch.config import Session

    s = Session(properties={**runner.session.properties, **props})
    return s


@pytest.fixture(scope="module")
def ref_case_rows(ref_dist):
    """The reference's rows of each distributed case on its 8-device mesh,
    computed once a case (both of the port's paths are held to them)."""
    from trino_tpu.config import Session as RefSession

    cache = {}

    def rows(case):
        if case not in cache:
            props = dict(ref_dist.session.properties)
            if case == "partitioned_join":
                props["join_distribution_type"] = "PARTITIONED"
            cache[case] = ref_dist.engine.execute_statement(
                DISTRIBUTED_CASES[case], RefSession(properties=props)).rows
        return cache[case]

    return rows


@pytest.mark.parametrize("fragments", [True, False], ids=["fused", "interpreter"])
@pytest.mark.parametrize("case", sorted(DISTRIBUTED_CASES))
def test_distributed_equals_local(dist, local, ref_case_rows, case, fragments):
    """``tests/test_distributed.py``'s cases on 8 shards: the rows equal
    the reference's on its 8-device mesh, and the port's local run's."""
    sql = DISTRIBUTED_CASES[case]
    props = {"fragment_execution": fragments}
    if case == "partitioned_join":
        props["join_distribution_type"] = "PARTITIONED"
    got = dist.engine.execute_statement(sql, _props(dist, **props)).rows
    ref = ref_case_rows(case)
    want = local.engine.execute_statement(sql, local.session).rows
    got, ref, want = ([tuple(row) for row in r] for r in (got, ref, want))
    if case != "q3":  # q3 is ordered
        got, ref, want = sorted(got), sorted(ref), sorted(want)
    assert got == ref
    assert got == want


@pytest.fixture(scope="module")
def answers():
    return B.load_answers(ANSWERS)["queries"]


# queries whose exchange counters are held against the reference's
STATS_QUERIES = (3, 5, 18)


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_tiny_on_eight_shards(dist, answers, q, request):
    """Rows and types against the committed answers; for Q3, Q5 and Q18
    also the exchange counters against the reference's fused runner on
    its 8-device mesh."""
    sql = B.queries("tpch.tiny")[q]
    res = dist.engine.execute_statement(sql, dist.session)
    want = answers[str(q)]
    assert [t.name for t in res.column_types] == want["types"]
    bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"], want["order_by"])
    assert bad is None, f"Q{q}: {bad}"
    if q in STATS_QUERIES:
        from trino_tpu.benchmarks.tpch import queries as ref_queries

        ref_dist = request.getfixturevalue("ref_dist")
        ref = ref_dist.engine.execute_statement(ref_queries("tpch.tiny")[q], ref_dist.session)
        assert res.rows == ref.rows
        for f in STAT_FIELDS:
            assert res.exchange_stats[f] == ref.exchange_stats[f], f
        assert res.exchange_stats["exchanges"] >= 1


def test_q3_exchange_capacities_downstream_of_a_join(dist, request):
    """TPC-H Q3 on 8 shards, its fragments materialized: the output
    exchange of its join-and-partial-aggregate fragment ships the same
    rows as the reference's (``exchanges``, ``shuffle_rows``), through
    the same sites, but the port's capacity follows the groups it
    counted (256 slots a (source, destination) pair) where the
    reference's follows its probe's capacity (4,096), and the padded
    rows and bytes follow the capacities on both sides: n x (n x bucket
    + spill) slots. The difference is final (ROADMAP, reference quirks:
    first capacities); no session property takes the reference's."""
    from trino_tpu.benchmarks.tpch import queries as ref_queries

    ref_dist = request.getfixturevalue("ref_dist")
    got = dist.engine.execute_statement(B.queries("tpch.tiny")[3], dist.session)
    want = ref_dist.engine.execute_statement(ref_queries("tpch.tiny")[3], ref_dist.session)
    assert got.rows == want.rows
    assert "streamed" not in got.fragment_modes.values()
    for f in ("exchanges", "shuffle_rows"):
        assert got.exchange_stats[f] == want.exchange_stats[f], f
    caps, ref_caps = (exchange_capacities(r.exchange_stats) for r in (got, want))
    assert caps == {"exch@2": (256, "default"), "spill@2": (128, "default")}
    assert ref_caps == {"exch@2": (4096, "default"), "spill@2": (2048, "default")}
    for st, c in ((got.exchange_stats, caps), (want.exchange_stats, ref_caps)):
        assert st["padded_shuffle_rows"] == N * (N * c["exch@2"][0] + c["spill@2"][0])
    assert got.exchange_stats["shuffle_bytes"] < want.exchange_stats["shuffle_bytes"]


def test_streamed_fragments_on_eight_shards(dist, answers):
    """Q1 and Q6 with their lineitem fragment streamed (the sort-based
    step over the sharded scan; the dense group-by stays off a mesh of
    more than one shard), then the stream's output exchange."""
    s = _props(dist, stream_scan_threshold_rows=1 << 14, stream_device_chunk_rows=1 << 16)
    for q in (1, 6):
        res = dist.engine.execute_statement(B.queries("tpch.tiny")[q], s)
        assert "streamed" in res.fragment_modes.values()
        want = answers[str(q)]
        bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"], want["order_by"])
        assert bad is None, f"Q{q}: {bad}"


def test_fallback_census(dist):
    from trino_tpu_torch.exec.fragments import fragment_plan, query_fusable

    fallbacks = {
        q for q, sql in B.queries("tpch.tiny").items()
        if not query_fusable(fragment_plan(dist.plan(sql), dist.session))
    }
    assert fallbacks == {13, 15, 21}


# --- the skew suite (tests/test_skew.py) at 2^12 rows -----------------------

JOIN_SQL = """select sum(f.v * d.name) as chk, count(*) as c
from memory.default.facts f join memory.default.dims d on f.k = d.k"""
GROUP_SQL = """select d.name, count(*) as c, sum(f.v) as sv
from memory.default.facts f join memory.default.dims d on f.k = d.k
group by d.name order by d.name"""


def _seed_port(catalogs, n_rows, seed):
    """``tests/test_skew.py::_seed_tables`` on the port's memory connector:
    the same Zipf(1.2) keys over 8 values from the same seed."""
    from test_skew import N_DIM, _zipf_keys

    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch, Column
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema

    mem = catalogs.get("memory")
    rng = np.random.default_rng(seed)
    keys = _zipf_keys(rng, n_rows, N_DIM)
    vals = rng.integers(0, 1000, n_rows).astype(np.int64)
    mem.create_table("default", "facts", TableSchema(
        "facts", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))))
    mem.insert("default", "facts", Batch(
        [Column(T.BIGINT, torch.from_numpy(keys)), Column(T.BIGINT, torch.from_numpy(vals))],
        n_rows))
    dk = np.arange(1, N_DIM + 1, dtype=np.int64)
    mem.create_table("default", "dims", TableSchema(
        "dims", (ColumnSchema("k", T.BIGINT), ColumnSchema("name", T.BIGINT))))
    mem.insert("default", "dims", Batch(
        [Column(T.BIGINT, torch.from_numpy(dk)), Column(T.BIGINT, torch.from_numpy(dk * 100))],
        N_DIM))


@pytest.fixture(scope="module")
def skew_runners():
    import jax

    from test_skew import _seed_tables
    from trino_tpu.testing import LocalQueryRunner as RefRunner
    from trino_tpu_torch.testing import DistributedQueryRunner

    if len(jax.devices()) < N:
        pytest.skip("needs the 8-device virtual mesh")
    ref = RefRunner()
    _seed_tables(ref.catalogs, n_rows=SKEW_ROWS, seed=9)
    port = DistributedQueryRunner(n_devices=N, device="cpu")
    _seed_port(port.catalogs, SKEW_ROWS, seed=9)
    return ref, port


def _run(runner, sql, **props):
    return runner.engine.execute_statement(
        sql, _props(runner, execution_mode="distributed",
                    join_distribution_type="PARTITIONED", **props))


@pytest.fixture(scope="module")
def skew_runs(skew_runners):
    """Each skew query once a setting on both sides (module scope: the
    reference's fused programs compile once)."""
    from trino_tpu.config import Session as RefSession

    ref, port = skew_runners
    out = {}
    for name, sql in (("join", JOIN_SQL), ("group", GROUP_SQL)):
        for skew in (True, False):
            out[name, skew, "port"] = _run(port, sql, skew_handling=skew)
            out[name, skew, "ref"] = ref.engine.execute_statement(sql, RefSession(properties={
                "execution_mode": "distributed", "join_distribution_type": "PARTITIONED",
                "skew_handling": skew}))
        out[name, "local"] = port.engine.execute_statement(
            sql, _props(port, execution_mode="local"))
    return out


def test_skewed_join_rows_and_counters(skew_runs):
    """Both skew queries in one test (their runs are one module fixture,
    computed once a process)."""
    for name in ("join", "group"):
        on, off = skew_runs[name, True, "port"], skew_runs[name, False, "port"]
        assert on.rows == off.rows == skew_runs[name, "local"].rows
        assert on.rows == skew_runs[name, True, "ref"].rows
        assert on.exchange_stats["hot_keys"] > 0 and on.exchange_stats["salted_rows"] > 0
        if name == "join":
            # the join's two sides are the only hash exchanges: the padding
            # comparison isolates the skew path (as in the reference's test)
            assert on.exchange_stats["overflow_retries"] == 0
            assert off.exchange_stats["overflow_retries"] >= 1
            r_on, r_off = on.exchange_stats["padding_ratio"], off.exchange_stats["padding_ratio"]
            assert r_on > 0 and r_off >= 2 * r_on, (r_on, r_off)
        for skew in (True, False):
            got = skew_runs[name, skew, "port"].exchange_stats
            want = skew_runs[name, skew, "ref"].exchange_stats
            fields = STAT_FIELDS
            if name == "join" or skew:
                fields += PADDED_FIELDS
                assert exchange_capacities(got) == exchange_capacities(want), (name, skew)
            for f in fields:
                assert got[f] == want[f], (name, skew, f, got[f], want[f])
    # the capacity sites and their provenance (test_capacity_provenance_recorded)
    caps = skew_runs["group", True, "port"].exchange_stats["capacities"]
    assert any(name.startswith("exch@") for name in caps)
    for site in caps.values():
        assert site["provenance"].split("+")[0] in ("default", "seeded", "history")
        assert site["value"] > 0


def test_skewed_join_interpreter_path(skew_runners):
    """The interpreter (``fragment_execution=false``) takes the hybrid
    exchange: the same rows as the fused path, with hot keys found."""
    _, port = skew_runners
    on = _run(port, GROUP_SQL, fragment_execution=False)
    off = _run(port, GROUP_SQL, fragment_execution=False, skew_handling=False)
    fused = _run(port, GROUP_SQL)
    assert on.rows == off.rows == fused.rows
    assert on.exchange_stats["hot_keys"] > 0
