"""GROUPING SETS / ROLLUP / CUBE, FILTER aggregates, ``count_if`` and
min/max over VARCHAR through trino_tpu_torch, against the JAX reference,
on the CPU.

Each SQL text (the cases of ``tests/test_sql_breadth.py``'s grouping and
aggregate classes, and the shape of the chip's ``surface`` step: a ROLLUP
over ``lineitem ⋈ orders`` with a FILTER count and ``max(o_clerk)``) runs
through the reference's ``LocalQueryRunner`` (its interpreter) and the
port's on ``device="cpu"`` in four configurations: the local interpreter;
distributed (fragments, the aggregate split into partial and final);
distributed with every scan→aggregate fragment streamed over views of the
device slab in chunks of 4096 rows; and streamed over host chunks whose
string codes are remapped onto one running dictionary. The rows are
compared in canonical form, exactly (no DOUBLE is involved). Where the
reference's interpreter takes seconds to compile a case on a CPU, its rows
are committed below as their count and the SHA-256 of their canonical
text, as ``trino_tpu.testing.LocalQueryRunner().execute(CASES[name])[0]``
gives them.
"""

import hashlib

import pytest
import torch

from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch.testing import LocalQueryRunner

# one intra-op thread: test processes run side by side (pytest-xdist)
torch.set_num_threads(1)

STREAM = {"execution_mode": "distributed", "stream_scan_threshold_rows": 1}
CONFIGS = {
    "local": {"execution_mode": "local"},
    "distributed": {"execution_mode": "distributed"},
    "slab_chunks": dict(STREAM, stream_device_chunk_rows=4096),
    "host_chunks": dict(STREAM, stream_device_cache_bytes=0, stream_chunk_rows=4096),
}


@pytest.fixture(scope="module")
def ref():
    return RefRunner()


@pytest.fixture(scope="module")
def ports():
    out = {}
    for name, props in CONFIGS.items():
        r = LocalQueryRunner(device="cpu")
        for k, v in props.items():
            r.session.set(k, v)
        out[name] = r
    return out


def _key(row):
    return tuple((0, "") if v is None else (1, repr(v)) for v in row)


def canonical(rows) -> list:
    return sorted(rows, key=_key)


def digest(rows) -> tuple[int, str]:
    rows = canonical(rows)
    return len(rows), hashlib.sha256(repr(rows).encode()).hexdigest()


# the reference interpreter's rows of the cases it compiles slowest
COMMITTED = {
    "filter_grouped": (3, "0504251e7631780119062cd490340804b33ffcada69faf899925a113a8d3b50e"),
    "filter_over_lineitem": (
        4, "0ac784b947ac1e1300af3c63542995d940d1dcb85aade99160bcc26af0173d98"),
    "surface_cube": (24, "16cac7ab6249ad7f6f9a7d0ffbbca08e74c9c6d242c235891402ba14deb0b16a"),
    "surface_grouping_sets": (
        19, "49e2661d889957e34eca77fd777335361ed79e9e863ba6cbe5eb383bf6315e26"),
    "surface_rollup": (21, "2e9e3c00d5bddbff422e7e452d63e200abd3f6a0357ea7cd10b7d7354d3323fe"),
    "varchar_min_max_computed": (
        3, "65094c60a2ddad48653a6ed6c32aff33976c9a53f9836186ec8f079076da3314"),
    "varchar_min_max_filter": (
        5, "57b4d0fe438d2beed4e0eddd000905637f9792db8df2d1a4fe8220cf213865bf"),
    "varchar_min_max_nulls": (
        2, "c4f983a0380394c24a03b24c278183bb4416b10ffd21e11e5d688da7dbd09407"),
}


JOIN = ("from tpch.tiny.lineitem join tpch.tiny.orders on l_orderkey = o_orderkey")
SURFACE_AGGS = ("count(*), sum(l_quantity), count(*) filter (where l_discount > 0.05),"
                " max(o_clerk)")

CASES = {
    "rollup": "select o_orderstatus, o_orderpriority, count(*) c from tpch.tiny.orders"
              " group by rollup(o_orderstatus, o_orderpriority)",
    "grouping_sets": "select o_orderstatus, o_orderpriority, count(*) from tpch.tiny.orders"
                     " group by grouping sets ((o_orderstatus), (o_orderpriority))",
    "cube": "select o_orderstatus, count(*) from tpch.tiny.orders group by cube(o_orderstatus)",
    "mixed_plain_and_rollup": "select o_orderstatus, o_orderpriority, count(*)"
                              " from tpch.tiny.orders group by o_orderstatus,"
                              " rollup(o_orderpriority)",
    "rollup_empty_set": "select o_orderstatus, sum(o_totalprice) from tpch.tiny.orders"
                        " where o_orderkey < 0 group by rollup(o_orderstatus)",
    "surface_rollup": f"select o_orderpriority, l_returnflag, {SURFACE_AGGS} {JOIN}"
                      " group by rollup(o_orderpriority, l_returnflag)",
    "surface_grouping_sets": f"select o_orderpriority, l_returnflag, {SURFACE_AGGS} {JOIN}"
                             " group by grouping sets ((o_orderpriority, l_returnflag),"
                             " (l_returnflag), ())",
    "surface_cube": f"select o_orderpriority, l_returnflag, {SURFACE_AGGS} {JOIN}"
                    " group by cube(o_orderpriority, l_returnflag)",
    "count_if": "select count_if(o_orderstatus = 'F') from tpch.tiny.orders",
    "count_star_filter": "select count(*) filter (where o_orderstatus = 'F')"
                         " from tpch.tiny.orders",
    "filter_grouped": "select o_orderstatus, count(*) filter (where o_totalprice > 100000),"
                      " count_if(o_orderpriority = '1-URGENT'),"
                      " sum(o_totalprice) filter (where o_orderpriority < '3'),"
                      " avg(o_shippriority) filter (where o_custkey > 700),"
                      " min(o_orderdate) filter (where o_totalprice < 50000),"
                      " max(o_totalprice) filter (where o_orderstatus = 'P')"
                      " from tpch.tiny.orders group by 1",
    "filter_global_none_pass": "select count(*) filter (where o_totalprice < 0),"
                               " sum(o_totalprice) filter (where o_totalprice < 0)"
                               " from tpch.tiny.orders",
    "filter_over_lineitem": "select l_returnflag, l_linestatus,"
                            " sum(l_extendedprice) filter (where l_discount > 0.05),"
                            " count(*) filter (where l_shipmode = 'AIR')"
                            " from tpch.tiny.lineitem group by 1, 2",
    "varchar_min_max_grouped": "select o_orderstatus, max(o_clerk), min(o_clerk),"
                               " max(o_orderpriority) from tpch.tiny.orders group by 1",
    "varchar_min_max_global": "select max(o_clerk), min(o_clerk) from tpch.tiny.orders",
    "varchar_min_max_filter": "select o_orderpriority, max(o_clerk) filter"
                              " (where o_totalprice > 300000),"
                              " min(o_clerk) filter (where o_totalprice < 0)"
                              " from tpch.tiny.orders group by 1",
    "varchar_min_max_computed": "select l_returnflag, max(upper(l_shipmode)),"
                                " min(l_comment) from tpch.tiny.lineitem group by 1",
    "varchar_min_max_nulls": "select k, max(s), min(s) from (values (1, 'b'), (1, null),"
                             " (1, 'a'), (2, null)) t(k, s) group by k",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouping_and_aggregates_equal_the_reference(ref, ports, case):
    sql = CASES[case]
    want = COMMITTED.get(case) or digest(ref.execute(sql)[0])
    for name, port in ports.items():
        rows, _ = port.execute(sql)
        assert digest(rows) == want, (name, canonical(rows)[:5])


def test_streamed_configurations_stream(ports):
    """The streamed configurations really stream the scan→aggregate
    fragments of these cases (slab views and host chunks alike)."""
    for case in ("filter_grouped", "varchar_min_max_grouped", "varchar_min_max_computed"):
        for name in ("slab_chunks", "host_chunks"):
            port = ports[name]
            res = port.engine.execute_statement(CASES[case], port.session)
            assert "streamed" in (res.fragment_modes or {}).values(), (case, name)
            assert not (res.exchange_stats or {}).get("stream_fallbacks"), (case, name)


def test_rollup_has_the_grand_total(ports):
    """The grand-total row of the rollup counts every order once, and the
    per-status subtotals add up to it (tests/test_sql_breadth.py)."""
    for port in ports.values():
        rows, _ = port.execute(CASES["rollup"])
        assert [c for s, p, c in rows if s is None and p is None] == [15000]
        assert sum(c for s, p, c in rows if s is not None and p is None) == 15000


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(COMMITTED))
def test_committed_rows_equal_the_reference(ref, case):
    """Each committed count and digest is the reference interpreter's
    rows of its case, recomputed."""
    assert digest(ref.execute(CASES[case])[0]) == COMMITTED[case]
