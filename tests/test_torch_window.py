"""Window functions, FULL OUTER joins, set operations, DISTINCT and VALUES
through trino_tpu_torch, against the JAX reference, on the CPU.

- ``ops/window.py::compute_windows`` against the reference's
  ``trino_tpu/ops/window.py::compute_windows`` on seeded numpy inputs:
  every window kind, under every frame the executor selects (RANGE and
  ROWS running frames, the whole partition, ROWS k PRECEDING), with and
  without partition keys, with NULLs and ties in the partition, order
  and argument columns and unselected rows. Integer and DECIMAL lanes
  (int64 unscaled) and the ranking kinds are compared exactly (the
  percent_rank and cume_dist DOUBLEs too: one division of exact
  integers). DOUBLE arguments are not compared: the reference's segmented
  scan and the port's add them in different orders, and no query of the
  TPC-DS corpus windows over a DOUBLE.
- The SQL cases of ``tests/test_window.py`` and
  ``tests/test_full_outer_join.py`` through the port's SQL in both
  execution modes, with the rows those files expect; and UNION,
  INTERSECT and EXCEPT (DISTINCT and ALL) and SELECT DISTINCT over
  VALUES, with the rows the reference gives.
"""

from decimal import Decimal

import numpy as np
import pytest
import torch

from trino_tpu.ops import window as RW
from trino_tpu.ops.sort import SortKey as RSortKey
from trino_tpu_torch.exec.local import ExecutionError
from trino_tpu_torch.ops import window as W
from trino_tpu_torch.ops.sort import SortKey
from trino_tpu_torch.testing import LocalQueryRunner

# one intra-op thread: test processes run side by side (pytest-xdist), and
# torch's CPU thread pools then oversubscribe the cores, which slows the
# port's many small tensor ops ten- to a hundredfold
torch.set_num_threads(1)

FUNCTIONS = [
    ("row_number", 1, False), ("rank", 1, False), ("dense_rank", 1, False),
    ("percent_rank", 1, False), ("cume_dist", 1, False), ("ntile", 3, False),
    ("lead", 1, False), ("lead", 2, True), ("lag", 1, False), ("lag", 3, True),
    ("first_value", 1, False), ("last_value", 1, False),
    ("nth_value", 2, False), ("sum", 1, False), ("count", 1, False),
    ("count_star", 1, False), ("avg", 1, False), ("min", 1, False),
    ("max", 1, False),
]
NEEDS_ARG = {"lead", "lag", "first_value", "last_value", "nth_value", "sum",
             "count", "avg", "min", "max"}
FRAMES = [("running_range", 0), ("running_rows", 0), ("partition", 0),
          ("rows_preceding", 2)]


def _inputs(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    part = rng.integers(0, 6, n).astype(np.int64)
    part_v = rng.random(n) > 0.1
    # a dictionary-coded partition key: codes with lexicographic ranks
    code = rng.integers(0, 4, n).astype(np.int32)
    ranks = np.array([2, 0, 3, 1], dtype=np.int64)
    order = rng.integers(0, 25, n).astype(np.int64)  # ties
    order_v = rng.random(n) > 0.15
    order2 = rng.integers(-3, 3, n).astype(np.int64)
    arg = rng.integers(-10**12, 10**12, n).astype(np.int64)  # DECIMAL lanes
    arg_v = rng.random(n) > 0.2
    dflt = rng.integers(-50, 50, n).astype(np.int64)
    sel = rng.random(n) > 0.1
    return part, part_v, code, ranks, order, order_v, order2, arg, arg_v, dflt, sel


def _run(impl, partitioned, frame, args_np):
    part, part_v, code, ranks, order, order_v, order2, arg, arg_v, dflt, sel = args_np
    if impl == "ref":
        import jax.numpy as jnp

        arr, SK, mod = jnp.asarray, RSortKey, RW
        ones = jnp.ones(len(sel), dtype=bool)
    else:
        arr, SK, mod = torch.from_numpy, SortKey, W
        ones = torch.ones(len(sel), dtype=torch.bool)
    pk = [(arr(part), arr(part_v)), (arr(code), ones)] if partitioned else []
    pr = [None, ranks] if partitioned else []
    ok = [(arr(order), arr(order_v)), (arr(order2), ones)]
    specs = [SK(ascending=False, nulls_first=True), SK()]
    value = (arr(arg), arr(arg_v))
    fns, fargs, fdef = [], [], []
    for kind, off, has_d in FUNCTIONS:
        fns.append(mod.WindowFn(kind, off, has_d))
        fargs.append(value if kind in NEEDS_ARG else None)
        fdef.append((arr(dflt), ones) if has_d else None)
    return mod.compute_windows(
        pk, pr, ok, specs, [None, None], arr(sel), fns, fargs, fdef,
        mod.WindowSpecKernel(*frame),
    )


@pytest.mark.parametrize("partitioned", [True, False], ids=["partitioned", "whole"])
@pytest.mark.parametrize("frame", FRAMES, ids=[f[0] for f in FRAMES])
def test_compute_windows_matches_reference(frame, partitioned):
    args_np = _inputs(7 + FRAMES.index(frame))
    sel = args_np[-1]
    ref = _run("ref", partitioned, frame, args_np)
    port = _run("port", partitioned, frame, args_np)
    for (kind, off, _), (rd, rv), (pd, pv) in zip(FUNCTIONS, ref, port):
        rd, rv = np.asarray(rd), np.asarray(rv)
        pd, pv = pd.numpy(), pv.numpy()
        name = f"{kind}({off})"
        np.testing.assert_array_equal(pv[sel], rv[sel], name)
        live = sel & rv
        np.testing.assert_array_equal(pd[live], rd[live].astype(pd.dtype), name)


T1 = "(values (1, 10), (1, 20), (1, 20), (2, 5), (2, 15), (3, 7)) as t(g, v)"

# the cases of tests/test_window.py and tests/test_full_outer_join.py, with
# the rows they expect of the reference
SQL_CASES = {
    "row_number": (
        f"select g, v, row_number() over (partition by g order by v) rn "
        f"from {T1} order by g, v, rn",
        [(1, 10, 1), (1, 20, 2), (1, 20, 3), (2, 5, 1), (2, 15, 2), (3, 7, 1)]),
    "rank_dense_rank": (
        f"select g, v, rank() over (partition by g order by v) r, "
        f"dense_rank() over (partition by g order by v) dr from {T1} order by g, v",
        [(1, 10, 1, 1), (1, 20, 2, 2), (1, 20, 2, 2), (2, 5, 1, 1),
         (2, 15, 2, 2), (3, 7, 1, 1)]),
    "row_number_no_partition": (
        "select v, row_number() over (order by v desc) rn "
        "from (values (3), (1), (2)) as t(v) order by v",
        [(1, 3), (2, 2), (3, 1)]),
    "ntile": (
        "select v, ntile(2) over (order by v) nt "
        "from (values (1), (2), (3), (4)) as t(v) order by v",
        [(1, 1), (2, 1), (3, 2), (4, 2)]),
    "running_sum": (
        f"select g, v, sum(v) over (partition by g order by v) s "
        f"from {T1} order by g, v, s",
        [(1, 10, 10), (1, 20, 50), (1, 20, 50), (2, 5, 5), (2, 15, 20), (3, 7, 7)]),
    "partition_total": (
        f"select g, v, sum(v) over (partition by g) s from {T1} order by g, v",
        [(1, 10, 50), (1, 20, 50), (1, 20, 50), (2, 5, 20), (2, 15, 20), (3, 7, 7)]),
    "rows_frame": (
        f"select g, v, sum(v) over (partition by g order by v "
        f"rows between unbounded preceding and current row) s "
        f"from {T1} order by g, v, s",
        [(1, 10, 10), (1, 20, 30), (1, 20, 50), (2, 5, 5), (2, 15, 20), (3, 7, 7)]),
    "count_avg_min_max": (
        "select g, count(*) over (partition by g) c, "
        "avg(v) over (partition by g) a, min(v) over (partition by g) mn, "
        "max(v) over (partition by g) mx "
        "from (values (1, 10.0), (1, 20.0), (2, 5.0)) as t(g, v) order by g, c",
        [(1, 2, 15.0, 10.0, 20.0), (1, 2, 15.0, 10.0, 20.0), (2, 1, 5.0, 5.0, 5.0)]),
    "null_handling": (
        "select g, sum(v) over (partition by g) s, count(v) over (partition by g) c "
        "from (values (1, 10), (1, null), (2, null)) as t(g, v) order by g, s",
        [(1, 10, 1), (1, 10, 1), (2, None, 0)]),
    "lead_lag": (
        f"select g, v, lag(v) over (partition by g order by v) lg, "
        f"lead(v) over (partition by g order by v) ld "
        f"from {T1} order by g, v, lg nulls first",
        [(1, 10, None, 20), (1, 20, 10, 20), (1, 20, 20, None),
         (2, 5, None, 15), (2, 15, 5, None), (3, 7, None, None)]),
    "lag_with_default": (
        "select v, lag(v, 1, -1) over (order by v) lg "
        "from (values (1), (2), (3)) as t(v) order by v",
        [(1, -1), (2, 1), (3, 2)]),
    "first_last_value": (
        f"select g, v, first_value(v) over (partition by g order by v) fv, "
        f"last_value(v) over (partition by g order by v "
        f"rows between unbounded preceding and unbounded following) lv "
        f"from {T1} order by g, v",
        [(1, 10, 10, 20), (1, 20, 10, 20), (1, 20, 10, 20),
         (2, 5, 5, 15), (2, 15, 5, 15), (3, 7, 7, 7)]),
    "strings": (
        "select n, first_value(n) over (order by n) f "
        "from (values ('b'), ('a'), ('c')) as t(n) order by n",
        [("a", "a"), ("b", "a"), ("c", "a")]),
    "rank_over_sum": (
        "select g, sum(v) s, rank() over (order by sum(v) desc) r "
        "from (values (1, 10), (1, 20), (2, 5), (3, 50)) as t(g, v) "
        "group by g order by r",
        [(3, 50, 1), (1, 30, 2), (2, 5, 3)]),
    "window_after_where": (
        "select v, row_number() over (order by v) rn "
        "from (values (1), (2), (3), (4)) as t(v) where v > 1 order by v",
        [(2, 1), (3, 2), (4, 3)]),
    "full_join_basic": (
        "select a.k, a.x, b.k, b.y from "
        "(values (1, 'a'), (2, 'b'), (3, 'c')) a(k, x) full join "
        "(values (2, 'bb'), (3, 'cc'), (4, 'dd')) b(k, y) on a.k = b.k "
        "order by coalesce(a.k, b.k)",
        [(1, "a", None, None), (2, "b", 2, "bb"), (3, "c", 3, "cc"),
         (None, None, 4, "dd")]),
    "full_join_duplicates_and_nulls": (
        "select count(*), count(a.k), count(b.k) from "
        "(values 1, 1, 2, null) a(k) full join (values 1, 3, null) b(k) "
        "on a.k = b.k",
        [(6, 3, 3)]),
    "full_join_aggregate": (
        "select sum(coalesce(a.v, 0) + coalesce(b.v, 0)) from "
        "(values (1, 10), (2, 20)) a(k, v) full join "
        "(values (2, 200), (3, 300)) b(k, v) on a.k = b.k",
        [(530,)]),
    "full_join_empty_sides": (
        "select count(*) from "
        "(select * from (values 1) t(k) where k > 5) a full join "
        "(values 7, 8) b(k) on a.k = b.k",
        [(2,)]),
    # set operations and DISTINCT (the rows the reference gives): bag
    # semantics of the ALL variants, NULLs equal, strings from different
    # dictionaries, DECIMAL and integer branches coerced
    "intersect_all": (
        "select x from (select x from (values 1, 1, 2, null, null) t(x) intersect all "
        "select y from (values 1, 2, 2, null) u(y)) s order by x nulls first",
        [(None,), (1,), (2,)]),
    "except_all": (
        "select x from (select x from (values 1, 1, 2, null, null) t(x) except all "
        "select y from (values 1, 2, 2, null) u(y)) s order by x nulls first",
        [(None,), (1,)]),
    "union_distinct": (
        "select x from (select x from (values 1, 1, 2, null) t(x) union "
        "select y from (values 2, 3, null) u(y)) s order by x nulls first",
        [(None,), (1,), (2,), (3,)]),
    "intersect_strings": (
        "select s from (select s from (values 'a', 'b', 'c', 'c') t(s) intersect "
        "select r from (values 'c', 'a', 'z') u(r)) v order by s",
        [("a",), ("c",)]),
    "except_decimal": (
        "select x from (select x from (values 1.5, 2.0, 2.0) t(x) except "
        "select y from (values 2) u(y)) s order by x",
        [(Decimal("1.5"),)]),
    "union_all_coerced": (
        "select x from (select x from (values 1, 2) t(x) union all "
        "select y from (values 2.5) u(y)) s order by x",
        [(Decimal("1"),), (Decimal("2"),), (Decimal("2.5"),)]),
    "union_all_strings": (
        "select s, count(*) from (select s from (values 'a', 'b') t(s) union all "
        "select r from (values 'b', 'c') u(r)) v group by s order by s",
        [("a", 1), ("b", 2), ("c", 1)]),
    "distinct": (
        "select distinct g, s from (values (1, 'a'), (1, 'a'), (2, 'b'), "
        "(null, 'b'), (null, 'b')) t(g, s) order by g nulls first, s",
        [(None, "b"), (1, "a"), (2, "b")]),
}


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner(device="cpu")


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("case", sorted(SQL_CASES))
def test_sql_case(port, case, mode):
    sql, want = SQL_CASES[case]
    port.session.set("execution_mode", mode)
    try:
        rows, _ = port.execute(sql)
    finally:
        port.session.set("execution_mode", "local")
    assert rows == want


def test_full_join_on_the_connector(port):
    """A FULL join over tpch.tiny gives the same rows in both modes
    (``test_full_join_distributed_matches_local``), and the Q51-family
    shape, a FULL join of two grouped subqueries, keeps every key of both
    sides (``test_tpcds_q51_shape``)."""
    sql = ("select count(*), count(o_orderkey), count(c_custkey) from "
           "(select * from tpch.tiny.orders where o_custkey < 100) o "
           "full join tpch.tiny.customer on o_custkey = c_custkey")
    q51 = ("select coalesce(a.k, b.k), a.s, b.s from "
           "(select o_orderstatus k, sum(o_totalprice) s from tpch.tiny.orders group by 1) a "
           "full join "
           "(select o_orderpriority k, sum(o_totalprice) s from tpch.tiny.orders group by 1) b "
           "on a.k = b.k order by 1")
    got = {}
    for mode in ("local", "distributed"):
        port.session.set("execution_mode", mode)
        try:
            got[mode] = (port.execute(sql)[0], port.execute(q51)[0])
        finally:
            port.session.set("execution_mode", "local")
    assert got["local"] == got["distributed"]
    (count, orders, customers), = got["local"][0]
    # every order of the subquery has its customer; customers without
    # such an order come once, null-extended
    assert count == customers and 0 < orders < count
    assert len(got["local"][1]) == 8  # 3 statuses and 5 priorities


def test_full_join_with_a_non_equi_filter_raises(port):
    with pytest.raises(ExecutionError, match="FULL OUTER JOIN with a non-equi ON filter"):
        port.execute(
            "select * from (values (1, 2)) a(k, x) full join "
            "(values (1, 3)) b(k, y) on a.k = b.k and a.x < b.y"
        )
