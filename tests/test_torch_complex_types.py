"""ARRAY/MAP/ROW values, UNNEST, array_agg and the scalar functions of the
reference's SQL surface through trino_tpu_torch, against the JAX
reference, on the CPU.

The cases of ``tests/test_array_unnest.py``, ``tests/test_map_row.py``
(but its wire-format cases, which need the page serde and the cluster:
ROADMAP items 7 and 9) and ``tests/test_function_breadth.py``, and the
expressions of ``tests/test_sql_breadth.py`` the port refused before
(NULLIF, month arithmetic, ``round``, math): each SQL text runs through
the reference's ``LocalQueryRunner`` (its interpreter) and the port's on
``device="cpu"`` in both execution modes, and the rows are compared in
canonical form (sorted unless the query orders them), exactly; a DOUBLE
compares within a relative 1e-12 (the two packages' math functions may
round the last place differently). The forms the reference refuses are
refused by both, with the same error class.
"""

import math

import pytest
import torch

from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch.testing import LocalQueryRunner

# one intra-op thread: test processes run side by side (pytest-xdist)
torch.set_num_threads(1)

MODES = ["local", "distributed"]


@pytest.fixture(scope="module")
def ref():
    return RefRunner()


@pytest.fixture(scope="module")
def ports():
    out = {}
    for mode in MODES:
        r = LocalQueryRunner(device="cpu")
        r.session.set("execution_mode", mode)
        out[mode] = r
    return out


def _key(row):
    return tuple(
        (0, "") if v is None else (1, f"{v:.9g}" if isinstance(v, float) else repr(v))
        for v in row
    )


def assert_rows_equal(got, want, ordered=False, rel=1e-12):
    """Rows equal in canonical form: every value exactly, a float within
    ``rel``; row order compared only when the query orders its rows."""
    assert len(got) == len(want), (got[:5], want[:5])
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert math.isclose(a, b, rel_tol=rel, abs_tol=1e-300) or (
                    math.isnan(a) and math.isnan(b)
                ), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


def check(ref, ports, sql, ordered=False):
    want, _ = ref.execute(sql)
    for mode, port in ports.items():
        got, _ = port.execute(sql)
        assert_rows_equal(got, want, ordered)


# --- ARRAY, UNNEST, array_agg (tests/test_array_unnest.py) ------------------

ARRAY_CASES = {
    "cardinality": "select cardinality(array[1, 2, 3]), cardinality(array[])",
    "element_at": "select element_at(array[10, 20, 30], 2), element_at(array[10], 5),"
                  " element_at(array[10, 20], -1)",
    "contains": "select contains(array[1, 2, 3], 2), contains(array[1, 3], 2)",
    "literal_output": "select array[1, 2, null, 4]",
    "null_elements_cardinality": "select cardinality(array[1, null, 3])",
    "bare_unnest": "select x from unnest(array[3, 1, 2]) t(x) order by x",
    "with_ordinality": "select x, o from unnest(array['a', 'b']) with ordinality t(x, o)",
    "lateral_cross_join": "select k, x from (values (1, 'p'), (2, 'q')) v(k, s)"
                          " cross join unnest(array[10, 20]) u(x) order by k, x",
    "unnest_agg_roundtrip": "select x from (select array_agg(o_orderpriority) a from"
                            " (select * from orders limit 50)) cross join unnest(a) u(x)"
                            " group by x order by x",
    "unnest_nulls_pad_zip": "select a, b from unnest(array[1, 2, 3], array[10, 20]) t(a, b)"
                            " order by a",
    "unnest_decimal_date": "select x, d from unnest(array[1.5, null, 2.25],"
                           " array[date '1995-01-01', date '1996-02-29']) t(x, d)",
    "unnest_over_table": "select n_regionkey, x, count(*) from tpch.tiny.nation"
                         " cross join unnest(array[1, 2]) t(x) group by 1, 2",
    "array_agg_global": "select cardinality(array_agg(x)), contains(array_agg(x), 2)"
                        " from (values 3, 1, 2) t(x)",
    "array_agg_grouped": "select k, array_agg(v), count(*), sum(v) from"
                         " (values (1, 10), (1, 20), (2, 30)) t(k, v) group by k order by k",
    "array_agg_nulls": "select array_agg(v) from (values 1, null, 2) t(v)",
    "array_agg_empty_is_null": "select array_agg(v) from (values 1) t(v) where v > 5",
    "array_agg_strings": "select k, array_agg(s) from (values (1, 'a'), (1, 'b')) t(k, s)"
                         " group by k",
    "array_agg_cardinality": "select o_orderstatus, cardinality(array_agg(o_orderkey))"
                             " from orders group by 1 order by 1",
    "array_agg_filter": "select o_orderstatus, cardinality(array_agg(o_orderkey)"
                        " filter (where o_totalprice > 200000)) from orders group by 1",
}


@pytest.mark.parametrize("case", sorted(ARRAY_CASES))
def test_arrays_and_unnest_equal_the_reference(ref, ports, case):
    sql = ARRAY_CASES[case]
    check(ref, ports, sql, ordered="order by" in sql)


def test_unnest_at_scale_repeats_every_row(ports):
    """UNNEST of a literal array over a table: each source row once per
    element, in row order (the chip's 4.5M-row step at tpch.tiny)."""
    for port in ports.values():
        rows, _ = port.execute(
            "select x, count(*), sum(o_totalprice) from tpch.tiny.orders"
            " cross join unnest(array[1, 2, 3]) t(x) group by x order by x"
        )
        total, _ = port.execute("select sum(o_totalprice) from tpch.tiny.orders")
        assert [(x, c) for x, c, _ in rows] == [(1, 15000), (2, 15000), (3, 15000)]
        assert {s for _, _, s in rows} == {total[0][0]}


# --- MAP and ROW (tests/test_map_row.py) ------------------------------------

MAP_ROW_CASES = {
    "map_constructor": "select map(array['a','b'], array[1,2])",
    "map_cardinality": "select cardinality(map(array['a','b','c'], array[1,2,3]))",
    "map_subscript": "select map(array['a','b'], array[1,2])['b'],"
                     " element_at(map(array[10,20], array[5,6]), 20)",
    "map_missing_key": "select element_at(map(array['a'], array[1]), 'zzz')",
    "map_in_expression": "select m['x'] + 1 from (select map(array['x'], array[7]) m) t",
    "row_constructor": "select row(1, 42, 3)",
    "row_subscript": "select row(1, 42, 3)[2]",
    "row_over_table": "select n_nationkey, row(1, 2.5)[2] from tpch.tiny.nation"
                      " where n_nationkey < 3",
}


@pytest.mark.parametrize("case", sorted(MAP_ROW_CASES))
def test_map_and_row_equal_the_reference(ref, ports, case):
    check(ref, ports, MAP_ROW_CASES[case])


# --- scalar functions (tests/test_function_breadth.py, test_sql_breadth.py) -

FUNCTION_CASES = {
    "bitwise": "select bitwise_and(12, 10), bitwise_or(12, 10), bitwise_xor(12, 10),"
               " bitwise_not(0)",
    "shifts": "select bitwise_left_shift(1, 4), bitwise_right_shift(-16, 2),"
              " bitwise_right_shift_arithmetic(-16, 2)",
    "shift_64_or_more": "select bitwise_left_shift(1, 64), bitwise_right_shift(-1, 70),"
                        " bitwise_right_shift_arithmetic(-8, 64)",
    "width_bucket": "select width_bucket(x, 0, 10, 5) from (values -1.0, 0.0, 3.5, 9.99,"
                    " 10.0, 42.0) t(x)",
    "width_bucket_descending": "select width_bucket(x, 10, 0, 5) from (values 11.0,"
                               " 10.0, 7.0, 0.0, -1.0) t(x)",
    "checksum": "select checksum(n_nationkey), checksum(n_name), checksum(n_regionkey * 1.5)"
                " from tpch.tiny.nation",
    "checksum_grouped_nulls": "select k, checksum(v) from (values (1, null), (1, 2),"
                              " (2, null)) t(k, v) group by k",
    "checksum_wide_and_double": "select checksum(cast(o_totalprice as decimal(38, 2))),"
                                " checksum(cast(o_totalprice as double)) from tpch.tiny.orders",
    "corr_family": "select corr(x, y), covar_pop(x, y), covar_samp(x, y),"
                   " regr_slope(y, x), regr_intercept(y, x) from (values (1.0, 2.0),"
                   " (2.0, 4.5), (3.0, 5.5), (4.0, 9.0)) t(x, y)",
    "corr_null_pairs": "select corr(x, y) from (values (1.0, 2.0), (null, 3.0),"
                       " (2.0, 4.0), (3.0, null), (4.0, 8.5)) t(x, y)",
    "variance_family": "select stddev_pop(x), var_pop(x), var_samp(x), stddev(x)"
                       " from (values 2.0, 4.0, 4.0, 4.0, 5.0, 5.0, 7.0, 9.0) t(x)",
    "json": "select json_extract_scalar('{\"a\": {\"b\": 7}}', '$.a.b'),"
            " json_extract_scalar('[1, 2, 3]', '$[1]'),"
            " json_extract('{\"a\": [1, 2]}', '$.a')",
    "format_datetime": "select format_datetime(o_orderdate, 'yyyy-MM'), count(*)"
                       " from tpch.tiny.orders group by 1",
    "date_format": "select date_format(date '1995-03-05', '%Y/%m/%d %W')",
    "format_datetime_in_where": "select count(*) from tpch.tiny.orders"
                                " where format_datetime(o_orderdate, 'yyyy') = '1995'",
    "nested_format_datetime": "select upper(format_datetime(date '1995-03-05', 'MMM'))",
    "nullif": "select nullif(n_regionkey, 2), nullif(1, 1), nullif(2, 1)"
              " from tpch.tiny.nation",
    "nullif_wide_scale": "select nullif(cast(1.50 as decimal(38, 2)), 1.5),"
                         " nullif(cast(o_totalprice as decimal(38, 4)), o_totalprice)"
                         " from tpch.tiny.orders where o_orderkey < 10",
    "month_arithmetic": "select o_orderdate + interval '1' month,"
                        " o_orderdate - interval '13' month from tpch.tiny.orders"
                        " where o_orderkey < 40",
    "date_add_diff": "select date_add('day', 10, date '1995-01-01'),"
                     " date_add('month', 2, date '1995-01-31'),"
                     " date_diff('day', date '1995-01-01', date '1995-03-01'),"
                     " date_diff('month', date '1995-01-15', date '1996-03-01')",
    "round": "select round(1.2345, 2), round(12.5), round(-2.5), round(o_totalprice, -2),"
             " round(o_totalprice * 1.0e0, 1) from tpch.tiny.orders where o_orderkey < 10",
    "math": "select ln(exp(1.0)), log10(100.0), sign(-5), greatest(1, 7, 3),"
            " least(2.5, 1.0), cbrt(27.0), sqrt(2.0), power(2, 10), truncate(2.7)",
    "trig": "select sin(0.5), cos(0.5), tan(0.5), atan2(1.0, 2.0), degrees(1.0),"
            " radians(90.0)",
}


@pytest.mark.parametrize("case", sorted(FUNCTION_CASES))
def test_functions_equal_the_reference(ref, ports, case):
    check(ref, ports, FUNCTION_CASES[case])


# --- refusals the reference keeps ------------------------------------------

REFUSALS = {
    "like_non_literal": "select n_name from tpch.tiny.nation where n_name like n_comment",
    "regexp_non_literal": "select regexp_like(n_name, n_comment) from tpch.tiny.nation",
    "strpos_non_literal": "select strpos(n_name, n_comment) from tpch.tiny.nation",
    "date_trunc_non_literal": "select date_trunc(n_name, date '1995-01-01')"
                              " from tpch.tiny.nation",
    "round_non_literal": "select round(n_nationkey * 1.5, n_regionkey) from tpch.tiny.nation",
    "array_of_columns": "select array[n_nationkey] from tpch.tiny.nation",
    "element_at_varchar_array": "select element_at(array['a', 'b'], 1)",
    "row_subscript_out_of_range": "select row(1, 2)[5]",
    "width_bucket_equal_bounds": "select width_bucket(1.0, 2.0, 2.0, 3)",
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_of_the_reference_stay(ref, ports, case):
    sql = REFUSALS[case]
    with pytest.raises(Exception) as ref_err:
        ref.execute(sql)
    for port in ports.values():
        with pytest.raises(Exception) as err:
            port.execute(sql)
        assert type(err.value).__name__ == type(ref_err.value).__name__
        if str(ref_err.value):  # a bare assert in the reference has none
            assert str(err.value) == str(ref_err.value)


def test_decimal38_downscale_is_refused_as_in_the_reference():
    import jax.numpy as jnp

    from trino_tpu import compiler as RC
    from trino_tpu_torch import compiler as C

    with pytest.raises(NotImplementedError, match="DECIMAL.38. downscale"):
        RC._as_pair128(jnp.zeros(2, dtype=jnp.int64), 4, 2)
    with pytest.raises(NotImplementedError, match="DECIMAL.38. downscale"):
        C._as_pair128(torch.zeros(2, dtype=torch.int64), 4, 2)
