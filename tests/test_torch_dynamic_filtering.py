"""Dynamic filtering through trino_tpu_torch, against the reference.

The 17 cases of ``tests/test_dynamic_filtering.py`` (the reference's
``TestCoordinatorDynamicFiltering.java`` and ``DynamicFilterService`` unit
tests), each run through both packages on the same input:

- ``TestDomainFromBuild``: the domain of a build key column and its
  conversion across a coercion equal the reference's, range for range;
- ``TestPushProbeDomain``: the same plan gets the same scan constraint,
  and a null-extended side gets none;
- ``TestEndToEnd``: the interpreter's collected filters (symbol, kind,
  distinct values, build rows), the scans' split pruning and the rows
  equal the reference's; the distributed case on 8 shards in both;
- ``TestFusedDynamicFiltering``: the fragment path on 8 shards, its rows,
  its ``dynamic filters`` count (EXPLAIN ANALYZE and the statement's
  counter) and its split pruning equal the reference's.

A filter that prunes less still gives equal rows, so the domains, the
pruned scans and the counters are what these cases compare.
"""

import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N = 8
# the interpreter's join of the reference's end-to-end cases
JOIN_SQL = ("select count(*) from tpch.tiny.lineitem l "
            "join tpch.tiny.orders o on l.l_orderkey = o.o_orderkey "
            "where o.o_orderkey <= 40")
LEFT_SQL = ("select count(*) from tpch.tiny.customer c "
            "left join tpch.tiny.orders o on c.c_custkey = o.o_custkey "
            "and o.o_orderkey <= 10")
DIST_SQL = ("select o.o_orderpriority, count(*) c from tpch.tiny.lineitem l "
            "join tpch.tiny.orders o on l.l_orderkey = o.o_orderkey "
            "where o.o_orderkey between 100 and 200 "
            "group by o.o_orderpriority")
Q3_SQL = """select l_orderkey, sum(l_extendedprice * (1 - l_discount)),
                o_orderdate, o_shippriority
         from customer, orders, lineitem
         where c_mktsegment = 'BUILDING'
           and c_custkey = o_custkey and l_orderkey = o_orderkey
           and o_orderdate < date '1995-03-15'
           and l_shipdate > date '1995-03-15'
         group by l_orderkey, o_orderdate, o_shippriority
         order by 2 desc, o_orderdate limit 10"""
DISABLED_SQL = ("select count(*) from orders join customer"
                " on o_custkey = c_custkey where c_mktsegment = 'BUILDING'")
EMPTY_SQL = ("select count(*) from lineitem join orders on l_orderkey = o_orderkey"
             " where o_totalprice < 0")


# --- both packages' objects in one comparable form ------------------------------


def dom(d):
    """A Domain of either package: its ranges, whether it is all values,
    NULL admitted, and its type's name."""
    if d is None:
        return None
    ranges = tuple((r.low, r.low_inclusive, r.high, r.high_inclusive)
                   for r in d.values.ranges)
    return ranges, d.values.is_all, d.null_allowed, getattr(d.type, "name", None)


def tuple_dom(td):
    if td is None:
        return None
    if td.domains is None:
        return "none"
    return tuple(sorted((c, dom(d)) for c, d in td.domains.items()))


def filters(ex) -> list:
    """An executor's collected dynamic filters; a symbol without the
    suffix that numbers it in its process (each package counts its own)."""
    return [(re.sub(r"_\d+$", "", f.symbol), f.kind, f.distinct_values, f.build_rows)
            for f in ex.dynamic_filters]


def _modules(port: bool):
    if port:
        from trino_tpu_torch import dynfilter, predicate, types
        from trino_tpu_torch.planner import plan
    else:
        from trino_tpu import dynfilter, predicate, types
        from trino_tpu.planner import plan
    return dynfilter, predicate, types, plan


def both(fn):
    """``fn(dynfilter, predicate, types, plan)`` through the port and the
    reference: ``(port's, reference's)``."""
    return fn(*_modules(True)), fn(*_modules(False))


@pytest.fixture
def pruning(monkeypatch):
    """Every split pruning of both packages' tpch connectors, recorded:
    ``{"port": [...], "ref": [...]}`` of (table, constraint, splits in,
    splits kept), in the order the scans ran."""
    from trino_tpu.connectors.tpch import TpchConnector as RefTpch
    from trino_tpu_torch.connectors.tpch import TpchConnector

    seen = {"port": [], "ref": []}
    for side, cls in (("port", TpchConnector), ("ref", RefTpch)):
        orig = cls.prune_splits

        def spy(self, schema, table, splits, constraint, _orig=orig, _side=side):
            kept = _orig(self, schema, table, splits, constraint)
            seen[_side].append((table, tuple_dom(constraint), len(splits), len(kept)))
            return kept

        monkeypatch.setattr(cls, "prune_splits", spy)
    return seen


def _without_df(session_cls):
    s = session_cls()
    s.set("enable_dynamic_filtering", False)
    return s


# --- TestDomainFromBuild ----------------------------------------------------------


class TestDomainFromBuild:
    def test_discrete(self):
        got, want = both(lambda df, pr, T, P: df.domain_from_build(
            np.array([3, 1, 3, 7]), None, T.BIGINT))
        assert dom(got) == dom(want)
        assert got.values.discrete_values() == [1, 3, 7] and not got.null_allowed

    def test_range_fallback(self):
        got, want = both(lambda df, pr, T, P: df.domain_from_build(
            np.arange(10_000, dtype=np.int64), None, T.BIGINT))
        assert dom(got) == dom(want)
        assert got.values.discrete_values() is None
        assert got.contains(5000) and not got.contains(10_000)

    def test_nulls_excluded(self):
        got, want = both(lambda df, pr, T, P: df.domain_from_build(
            np.array([1, 2, 3]), np.array([True, False, True]), T.BIGINT))
        assert dom(got) == dom(want)
        assert got.values.discrete_values() == [1, 3]

    def test_empty_build_gives_none_domain(self):
        got, want = both(lambda df, pr, T, P: df.domain_from_build(
            np.array([], dtype=np.int64), None, T.BIGINT))
        assert dom(got) == dom(want)
        assert got.is_none() and want.is_none()

    def test_strings_skipped(self):
        got, want = both(lambda df, pr, T, P: df.domain_from_build(
            np.array([1, 2]), None, T.VARCHAR))
        assert got is None and want is None

    def test_convert_decimal_to_bigint(self):
        got, want = both(lambda df, pr, T, P: df.convert_domain(
            pr.Domain.of_values([500, 250], T.decimal(3, 2)), T.decimal(3, 2), T.BIGINT))
        assert dom(got) == dom(want)
        assert got.values.discrete_values() == [5]

    def test_convert_bigint_to_decimal(self):
        got, want = both(lambda df, pr, T, P: df.convert_domain(
            pr.Domain.of_values([5], T.BIGINT), T.BIGINT, T.decimal(10, 2)))
        assert dom(got) == dom(want)
        assert got.values.discrete_values() == [500]

    def test_convert_incompatible_returns_none(self):
        got, want = both(lambda df, pr, T, P: df.convert_domain(
            pr.Domain.of_values([5], T.BIGINT), T.BIGINT, T.DOUBLE))
        assert got is None and want is None


# --- TestPushProbeDomain ----------------------------------------------------------


def _find_scan(n, P):
    if isinstance(n, P.TableScan):
        return n
    for s in n.sources:
        r = _find_scan(s, P)
        if r is not None:
            return r
    return None


class TestPushProbeDomain:
    def test_reaches_scan_through_filter_project(self):
        def push(df, pr, T, P):
            from importlib import import_module

            ir = import_module(P.__name__.split(".")[0] + ".ir")
            sym = P.Symbol("k", T.BIGINT)
            scan = P.TableScan("tpch", "tiny", "orders", [sym], ["o_orderkey"])
            proj = P.Project(scan, [(P.Symbol("k2", T.BIGINT), ir.variable("k", T.BIGINT))])
            out = df.push_probe_domain(proj, P.Symbol("k2", T.BIGINT), pr.Domain.of_values([5]))
            return _find_scan(out, P).constraint

        got, want = both(push)
        assert got is not None and got.domain("o_orderkey").contains(5)
        assert tuple_dom(got) == tuple_dom(want)

    def test_does_not_descend_null_extended_side(self):
        def push(df, pr, T, P):
            sym_l, sym_r = P.Symbol("a", T.BIGINT), P.Symbol("b", T.BIGINT)
            scan_l = P.TableScan("tpch", "tiny", "orders", [sym_l], ["o_orderkey"])
            scan_r = P.TableScan("tpch", "tiny", "customer", [sym_r], ["c_custkey"])
            join = P.Join("LEFT", scan_l, scan_r, [(sym_l, sym_r)])
            out = df.push_probe_domain(join, sym_r, pr.Domain.of_values([5]))
            return out is join, join.right.constraint

        assert both(push) == ((True, None), (True, None))


# --- TestEndToEnd -------------------------------------------------------------------


@pytest.fixture(scope="module")
def locals_():
    from trino_tpu.testing import LocalQueryRunner as RefRunner
    from trino_tpu_torch.testing import LocalQueryRunner

    return LocalQueryRunner(device="cpu"), RefRunner()


def _interpret(runner, sql, session, port: bool):
    """The interpreter over ``sql``: (rows, collected filters)."""
    if port:
        from trino_tpu_torch.exec.local import LocalExecutor

        ex = LocalExecutor(runner.catalogs, session, "cpu")
    else:
        from trino_tpu.exec.local import LocalExecutor

        ex = LocalExecutor(runner.catalogs, session)
    batch, _ = ex.execute(runner.plan(sql))
    return [tuple(r) for r in batch.to_pylist()], filters(ex)


class TestEndToEnd:
    def test_join_collects_filter_and_prunes(self, locals_, pruning):
        port, ref = locals_
        got = _interpret(port, JOIN_SQL, port.session, True)
        want = _interpret(ref, JOIN_SQL, ref.session, False)
        assert got == want
        rows, fs = got
        assert fs and fs[0][0].startswith("l_orderkey") and fs[0][1] == "discrete"
        assert pruning["port"] == pruning["ref"]
        # the probe scan of lineitem carries the pushed domain
        assert any(t == "lineitem" and c not in (None, ()) for t, c, _, _ in pruning["port"])
        from trino_tpu_torch.config import Session

        oracle = port.engine.execute_statement(JOIN_SQL, _without_df(Session)).rows
        assert rows == [tuple(r) for r in oracle]

    def test_disabled_by_session(self, locals_, pruning):
        from trino_tpu.config import Session as RefSession
        from trino_tpu_torch.config import Session

        port, ref = locals_
        got = _interpret(port, JOIN_SQL, _without_df(Session), True)
        want = _interpret(ref, JOIN_SQL, _without_df(RefSession), False)
        assert got == want and got[1] == []
        assert pruning["port"] == pruning["ref"]

    def test_left_join_unaffected(self, locals_, pruning):
        from trino_tpu_torch.config import Session

        port, ref = locals_
        got = _interpret(port, LEFT_SQL, port.session, True)
        want = _interpret(ref, LEFT_SQL, ref.session, False)
        assert got == want
        assert pruning["port"] == pruning["ref"]
        base = port.engine.execute_statement(LEFT_SQL, _without_df(Session)).rows
        assert got[0] == [tuple(r) for r in base]

    def test_distributed_matches_local(self, pruning):
        import jax

        from trino_tpu.testing import DistributedQueryRunner as RefDistributed
        from trino_tpu_torch.testing import DistributedQueryRunner, LocalQueryRunner

        if len(jax.devices()) < N:
            pytest.skip("needs the 8-device virtual mesh")
        port = DistributedQueryRunner(n_devices=N, device="cpu")
        ref = RefDistributed(n_devices=N)
        got = port.engine.execute_statement(DIST_SQL, port.session)
        want = ref.engine.execute_statement(DIST_SQL, ref.session)
        assert sorted(got.rows) == sorted(want.rows)
        assert got.dynamic_filters == want.dynamic_filters
        assert pruning["port"] == pruning["ref"]
        local = LocalQueryRunner(engine=port.engine, device="cpu")
        assert sorted(got.rows) == sorted(local.execute(DIST_SQL)[0])


# --- TestFusedDynamicFiltering ------------------------------------------------------


@pytest.fixture(scope="module")
def fused():
    """The fragment path on 8 shards in both packages."""
    import jax

    from trino_tpu.testing import DistributedQueryRunner as RefDistributed
    from trino_tpu_torch.testing import DistributedQueryRunner

    if len(jax.devices()) < N:
        pytest.skip("needs the 8-device virtual mesh")
    return DistributedQueryRunner(n_devices=N, device="cpu"), RefDistributed(n_devices=N)


def _filters_in_analyze(runner, sql) -> int:
    rows, _ = runner.execute("explain analyze " + sql)
    text = "\n".join(r[0] for r in rows)
    m = re.search(r"dynamic filters: (\d+)", text)
    assert m, text[-400:]
    return int(m.group(1))


class TestFusedDynamicFiltering:
    def test_q3_shape_correct_and_filters_collected(self, fused, locals_, pruning):
        port, ref = fused
        got = port.engine.execute_statement(Q3_SQL, port.session)
        want = ref.engine.execute_statement(Q3_SQL, ref.session)
        assert pruning["port"] == pruning["ref"]
        assert got.rows == want.rows
        assert got.rows == locals_[0].execute(Q3_SQL)[0]
        assert got.dynamic_filters == want.dynamic_filters >= 1
        assert _filters_in_analyze(port, Q3_SQL) == _filters_in_analyze(ref, Q3_SQL) >= 1

    def test_disabled_still_correct(self, fused, locals_, pruning):
        port, ref = fused
        for r in (port, ref):
            r.session.set("enable_dynamic_filtering", False)
        try:
            got = port.engine.execute_statement(DISABLED_SQL, port.session)
            want = ref.engine.execute_statement(DISABLED_SQL, ref.session)
        finally:
            for r in (port, ref):
                r.session.set("enable_dynamic_filtering", True)
        assert pruning["port"] == pruning["ref"]
        assert got.rows == want.rows == locals_[0].execute(DISABLED_SQL)[0]
        assert got.dynamic_filters == want.dynamic_filters == 0

    def test_empty_build_prunes_probe_completely(self, fused, locals_, pruning):
        port, ref = fused
        got = port.engine.execute_statement(EMPTY_SQL, port.session)
        want = ref.engine.execute_statement(EMPTY_SQL, ref.session)
        assert pruning["port"] == pruning["ref"]
        assert got.rows == want.rows == locals_[0].execute(EMPTY_SQL)[0] == [(0,)]
        assert got.dynamic_filters == want.dynamic_filters
