"""The statement surface of trino_tpu_torch against the JAX reference, on
the CPU: SHOW, EXPLAIN (ANALYZE), CREATE TABLE (AS), INSERT (with a
column list), DELETE, DROP, transactions, prepared statements, the
blackhole catalog and access control.

Each script of statements (the cases of ``tests/test_sql_breadth.py``'s
``TestStatements`` and ``tests/test_txn_security_failure.py``'s
transaction and access-control classes, and the chip's ``surface`` steps
at ``tpch.tiny``) runs statement by statement through a fresh reference
``LocalQueryRunner`` and a fresh port runner on ``device="cpu"``, in both
execution modes; each statement's rows (in canonical form), update type
and count, or its error class and message must be equal. SHOW CATALOGS
leaves out the reference's ``system`` catalog, which the port does not
have yet (ROADMAP item 6). EXPLAIN prints the same fragmented plan, line
for line; EXPLAIN ANALYZE the same plan nodes, and the query's row count.
"""

import re

import pytest
import torch

from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch.benchmarks.tpch import queries
from trino_tpu_torch.testing import LocalQueryRunner

# one intra-op thread: test processes run side by side (pytest-xdist)
torch.set_num_threads(1)

MODES = ["local", "distributed"]


def port_runner(mode: str) -> LocalQueryRunner:
    r = LocalQueryRunner(device="cpu")
    r.session.set("execution_mode", mode)
    return r


def _key(row):
    return tuple((0, "") if v is None else (1, repr(v)) for v in row)


def outcome(runner, sql):
    """What a statement gave: (rows, update type, count), or its error."""
    try:
        res = runner.engine.execute_statement(sql, runner.session)
    except Exception as e:  # noqa: BLE001 — errors are outcomes here
        return ("error", type(e).__name__, str(e))
    rows = [r for r in res.rows if r != ("system",)] if sql == "show catalogs" else res.rows
    return (sorted(rows, key=_key), res.update_type, res.update_count)


M = "memory.default"
LI = (f"create table {M}.li1 as select l_orderkey, l_partkey, l_quantity,"
      " l_extendedprice, l_discount, l_returnflag, l_linestatus, l_shipdate"
      " from tpch.tiny.lineitem")
Q_LI = (f"select l_returnflag, l_linestatus, count(*), sum(l_quantity),"
        f" sum(l_extendedprice * (1 - l_discount)) from {M}.li1 group by 1, 2")
LATE = "l_shipdate >= date '1998-01-01'"

SCRIPTS = {
    "create_insert_delete": [
        f"drop table if exists {M}.sb_t",
        f"create table {M}.sb_t (a bigint, b varchar)",
        f"insert into {M}.sb_t select 1, 'x' union all select 2, 'y' union all"
        " select 3, null",
        f"delete from {M}.sb_t where a = 2",
        f"select a from {M}.sb_t",
        f"delete from {M}.sb_t where b = 'zzz'",  # NULL-predicate rows stay
        f"select count(*) from {M}.sb_t",
        f"delete from {M}.sb_t",
        f"select count(*) from {M}.sb_t",
        f"drop table {M}.sb_t",
        f"select * from {M}.sb_t",
    ],
    "create_variants": [
        f"create table {M}.cv (a bigint)",
        f"create table if not exists {M}.cv (a bigint)",
        f"create table {M}.cv (a bigint)",
        "drop table if exists memory.default.nope",
        "drop table memory.default.nope",
        f"insert into {M}.nope select 1",
        f"insert into {M}.cv select 1, 2",
    ],
    "insert_column_list": [
        f"create table {M}.ic (a bigint, b varchar, c date, d decimal(12, 2))",
        f"insert into {M}.ic (c, a) select date '1995-01-01', 5",
        f"select * from {M}.ic",
        f"insert into {M}.ic (a, b, c, d) values (8, 'x', date '1997-01-01', 1.25)",
        f"insert into {M}.ic (d, a, c) values (2.50, 9, null)",
        f"insert into {M}.ic (b, a, c, d) select 'z', 10, null, null",
        f"select count(c), sum(d), sum(a) from {M}.ic",
        f"insert into {M}.ic (a) select 1, 2",
    ],
    "ctas_writes_and_warm_repeats": [
        LI,
        Q_LI,
        Q_LI,
        f"insert into {M}.li1 select l_orderkey, l_partkey, l_quantity,"
        " l_extendedprice, l_discount, l_returnflag, l_linestatus, l_shipdate"
        f" from tpch.tiny.lineitem where {LATE}",
        Q_LI,
        f"delete from {M}.li1 where {LATE}",
        Q_LI,
        f"select l_linestatus, sum(l_quantity), count(*) from {M}.li1 group by 1",
    ],
    "transactions_on_a_ctas_table": [
        LI,
        f"select count(*) from {M}.li1",
        "start transaction",
        f"insert into {M}.li1 select * from {M}.li1 where {LATE}",
        f"select count(*) from {M}.li1",
        "rollback",
        f"select count(*), sum(l_quantity) from {M}.li1",
        "start transaction",
        f"drop table {M}.li1",
        f"select count(*) from {M}.li1",
        "rollback",
        f"select count(*), sum(l_quantity) from {M}.li1",
        "start transaction",
        f"insert into {M}.li1 select * from {M}.li1 where l_orderkey < 100",
        "commit",
        f"select count(*), sum(l_quantity) from {M}.li1",
    ],
    "join_after_insert_doubles_its_input": [
        # the plan's grown capacities are kept by plan fingerprint, which a
        # write does not change: the overflow ladder must stay exact
        f"create table {M}.o1 as select o_orderkey, o_custkey, o_orderstatus"
        " from tpch.tiny.orders",
        f"select count(*) from {M}.o1 a join {M}.o1 b on a.o_orderkey = b.o_orderkey",
        f"insert into {M}.o1 select * from {M}.o1",
        f"select count(*) from {M}.o1 a join {M}.o1 b on a.o_orderkey = b.o_orderkey",
    ],
    "txn_rollback_restores_data": [
        f"create table {M}.txn_t (a bigint)",
        f"insert into {M}.txn_t select 1",
        "start transaction",
        f"insert into {M}.txn_t select 2",
        f"select count(*) from {M}.txn_t",
        "rollback",
        f"select count(*) from {M}.txn_t",
    ],
    "txn_commit_keeps_data": [
        f"create table {M}.txn_c (a bigint)",
        "start transaction",
        f"insert into {M}.txn_c select 42",
        "commit",
        f"select a from {M}.txn_c",
    ],
    "txn_rollback_restores_dropped_table": [
        f"create table {M}.txn_d (a bigint)",
        f"insert into {M}.txn_d select 7",
        "start transaction",
        f"drop table {M}.txn_d",
        "rollback",
        f"select a from {M}.txn_d",
    ],
    "txn_errors": [
        "commit",
        "rollback",
        "start transaction",
        "start transaction",
        "create table blackhole.default.bt (a bigint)",
        "rollback",
    ],
    "prepared_roundtrip": [
        "prepare pn from select n_name from tpch.tiny.nation where n_nationkey = ?",
        "execute pn using 7",
        "execute pn",
        "deallocate prepare pn",
        "execute pn using 1",
    ],
    "prepared_q6": [
        "prepare q6 from select sum(l_extendedprice * l_discount) as revenue"
        " from tpch.tiny.lineitem where l_shipdate >= ? and l_shipdate < ?"
        " and l_discount between ? and ? and l_quantity < ?",
        "execute q6 using date '1994-01-01', date '1995-01-01', 0.05, 0.07, 24",
        "deallocate prepare q6",
    ],
    "blackhole": [
        "create table blackhole.default.bh (a bigint, b varchar)",
        "insert into blackhole.default.bh select n_nationkey, n_name from tpch.tiny.nation",
        "select count(*) from blackhole.default.bh",
        "show tables from blackhole.default",
    ],
    "show": [
        "show catalogs",
        "show schemas from tpch",
        "show tables from tpch.tiny",
        "show columns from tpch.tiny.lineitem",
        "show columns from tpch.tiny.nope",
        f"create table {M}.shown (a bigint)",
        "show schemas from memory",
        "show tables from memory.default",
        f"show columns from {M}.shown",
    ],
    "scaled_writers": [
        f"create table {M}.sw (a bigint)",
        "set session scaled_writers = true",
        f"insert into {M}.sw select 1",
    ],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_statement_scripts_equal_the_reference(script):
    # one engine after the other: an open transaction holds its engine's
    # write lock, and interleaving two engines' transactions would order
    # their locks both ways
    ref = RefRunner()
    wants = [outcome(ref, sql) for sql in SCRIPTS[script]]
    for mode in MODES:
        port = port_runner(mode)
        for sql, want in zip(SCRIPTS[script], wants):
            got = outcome(port, sql)
            # scaled_writers without a cluster write locally, as the
            # reference's do
            assert got == want, (mode, sql, got, want)


EXPLAIN = {
    "q3": queries("tpch.tiny")[3],
    "q6": queries("tpch.tiny")[6],
    "rollup_join": "select o_orderpriority, l_returnflag, count(*),"
                   " count(*) filter (where l_discount > 0.05), max(o_clerk)"
                   " from tpch.tiny.lineitem join tpch.tiny.orders on l_orderkey = o_orderkey"
                   " group by rollup(o_orderpriority, l_returnflag)",
    "unnest": "select x, count(*) from tpch.tiny.orders cross join unnest(array[1, 2, 3]) t(x)"
              " group by x",
}


def _symbols(rows):
    """Plan lines with the planner's symbol counters (``_123``) masked:
    the counters are process-global, so they depend on what ran before."""
    return [re.sub(r"_\d+", "_#", line) for (line,) in rows]


@pytest.mark.parametrize("case", sorted(EXPLAIN))
def test_explain_prints_the_reference_plan(case):
    sql = EXPLAIN[case]
    want, _ = RefRunner().execute(f"explain {sql}")
    for mode in MODES:
        got, names = port_runner(mode).execute(f"explain {sql}")
        assert names == ["Query Plan"]
        assert len(got) == len(want) > 5
        assert _symbols(got) == _symbols(want)


def _plan_lines(rows):
    """The plan section of EXPLAIN ANALYZE, the per-node stats cut off."""
    lines = []
    for (line,) in rows:
        if not line.strip():
            break
        lines.append(re.sub(r"\s+\[wall: .*\]$", "", line))
    return _symbols([(x,) for x in lines])


@pytest.mark.parametrize("mode", MODES)
def test_explain_analyze(mode):
    sql = EXPLAIN["q3"]
    ref_rows, _ = RefRunner().execute(f"explain analyze {sql}")
    port = port_runner(mode)
    rows, names = port.execute(f"explain analyze {sql}")
    n_rows = len(port.execute(sql)[0])
    text = [r[0] for r in rows]
    assert names == ["Query Plan"]
    assert _plan_lines(rows) == _plan_lines(ref_rows)
    assert f"output rows: {n_rows}" in text
    assert f"output rows: {n_rows}" in [r[0] for r in ref_rows]
    for key in ("peak memory: ", "dynamic filters: ", "wall time: "):
        assert any(line.startswith(key) for line in text)
    if mode == "local":  # the nodes the interpreter ran are timed
        timed = ["[wall: " in line for line in _raw_plan(rows)]
        assert timed == ["[wall: " in line for line in _raw_plan(ref_rows)]
        assert sum(timed) > 5
    else:  # one record a fragment, and the capacity sites
        assert "Fragments (fused single-program execution):" in text
        assert "Capacity sites (final value, provenance):" in text


def _raw_plan(rows):
    out = []
    for (line,) in rows:
        if not line.strip():
            break
        out.append(line)
    return out


def test_insert_column_list_null_fills_strings():
    """A VARCHAR left out of an INSERT's column list is NULL, also when a
    later scan concatenates the table's parts (the reference fails that
    scan: ROADMAP, "Reference quirks")."""
    for mode in MODES:
        port = port_runner(mode)
        port.execute(f"create table {M}.ns (a bigint, b varchar)")
        port.execute(f"insert into {M}.ns (a) select 5")
        port.execute(f"insert into {M}.ns select 7, 'y'")
        port.execute(f"insert into {M}.ns (a) values (9)")
        rows, _ = port.execute(f"select * from {M}.ns")
        assert sorted(rows) == [(5, None), (7, "y"), (9, None)]


# --- access control (tests/test_txn_security_failure.py) --------------------


def _with_rules(runner, module, rules):
    runner.engine.access_control.add(module.FileBasedAccessControl({"catalogs": rules}))
    return runner


ACL_CASES = {
    "deny_select": (
        [{"user": "admin", "catalog": ".*", "allow": "all"}],
        [("bob", "select count(*) from tpch.tiny.nation"),
         ("admin", "select count(*) from tpch.tiny.nation"),
         ("bob", "show catalogs"),
         ("admin", "show catalogs")],
    ),
    "read_only_catalog": (
        [{"user": ".*", "catalog": "memory", "allow": "read-only"},
         {"user": ".*", "catalog": ".*", "allow": "all"}],
        [("user", "create table memory.default.denied (a bigint)"),
         ("user", "create table memory.default.denied as select 1 a"),
         ("user", "select count(*) from tpch.tiny.region")],
    ),
    "default_allows_all": (
        [],
        [("user", "select count(*) from tpch.tiny.region"),
         ("user", "create table memory.default.ok_t (a bigint)"),
         ("user", "insert into memory.default.ok_t select 1"),
         ("user", "delete from memory.default.ok_t"),
         ("user", "drop table memory.default.ok_t")],
    ),
}


@pytest.mark.parametrize("case", sorted(ACL_CASES))
def test_access_control_equals_the_reference(case):
    from trino_tpu import security as RS
    from trino_tpu_torch import security as S

    rules, steps = ACL_CASES[case]
    ref, port = RefRunner(), port_runner("local")
    if rules:
        _with_rules(ref, RS, rules)
        _with_rules(port, S, rules)
    for user, sql in steps:
        ref.session.user = port.session.user = user
        assert outcome(port, sql) == outcome(ref, sql), (user, sql)


def test_filter_catalogs():
    from trino_tpu_torch.security import AccessControlManager, FileBasedAccessControl

    ac = AccessControlManager()
    ac.add(FileBasedAccessControl(
        {"catalogs": [{"user": "u", "catalog": "tpch", "allow": "all"}]}
    ))
    assert ac.filter_catalogs("u", ["tpch", "memory"]) == ["tpch"]
    assert ac.generation == 1


# --- the memory connector's write surface ----------------------------------


def test_memory_connector_versions_follow_every_write():
    """Every write bumps the connector's data version (the device table
    cache's key) and drops its staged device slabs, ROLLBACK's restore
    included, and every read after it sees the write, as the reference's
    connector does."""
    from trino_tpu.connectors.memory import MemoryConnector as RefMemory
    from trino_tpu_torch.connectors.memory import MemoryConnector

    steps = (None, f"insert into {M}.v select 100", "start transaction",
             f"insert into {M}.v select 1000", "rollback",
             f"delete from {M}.v where a >= 100")
    q = f"select count(*), sum(a) from {M}.v"

    def walk(r, conn, kind):
        r.session.set("table_cache", True)
        r.execute(f"create table {M}.v (a bigint)")
        r.execute(f"insert into {M}.v select n_nationkey from tpch.tiny.nation")
        assert isinstance(conn, kind)
        assert conn.list_schemas() == ["default"] and conn.list_tables("default") == ["v"]
        seen = []
        for step in steps:
            version = conn._version
            if step is not None:
                r.execute(step)
                if step != "start transaction":
                    assert conn._version > version
                    assert not getattr(conn, "_device", {})
            seen.append(r.execute(q)[0])
        return seen

    port, ref = port_runner("distributed"), RefRunner()
    got = walk(port, port.catalogs.get("memory"), MemoryConnector)
    want = walk(ref, ref.catalogs.get("memory"), RefMemory)
    assert got == want
    assert got == [
        [(25, 300)], [(26, 400)], [(26, 400)], [(27, 1400)], [(26, 400)], [(25, 300)]
    ]
