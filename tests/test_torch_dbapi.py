"""DB-API 2.0 module tests against trino_tpu_torch (reference tier:
client/trino-jdbc).

The cases of ``tests/test_dbapi.py`` with the port's ``dbapi`` against the
port's server (``device="cpu"``), and the rows, descriptions and row
counts of the port's stack equal to the reference's ``dbapi`` against the
reference's server for the same statements.
"""

from decimal import Decimal

import pytest

import torch

from trino_tpu_torch import dbapi
from trino_tpu_torch.server.http import TrinoTpuServer

from torch_server_fixtures import port_loop_under_lockdep  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server():
    srv = TrinoTpuServer(port=0, device="cpu")
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


@pytest.fixture()
def conn(server):
    c = dbapi.connect(base_uri=f"http://127.0.0.1:{server.port}", catalog="tpch", schema="tiny")
    yield c
    c.close()


def test_module_globals():
    assert dbapi.apilevel == "2.0"
    assert dbapi.paramstyle == "qmark"
    assert issubclass(dbapi.ProgrammingError, dbapi.DatabaseError)
    assert issubclass(dbapi.DatabaseError, dbapi.Error)


def test_basic_select(conn):
    cur = conn.cursor()
    cur.execute("select 1 + 1")
    assert cur.fetchall() == [(2,)]
    assert cur.description[0][1] in ("bigint", "integer")


def test_fetch_variants(conn):
    cur = conn.cursor()
    cur.execute("select x from (values 1, 2, 3, 4, 5) v(x) order by x")
    assert cur.fetchone() == (1,)
    assert cur.fetchmany(2) == [(2,), (3,)]
    assert cur.fetchall() == [(4,), (5,)]
    assert cur.fetchone() is None


def test_qmark_binding(conn):
    cur = conn.cursor()
    cur.execute(
        "select ? + x, ? from (values 1) v(x)", (41, "it''s?")
    )
    row = cur.fetchone()
    assert row[0] == 42
    assert row[1] == "it''s?"


def test_binding_inside_literal_untouched(conn):
    cur = conn.cursor()
    cur.execute("select 'a?b', ? from (values 1) v(x)", (7,))
    assert cur.fetchone() == ("a?b", 7)


def test_param_count_mismatch(conn):
    cur = conn.cursor()
    with pytest.raises(dbapi.ProgrammingError):
        cur.execute("select ?", (1, 2))


def test_decimal_roundtrip(conn):
    cur = conn.cursor()
    cur.execute("select ?", (Decimal("12.34"),))
    assert cur.fetchone() == (Decimal("12.34"),)


def test_error_maps_to_database_error(conn):
    cur = conn.cursor()
    with pytest.raises(dbapi.DatabaseError):
        cur.execute("select definitely_not_a_column from lineitem")
        cur.fetchall()


def test_ddl_rowcount_and_txn(server):
    with dbapi.connect(
        base_uri=f"http://127.0.0.1:{server.port}", catalog="memory", schema="default"
    ) as conn:
        cur = conn.cursor()
        cur.execute("create table dbapi_t (x bigint)")
        cur.execute("insert into dbapi_t values 1")
        assert cur.rowcount == 1
        cur.execute("insert into dbapi_t values 2")
        cur.execute("select count(*) from dbapi_t")
        assert cur.fetchone() == (2,)
        cur.execute("drop table dbapi_t")


def test_cursor_iteration(conn):
    cur = conn.cursor()
    cur.execute("select x from (values 10, 20) v(x) order by x")
    assert [r for r in cur] == [(10,), (20,)]


def test_closed_cursor_raises(conn):
    cur = conn.cursor()
    cur.close()
    with pytest.raises(dbapi.InterfaceError):
        cur.execute("select 1")


# --- the port's stack against the reference's ------------------------------

PARITY_CASES = [
    ("select 1 + 1", ()),
    ("select x from (values 1, 2, 3, 4, 5) v(x) order by x", ()),
    ("select ? + x, ? from (values 1) v(x)", (41, "it''s?")),
    ("select 'a?b', ? from (values 1) v(x)", (7,)),
    ("select ?", (Decimal("12.34"),)),
    ("select n_name, n_regionkey from nation where n_nationkey < ? order by n_name", (9,)),
    ("select r_name, count(*), sum(n_nationkey) from nation join region "
     "on n_regionkey = r_regionkey group by r_name order by r_name", ()),
]
DDL = [
    "create table dbapi_p (x bigint, s varchar)",
    "insert into dbapi_p values (1, 'a'), (2, 'b')",
    "insert into dbapi_p select n_nationkey, n_name from tpch.tiny.nation",
    "select count(*), sum(x) from dbapi_p",
    "drop table dbapi_p",
]


def _run_stack(module, base_uri):
    out = []
    with module.connect(base_uri=base_uri, catalog="tpch", schema="tiny") as conn:
        cur = conn.cursor()
        for sql, params in PARITY_CASES:
            cur.execute(sql, params)
            out.append((cur.fetchall(), cur.description))
    with module.connect(base_uri=base_uri, catalog="memory", schema="default") as conn:
        cur = conn.cursor()
        for sql in DDL:
            cur.execute(sql)
            out.append((cur.fetchall() if cur.description else None, cur.rowcount))
    return out


def test_rows_equal_the_reference_stack(server):
    from trino_tpu import dbapi as ref_dbapi
    from trino_tpu.server.http import TrinoTpuServer as RefServer

    ref = RefServer(port=0).start()
    try:
        want = _run_stack(ref_dbapi, ref.base_uri)
    finally:
        ref.stop()
    got = _run_stack(dbapi, server.base_uri)
    assert got == want
