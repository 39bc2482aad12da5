"""The port's parquet, orc and file connectors against the JAX reference's,
through SQL at ``tpch.tiny``, on the CPU.

One statement script a connector kind (the SQL cases of the reference's
``test_parquet.py``, ``test_orc.py``, ``test_file_connector.py`` and
``test_connector_conformance.py``): CTAS, INSERT, scans, aggregates, a
join against tpch, split pruning, DELETE, persistence across engines and
the read-only refusals. The reference runs each script once (its
interpreter); the port runs it in both execution modes, and every
statement's rows (or its refusal) equal the reference's. The reference's
results are committed as a digest of each script's results (~30 s of its
compiles); ``-m slow`` recomputes them and compares statement by
statement. DELETE on the pages-file connector swaps the data through
``replace_data``.
"""

import hashlib

import pytest
import torch

from trino_tpu import predicate as RP
from trino_tpu.connectors.api import register_catalog_spec as ref_register
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import predicate as P
from trino_tpu_torch.connectors.api import register_catalog_spec
from trino_tpu_torch.testing import LocalQueryRunner

torch.set_num_threads(1)

KINDS = {"pq": "parquet", "orc": "orc", "ttp": "file"}

ORDERS = ("select o_orderkey k, o_custkey ck, o_totalprice p, o_orderstatus st,"
          " o_orderdate d, o_comment cm from tpch.tiny.orders")


def script(c: str) -> list[str]:
    return [
        f"create table {c}.default.o as {ORDERS} where o_orderkey < 30000",
        f"select count(*), min(k), max(k), sum(p), min(d), max(st), min(cm) from {c}.default.o",
        f"insert into {c}.default.o {ORDERS} where o_orderkey >= 30000",
        f"select st, count(*), sum(p), max(d) from {c}.default.o group by st order by st",
        f"select count(*), sum(p) from {c}.default.o where k >= 30000 and k < 40000",
        f"select count(*) from {c}.default.o where k < 0",
        f"select c_mktsegment, count(*), sum(p) from {c}.default.o o join tpch.tiny.customer"
        f" on o.ck = c_custkey group by c_mktsegment order by c_mktsegment",
        f"create table {c}.default.n as select * from (values (1, 'a', 2.5),"
        f" (null, null, null), (3, '', -1.0)) t(a, b, f)",
        f"select a, b, f from {c}.default.n order by a nulls first",
        f"delete from {c}.default.o where st = 'F'",
        f"select count(*), sum(p) from {c}.default.o",
        f"show tables from {c}.default",
        f"drop table {c}.default.n",
        f"show tables from {c}.default",
        "create table tpch.tiny.x as select 1 a",
        "insert into tpch.tiny.nation select * from tpch.tiny.nation",
        "delete from tpch.tiny.region",
    ]


def run(runner, statements) -> list:
    out = []
    for sql in statements:
        try:
            rows, _ = runner.execute(sql)
            out.append(("rows", [tuple(r) for r in rows]))
        except Exception as e:  # noqa: BLE001 - a refusal is a result here
            out.append(("error", type(e).__name__))
    return out


# sha256 of repr(run(reference runner, script(name))), by catalog
REFERENCE_DIGESTS = {
    "pq": "9ad9ca1494acf4bb446b0b172186af0cbaa7df2dbfc5851eb4a7c99d5d75cbc7",
    "orc": "9ad9ca1494acf4bb446b0b172186af0cbaa7df2dbfc5851eb4a7c99d5d75cbc7",
    "ttp": "d59842920da8f36ddea215fcbe3ac0230e112dd6c7cb5c4595a0e8dc66e5d62c",
}


def digest(results) -> str:
    return hashlib.sha256(repr(results).encode()).hexdigest()


def reference_results(root) -> dict:
    """The reference's results of each kind's script (one runner)."""
    runner = RefRunner()
    for name, kind in KINDS.items():
        ref_register(runner.engine.catalogs, f"{name}={kind}:{root / name}")
    return {name: run(runner, script(name)) for name in KINDS}


@pytest.mark.slow
def test_committed_digests_equal_the_reference(tmp_path):
    ref = reference_results(tmp_path)
    assert {n: digest(r) for n, r in ref.items()} == REFERENCE_DIGESTS
    for name in KINDS:
        got = port_results(tmp_path / f"port_{name}", name, "local")[0]
        for sql, g, w in zip(script(name), got, ref[name]):
            assert g == w, sql


def port_results(root, name: str, mode: str):
    """The port's results of ``name``'s script and the data-swap calls
    its connector received."""
    runner = LocalQueryRunner(device="cpu")
    runner.session.set("execution_mode", mode)
    register_catalog_spec(runner.engine.catalogs, f"{name}={KINDS[name]}:{root}")
    conn = runner.catalogs.get(name)
    calls = []
    for method in ("replace_data", "truncate"):
        if hasattr(conn, method):
            real = getattr(conn, method)
            setattr(conn, method, (lambda real, method: lambda *a: (
                calls.append(method), real(*a))[1])(real, method))
    return run(runner, script(name)), calls


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("name", list(KINDS))
def test_sql_script_equals_the_reference(tmp_path, name, mode):
    got, calls = port_results(tmp_path, name, mode)
    assert digest(got) == REFERENCE_DIGESTS[name], got
    delete = script(name).index(f"delete from {name}.default.o where st = 'F'")
    if name == "ttp":
        assert got[delete] == ("rows", []) and calls == ["replace_data"]
    else:  # no DELETE on the Parquet and ORC connectors, as in the reference
        assert got[delete] == ("error", "SemanticError") and calls == []


@pytest.mark.parametrize("name", list(KINDS))
def test_split_pruning_counts_equal_the_reference(tmp_path, name):
    """Two inserts, one split each; a range on the key prunes to one."""
    results = []
    for pkg in ("ref", "port"):
        root = tmp_path / pkg
        if pkg == "ref":
            runner, register, pred = RefRunner(), ref_register, RP
        else:
            runner, register, pred = LocalQueryRunner(device="cpu"), register_catalog_spec, P
        register(runner.engine.catalogs, f"{name}={KINDS[name]}:{root}")
        runner.execute(f"create table {name}.default.p as select 1 x, 'a' s")
        runner.execute(f"insert into {name}.default.p select 1000, 'b'")
        conn = runner.engine.catalogs.get(name)
        hit = pred.TupleDomain(
            {"x": pred.Domain(pred.ValueSet([pred.Range(500, True, 2000, True)]))})
        miss = pred.TupleDomain(
            {"x": pred.Domain(pred.ValueSet([pred.Range(5000, True, 6000, True)]))})
        results.append([
            len(conn.get_splits("default", "p", 8)),
            len(conn.get_splits("default", "p", 8, constraint=hit)),
            len(conn.get_splits("default", "p", 8, constraint=miss)),
            runner.execute(f"select count(*), sum(x) from {name}.default.p where x > 500")[0],
        ])
    assert results[0] == results[1]
    assert results[1][:3] == [2, 1, 0]


@pytest.mark.parametrize("name", list(KINDS))
def test_tables_persist_across_engines_and_packages(tmp_path, name):
    """A table the port writes is read by a new port engine and by the
    reference over the same directory, and the port reads the
    reference's."""
    sql = f"select st, count(*), sum(p) from {name}.default.o group by st order by st"
    port = LocalQueryRunner(device="cpu")
    register_catalog_spec(port.engine.catalogs, f"{name}={KINDS[name]}:{tmp_path / 'port'}")
    port.execute(f"create table {name}.default.o as {ORDERS}")
    want, _ = port.execute(sql)
    again = LocalQueryRunner(device="cpu")
    register_catalog_spec(again.engine.catalogs, f"{name}={KINDS[name]}:{tmp_path / 'port'}")
    assert again.execute(sql)[0] == want
    ref = RefRunner()
    ref_register(ref.engine.catalogs, f"{name}={KINDS[name]}:{tmp_path / 'port'}")
    assert [tuple(r) for r in ref.execute(sql)[0]] == want
    ref_register(ref.engine.catalogs, f"w={KINDS[name]}:{tmp_path / 'ref'}")
    ref.execute(f"create table w.default.o as {ORDERS}")
    register_catalog_spec(again.engine.catalogs, f"w={KINDS[name]}:{tmp_path / 'ref'}")
    assert again.execute(sql.replace(f"{name}.default", "w.default"))[0] == want
