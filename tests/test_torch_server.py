"""The coordinator server and client protocol through trino_tpu_torch.

- the cases of ``tests/test_server.py`` against the port's server on
  ``device="cpu"`` (all but ``TestVerifier``: the verifier is ROADMAP item
  9d), through the port's client and CLI;
- parity: the same statements as raw HTTP to a reference server and a
  port server give the same final JSON documents (ids, URIs, timings and
  messages aside): columns, data, update type and count, error
  classification, and the session, prepared-statement and transaction
  headers;
- ``tests/test_skew.py::TestCountersOverHttp`` on the port's 8-shard mesh;
- ``TrinoTpuServer()`` raises without a GPU; SPMD, the one part of the
  cluster tier (item 9c) not ported, answers 501 naming its item, and
  the cluster tier's other routes (tasks, spool, scaled writes,
  discovery, announcements) answer as the reference server's; a worker
  starts and announces itself to a coordinator; the routes of the repeat
  tiers (history, result cache, SLO sentinel, flight journal) answer as
  the reference server's.

The port's event-loop thread is registered with the repository's lockdep
(``tests/conftest.py`` checks it as it checks the reference's loop).
"""

import json
import re
import time
import urllib.error
import urllib.parse
import urllib.request
from decimal import Decimal

import pytest
import torch

from trino_tpu_torch.client import ClientSession, Connection, QueryFailure, StatementClient

from torch_server_fixtures import port_loop_under_lockdep  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server():
    from trino_tpu_torch.server.http import TrinoTpuServer

    s = TrinoTpuServer(device="cpu").start()
    try:
        yield s
    finally:
        s.stop()


@pytest.fixture()
def conn(server):
    return Connection(server.base_uri)


class TestProtocol:
    def test_simple_query(self, conn):
        rows, names = conn.execute("select 1 as x, 'a' as s")
        assert rows == [(1, "a")]
        assert names == ["x", "s"]

    def test_tpch_aggregation(self, conn):
        rows, names = conn.execute(
            "select o_orderpriority, count(*) c from tpch.tiny.orders "
            "group by o_orderpriority order by o_orderpriority"
        )
        assert len(rows) == 5
        assert sum(r[1] for r in rows) == 15000

    def test_decimal_typed(self, conn):
        rows, _ = conn.execute("select sum(o_totalprice) from tpch.tiny.orders")
        assert isinstance(rows[0][0], Decimal)

    def test_multi_page_results(self, server):
        # > PAGE_ROWS rows forces several nextUri fetches
        client = StatementClient(
            server.base_uri,
            "select o_orderkey from tpch.tiny.orders",
            ClientSession(),
        )
        rows = list(client.rows())
        assert len(rows) == 15000
        assert client.stats["state"] == "FINISHED"

    def test_query_failure_semantic(self, conn):
        with pytest.raises(QueryFailure) as ei:
            conn.execute("select no_such_column from tpch.tiny.orders")
        assert ei.value.error["errorType"] == "USER_ERROR"

    def test_query_failure_syntax(self, conn):
        with pytest.raises(QueryFailure) as ei:
            conn.execute("selectt 1")
        assert ei.value.error["errorName"] in ("SYNTAX_ERROR", "SEMANTIC_ERROR")

    def test_session_properties_via_headers(self, server):
        sess = ClientSession(properties={"join_reordering_strategy": "NONE"})
        rows, _ = Connection(server.base_uri, sess).execute(
            "select count(*) from tpch.tiny.nation n join tpch.tiny.region r "
            "on n.n_regionkey = r.r_regionkey"
        )
        assert rows == [(25,)]

    def test_set_session_roundtrip(self, server):
        sess = ClientSession()
        c = Connection(server.base_uri, sess)
        c.execute("set session join_distribution_type = 'PARTITIONED'")
        # server sent X-Trino-Set-Session; client session carries it now
        assert "join_distribution_type" in sess.properties

    def test_ddl_roundtrip(self, conn):
        conn.session.catalog = "memory"
        conn.session.schema = "default"
        try:
            conn.execute(
                "create table memory.default.t_server as "
                "select 1 as a, 'x' as b union all select 2, 'y'"
            )
            rows, _ = conn.execute("select a, b from memory.default.t_server order by a")
            assert rows == [(1, "x"), (2, "y")]
            conn.execute("insert into memory.default.t_server select 3, 'z'")
            rows, _ = conn.execute("select count(*) from memory.default.t_server")
            assert rows == [(3,)]
        finally:
            conn.execute("drop table if exists memory.default.t_server")

    def test_show_statements(self, conn):
        rows, _ = conn.execute("show catalogs")
        assert ("tpch",) in rows and ("memory",) in rows
        rows, _ = conn.execute("show schemas from tpch")
        assert ("tiny",) in rows
        rows, _ = conn.execute("show tables from tpch.tiny")
        assert ("orders",) in rows
        rows, _ = conn.execute("show columns from tpch.tiny.orders")
        assert any(r[0] == "o_orderkey" for r in rows)

    def test_explain(self, conn):
        rows, _ = conn.execute("explain select count(*) from tpch.tiny.lineitem")
        text = "\n".join(r[0] for r in rows)
        assert "Aggregate" in text and "TableScan" in text
        rows, _ = conn.execute("explain select count(*) from tpch.tiny.orders")
        text = "\n".join(r[0] for r in rows)
        assert "Values" in text

    def test_prepared_statement_and_transaction_headers(self, server):
        sess = ClientSession()
        c = Connection(server.base_uri, sess)
        c.execute("prepare q1 from select ? + 1")
        assert sess.prepared_statements == {"q1": "select ? + 1"}
        assert c.execute("execute q1 using 41")[0] == [(42,)]
        c.execute("deallocate prepare q1")
        assert sess.prepared_statements == {}
        c.execute("start transaction")
        assert sess.transaction_id
        c.execute("rollback")
        assert sess.transaction_id is None


class TestNodeEndpoints:
    def test_info(self, server):
        info = Connection(server.base_uri).server_info()
        assert info["coordinator"] is True

    def test_status_memory(self, server):
        with urllib.request.urlopen(f"{server.base_uri}/v1/status") as r:
            st = json.loads(r.read().decode())
        assert st["memoryInfo"]["totalNodeMemory"] > 0

    def test_query_listing(self, server, conn):
        conn.execute("select 42")
        queries = Connection(server.base_uri).list_queries()
        assert any("42" in q["query"] for q in queries)
        finished = [q for q in queries if q["state"] == "FINISHED"]
        assert finished
        qid = finished[0]["queryId"]
        with urllib.request.urlopen(f"{server.base_uri}/v1/query/{qid}") as r:
            detail = json.loads(r.read().decode())
        assert detail["queryId"] == qid

    def test_timeline_and_runtime_tables(self, server, conn):
        conn.execute("select 7")
        qid = next(q["queryId"] for q in Connection(server.base_uri).list_queries()
                   if q["query"] == "select 7")
        with urllib.request.urlopen(f"{server.base_uri}/v1/query/{qid}/timeline") as r:
            spans = json.loads(r.read().decode())["spans"]
        roots = [s for s in spans if s["parentId"] is None]
        assert [s["name"] for s in roots] == ["query"]
        rows, _ = conn.execute("select node_id, http_uri, coordinator from system.runtime.nodes")
        assert rows == [("coordinator", server.base_uri, True)]
        rows, _ = conn.execute(
            "select value from system.runtime.metrics "
            "where name = 'trino_tpu_queries_total{state=\"FINISHED\"}'")
        assert rows and rows[0][0] >= 1


class TestGracefulShutdown:
    def test_shutdown_drains(self):
        from trino_tpu_torch.server.http import TrinoTpuServer

        s = TrinoTpuServer(device="cpu").start()
        try:
            c = Connection(s.base_uri)
            c.execute("select 1")
            req = urllib.request.Request(
                f"{s.base_uri}/v1/info/state",
                data=b'"SHUTTING_DOWN"',
                method="PUT",
            )
            with urllib.request.urlopen(req) as r:
                assert r.status == 200
            # new queries refused while draining
            deadline = time.time() + 5
            refused = False
            while time.time() < deadline:
                try:
                    c.execute("select 1")
                except Exception:
                    refused = True
                    break
                time.sleep(0.05)
            assert refused
        finally:
            s.stop()


class TestCli:
    def test_execute_aligned(self, server, capsys):
        from trino_tpu_torch.cli import main

        rc = main(
            ["--server", server.base_uri, "--execute",
             "select 1 as a, 'x' as b", "--output-format", "ALIGNED"]
        )
        assert rc == 0
        out = capsys.readouterr().out
        assert "a" in out and "x" in out and "1 row" in out

    def test_execute_csv(self, server, capsys):
        from trino_tpu_torch.cli import main

        rc = main(
            ["--server", server.base_uri, "--execute",
             "select 1, 2 union all select 3, 4", "--output-format", "CSV"]
        )
        assert rc == 0
        out = capsys.readouterr().out.strip().splitlines()
        assert sorted(out) == ["1,2", "3,4"]

    def test_failure_exit_code(self, server, capsys):
        from trino_tpu_torch.cli import main

        rc = main(["--server", server.base_uri, "--execute",
                   "select bogus_col from tpch.tiny.orders"])
        assert rc == 1


class TestWebUi:
    def test_ui_page_served(self, server):
        with urllib.request.urlopen(f"{server.base_uri}/ui") as r:
            body = r.read().decode()
        assert "cluster overview" in body and "/v1/status" in body


# --- parity with the reference's server over raw HTTP -----------------------

# Each scenario runs on a fresh pair of servers, with a fresh client
# state; a statement's case runs its scenario up to that statement. Beside
# each statement, what the reference's document must show: a mutation
# header, an update type, "error", or "pages" (three or more).
PARITY_SCENARIOS = [
    [("select 1", ())],
    [("select o_orderpriority, count(*) c, sum(o_totalprice) p from tpch.tiny.orders "
      "group by o_orderpriority order by o_orderpriority", ())],
    [("select cast(2.50 as decimal(10,2)) d, sum(l_extendedprice) s "
      "from tpch.tiny.lineitem", ())],
    [("select o_orderkey, o_orderdate from tpch.tiny.orders", ("pages",))],
    [("select no_such_column from tpch.tiny.orders", ("error",))],
    [("selectt 1", ("error",))],
    [("set session join_distribution_type = 'PARTITIONED'", ("Set-Session", "SET SESSION")),
     ("create table memory.default.parity_t as select n_nationkey k, n_name n "
      "from tpch.tiny.nation where n_regionkey = 1", ("CREATE TABLE",)),
     ("insert into memory.default.parity_t select 99, 'NINETY-NINE'", ("INSERT",)),
     ("select k, n from memory.default.parity_t order by k", ()),
     ("drop table memory.default.parity_t", ("DROP TABLE",))],
    [("show tables from tpch.tiny", ())],
    [("show columns from tpch.tiny.region", ())],
    [("explain select count(*) from tpch.tiny.lineitem", ())],
    [("prepare p1 from select r_name from tpch.tiny.region where r_regionkey = ?",
      ("Added-Prepare", "PREPARE")),
     ("execute p1 using 3", ()),
     ("deallocate prepare p1", ("Deallocated-Prepare", "DEALLOCATE"))],
    [("start transaction", ("Started-Transaction-Id", "START TRANSACTION")),
     ("insert into memory.default.parity_u select 1", ("INSERT",)),
     ("commit", ("Clear-Transaction-Id", "COMMIT"))],
    [("start transaction", ("Started-Transaction-Id", "START TRANSACTION")),
     ("rollback", ("Clear-Transaction-Id", "ROLLBACK"))],
]
# (scenario, position) of every statement, in order
PARITY_CASES = [(k, j) for k, sc in enumerate(PARITY_SCENARIOS) for j in range(len(sc))]

# the protocol's session-mutation headers (reference Statement*Resource)
MUTATION_HEADERS = ("Set-Session", "Added-Prepare", "Deallocated-Prepare",
                    "Started-Transaction-Id", "Clear-Transaction-Id")


def _raw_statement(base_uri: str, sql: str, state: dict) -> dict:
    """One statement through POST /v1/statement and its nextUri walk as a
    client sends it (session, prepared-statement and transaction headers
    from ``state``, which the responses' headers update). Returns the
    final document: columns, every page's data, update type and count,
    error classification, and the mutation headers seen."""
    headers = {"X-Trino-User": "parity", "X-Trino-Catalog": "tpch",
               "X-Trino-Schema": "tiny"}
    if state["session"]:
        headers["X-Trino-Session"] = ",".join(
            f"{k}={urllib.parse.quote(v)}" for k, v in state["session"].items())
    if state["prepared"]:
        headers["X-Trino-Prepared-Statement"] = ",".join(
            f"{k}={urllib.parse.quote(v)}" for k, v in state["prepared"].items())
    if state["txn"]:
        headers["X-Trino-Transaction-Id"] = state["txn"]
    req = urllib.request.Request(f"{base_uri}/v1/statement", data=sql.encode(),
                                 method="POST", headers=headers)
    final: dict = {"data": [], "headers": {}, "pages": 0}
    while True:
        with urllib.request.urlopen(req, timeout=60) as r:
            doc = json.loads(r.read().decode())
            for h in MUTATION_HEADERS:
                v = r.headers.get(f"X-Trino-{h}")
                if v is not None:
                    final["headers"][h] = v
        for key in ("columns", "updateType", "updateCount"):
            if key in doc:
                final[key] = doc[key]
        if doc.get("error"):
            final["error"] = {k: doc["error"][k]
                              for k in ("errorCode", "errorName", "errorType")}
        if "data" in doc:
            final["data"].extend(doc["data"])
            final["pages"] += 1
        if not doc.get("nextUri"):
            break
        req = urllib.request.Request(doc["nextUri"], headers=headers)
    hs = final["headers"]
    if "Set-Session" in hs:
        k, v = hs["Set-Session"].split("=", 1)
        state["session"][k] = urllib.parse.unquote(v)
    if "Added-Prepare" in hs:
        k, v = hs["Added-Prepare"].split("=", 1)
        state["prepared"][k] = urllib.parse.unquote(v)
    if "Deallocated-Prepare" in hs:
        state["prepared"].pop(hs["Deallocated-Prepare"], None)
    if "Started-Transaction-Id" in hs:
        state["txn"] = hs["Started-Transaction-Id"]
    if "Clear-Transaction-Id" in hs:
        state["txn"] = None
    return final


def _parity_documents(server, make_table, statements) -> list:
    make_table(server.engine)
    state = {"session": {}, "prepared": {}, "txn": None}
    try:
        return [_raw_statement(server.base_uri, sql, state) for sql in statements]
    finally:
        server.stop()


def _parity_pair(statements):
    """The reference server's documents first, then the port's (an open
    transaction holds its engine's write lock: the two engines'
    transactions never interleave)."""
    from trino_tpu.server.http import TrinoTpuServer as RefServer
    from trino_tpu_torch.server.http import TrinoTpuServer

    def ref_table(engine):
        engine.execute_statement("create table memory.default.parity_u (x bigint)",
                                 _ref_session())

    def port_table(engine):
        from trino_tpu_torch.config import Session

        engine.execute_statement("create table memory.default.parity_u (x bigint)", Session())

    ref = _parity_documents(RefServer(server_config=_small_pages("ref")).start(),
                            ref_table, statements)
    port = _parity_documents(
        TrinoTpuServer(device="cpu", server_config=_small_pages("port")).start(),
        port_table, statements)
    return ref, port


def _ref_session():
    from trino_tpu.config import Session

    return Session()


def _small_pages(which):
    """A 64 KiB page budget, so that the 15,000-row result takes several
    pages in both servers."""
    if which == "ref":
        from trino_tpu.config import ServerConfig
    else:
        from trino_tpu_torch.config import ServerConfig
    return ServerConfig(result_page_max_bytes=64 << 10)


def _without_ids(doc: dict, sql: str) -> dict:
    """``doc`` with the process-wide counters taken out: a transaction's
    number, and in EXPLAIN text the planner's symbol numbers."""
    doc = json.loads(json.dumps(doc))
    hs = doc["headers"]
    if "Started-Transaction-Id" in hs:
        hs["Started-Transaction-Id"] = re.sub(r"\d+", "#", hs["Started-Transaction-Id"])
    if sql.startswith("explain"):
        doc["data"] = [[re.sub(r"_\d+(?=[_'])", "_#", row[0])] for row in doc["data"]]
    return doc


def _shows(doc: dict, feature: str) -> bool:
    if feature == "error":
        return bool(doc.get("error"))
    if feature == "pages":
        return doc["pages"] >= 3
    if feature in MUTATION_HEADERS:
        return feature in doc["headers"]
    return doc.get("updateType") == feature


@pytest.mark.parametrize("i", range(len(PARITY_CASES)))
def test_statement_documents_equal_the_reference(i):
    k, j = PARITY_CASES[i]
    sql, features = PARITY_SCENARIOS[k][j]
    ref, port = _parity_pair([q for q, _ in PARITY_SCENARIOS[k][:j + 1]])
    assert _without_ids(port[-1], sql) == _without_ids(ref[-1], sql), sql
    for feature in features:
        assert _shows(ref[-1], feature), (sql, feature)


def test_parity_covers_every_protocol_feature():
    """The features the cases hold the reference's documents to cover
    the protocol."""
    shown = {f for sc in PARITY_SCENARIOS for _, fs in sc for f in fs}
    assert shown >= set(MUTATION_HEADERS) | {"error", "pages"}
    assert shown >= {
        "CREATE TABLE", "INSERT", "DROP TABLE", "SET SESSION", "PREPARE",
        "DEALLOCATE", "START TRANSACTION", "COMMIT", "ROLLBACK"}


# --- exchange counters over HTTP on the port's 8-shard mesh -----------------


class TestCountersOverHttp:
    def test_exchange_stats_in_query_info(self):
        from test_torch_distributed_mesh import JOIN_SQL, _seed_port

        from trino_tpu_torch.engine import Engine
        from trino_tpu_torch.parallel.mesh import make_mesh
        from trino_tpu_torch.server.http import TrinoTpuServer

        engine = Engine(device="cpu")
        engine.mesh = make_mesh(8, engine.device)
        server = TrinoTpuServer(engine=engine).start()
        try:
            _seed_port(server.engine.catalogs, 1 << 12, seed=9)
            sess = ClientSession(properties={
                "execution_mode": "distributed",
                "join_distribution_type": "PARTITIONED",
            })
            rows, _ = Connection(server.base_uri, sess).execute(JOIN_SQL)
            assert rows and rows[0][1] == 1 << 12
            queries = Connection(server.base_uri).list_queries()
            qid = next(q["queryId"] for q in queries if "facts" in q["query"])
            with urllib.request.urlopen(f"{server.base_uri}/v1/query/{qid}") as r:
                detail = json.loads(r.read().decode())
            st = detail["exchangeStats"]
            assert st is not None
            assert st["exchanges"] >= 2
            assert st["shuffle_rows"] > 0
            assert st["padding_ratio"] > 0
            assert "overflow_retries" in st and "hot_keys" in st
            assert st["capacities"]
        finally:
            server.stop()


# --- the device policy and the tiers not ported yet ------------------------


def _announced(coordinator_uri, node_id, deadline_s=30.0) -> bool:
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        _, body = _status(coordinator_uri, "GET", "/v1/node")
        if any(n["nodeId"] == node_id for n in json.loads(body.decode())["nodes"]):
            return True
        time.sleep(0.1)
    return False


def test_server_raises_without_a_gpu(monkeypatch, server):
    """Without a GPU the default device raises; ``spmd=True`` builds the
    SPMD runner (over a group of one process when this one joined none);
    a worker (with its discovery URI) starts on the CPU when asked and
    announces itself to a coordinator."""
    from trino_tpu_torch.server.http import TrinoTpuServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrinoTpuServer()
    spmd = TrinoTpuServer(device="cpu", spmd=True).start()
    try:
        assert spmd.spmd is not None and spmd.engine.spmd is spmd.spmd
        assert spmd.spmd.process_count == 1 and not spmd.spmd.mesh.spans
        assert spmd.engine.spmd_peers() == []
    finally:
        spmd.stop()
    for kwargs in ({"role": "worker", "node_id": "w-plain"},
                   {"role": "worker", "node_id": "w-disc", "discovery_uri": server.base_uri}):
        worker = TrinoTpuServer(device="cpu", **kwargs).start()
        try:
            assert _status(worker.base_uri, "GET", "/v1/info")[0] == 200
            if "discovery_uri" in kwargs:
                assert _announced(server.base_uri, "w-disc")
        finally:
            worker.stop()


def test_main_refuses_cluster_options(server):
    """``main`` refuses incomplete SPMD options (a rendezvous without a
    process count and a rank inside it, or a count or rank without a
    rendezvous) before it joins any group; ``--role worker`` with
    ``--discovery`` starts a worker process that announces itself."""
    import os
    import subprocess
    import sys

    from trino_tpu_torch.server.main import main

    for argv in (["--spmd-coordinator", "127.0.0.1:1"], ["--spmd-procs", "2"],
                 ["--spmd-rank", "1"],
                 ["--spmd-coordinator", "127.0.0.1:1", "--spmd-procs", "2", "--spmd-rank", "2"]):
        with pytest.raises(SystemExit) as exc:
            main(["--device", "cpu", *argv])
        assert exc.value.code == 2, argv
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "trino_tpu_torch.server.main", "--role", "worker",
         "--node-id", "w-main", "--device", "cpu", "--discovery-uri", server.base_uri],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    try:
        assert _announced(server.base_uri, "w-main", deadline_s=120.0), proc.poll()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# the cluster tier's other routes, each with the body a peer sends:
# answered as a reference server answers them
CLUSTER_ROUTES = [
    ("POST", "/v1/task/t1.0.0", b"{}"),
    ("GET", "/v1/task/t1.0.0", None),
    ("GET", "/v1/task/t1.0.0/results/0/0", None),
    ("DELETE", "/v1/task/t1.0.0", None),
    ("POST", "/v1/write?catalog=memory&schema=default&table=nope", b"not a page"),
    ("POST", "/v1/spool/t1.0.0?query=q1&partition=0&seq=0", b"page-bytes"),
    ("GET", "/v1/spool", None),
    ("GET", "/v1/spool/t1.0.0/results/0/0", None),
    ("PUT", "/v1/spool/t1.0.0/complete", b'{"queryId": "q1", "partitions": {"0": 1}}'),
    ("DELETE", "/v1/spool/t1.0.0", None),
    ("PUT", "/v1/announce", b'{"nodeId": "worker-9", "uri": "http://127.0.0.1:9"}'),
    ("DELETE", "/v1/announce/worker-1", None),
    ("PUT", "/v1/discovery", b'{"uri": "http://127.0.0.1:9"}'),
]


def _status(base_uri, method, path, body=b"{}"):
    """One request as a cluster peer sends it: with the internal
    credential when the process has a shared secret (an internal path
    answers 401 before routing otherwise)."""
    from trino_tpu_torch.server import auth

    req = urllib.request.Request(f"{base_uri}{path}", method=method, headers=auth.headers(),
                                 data=body if method in ("POST", "PUT") else None)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def ref_server():
    from trino_tpu.server.http import TrinoTpuServer as RefServer

    s = RefServer().start()
    try:
        yield s
    finally:
        s.stop()


def _doc_keys(status, body):
    try:
        doc = json.loads(body.decode())
    except ValueError:
        return status, None
    return status, sorted(doc) if isinstance(doc, dict) else type(doc).__name__


@pytest.mark.parametrize("method,path,body", CLUSTER_ROUTES)
def test_cluster_routes_answer_as_the_reference(server, ref_server, method, path, body):
    """Each route of the cluster tier answers a coordinator's peer as the
    reference's coordinator does: the same status and the same document
    keys (each module's two servers see the same requests in the same
    order, so their states agree)."""
    got = _doc_keys(*_status(server.base_uri, method, path, body))
    want = _doc_keys(*_status(ref_server.base_uri, method, path, body))
    assert got == want, (method, path)
    assert got[0] != 501


def test_spmd_route_answers_its_two_phases(server, ref_server):
    """``POST /v1/spmd``: a server without SPMD answers 400 as the
    reference's does; a server with it (a group of one process here)
    stages a prepare, skips an aborted slot, runs a committed one, and
    refuses a slot that has passed."""
    from trino_tpu_torch.planner.serde import node_to_json
    from trino_tpu_torch.server.http import TrinoTpuServer
    from trino_tpu_torch.testing import LocalQueryRunner

    got = _status(server.base_uri, "POST", "/v1/spmd", b'{"seq": 0}')
    want = _status(ref_server.base_uri, "POST", "/v1/spmd", b'{"seq": 0}')
    assert got[0] == want[0] == 400
    assert json.loads(got[1].decode()) == json.loads(want[1].decode())

    def post(s, body):
        status, raw = _status(s.base_uri, "POST", "/v1/spmd", json.dumps(body).encode())
        assert status == 200
        return json.loads(raw.decode())

    plan = LocalQueryRunner(device="cpu").plan("select count(*) from tpch.tiny.region")
    s = TrinoTpuServer(device="cpu", spmd=True).start()
    try:
        assert post(s, {"phase": "prepare", "seq": 0}) == {"ready": True, "seq": 0}
        assert post(s, {"phase": "commit", "seq": 0, "go": False}) == {"skipped": True, "seq": 0}
        assert post(s, {"phase": "prepare", "seq": 1, "plan": node_to_json(plan),
                        "session": {"catalog": "tpch", "schema": "tiny"}}) == {
            "ready": True, "seq": 1}
        done = post(s, {"phase": "commit", "seq": 1, "go": True})
        assert done["ok"] is True and done["seq"] == 1
        assert done["stats"]["rank"] == 0 and "exchange" in done["stats"]
        assert "slot already passed" in post(s, {"phase": "prepare", "seq": 1})["error"]
    finally:
        s.stop()


def test_empty_cluster_listings_equal_a_reference_coordinator():
    """``GET /v1/task`` and ``/v1/node`` list nothing, as a reference
    coordinator with no workers does; ``/v1/memory`` reports the own pool.
    (Fresh servers: the module's coordinator has had workers announce.)"""
    from trino_tpu.server.http import TrinoTpuServer as RefServer
    from trino_tpu_torch.server.http import TrinoTpuServer

    server = TrinoTpuServer(device="cpu").start()
    ref = RefServer().start()
    try:
        for path in ("/v1/task", "/v1/node"):
            assert _status(server.base_uri, "GET", path) == _status(ref.base_uri, "GET", path)
        mem = [json.loads(_status(s.base_uri, "GET", "/v1/memory")[1])
               for s in (server, ref)]
        assert mem[0].keys() == mem[1].keys()
        assert mem[0]["clusterMemoryLimitBytes"] == mem[1]["clusterMemoryLimitBytes"]
    finally:
        server.stop()
        ref.stop()


def test_rows_convert_a_column_at_a_time():
    """``Batch.to_pylist`` (every result the server pages) converts the
    plain types a column at a time: each value and its Python type equal
    the value-by-value ``to_python`` of every type, NULLs included (a NULL
    DATE holding a day no calendar has), with a selection mask; VARCHAR
    keeps the value-by-value path."""
    import numpy as np

    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch, batch_from_numpy

    n = 3000
    rng = np.random.default_rng(5)
    types = [T.BOOLEAN, T.TINYINT, T.SMALLINT, T.INTEGER, T.BIGINT, T.REAL, T.DOUBLE,
             T.DecimalType(precision=12, scale=2), T.DecimalType(precision=18, scale=0),
             T.DecimalType(precision=38, scale=6), T.DATE, T.VARCHAR]
    arrays = [rng.random(n) < 0.5, rng.integers(-128, 128, n), rng.integers(-2**15, 2**15, n),
              rng.integers(-2**31, 2**31, n), rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
              rng.random(n).astype(np.float32), rng.standard_normal(n) * 1e6,
              rng.integers(-10**11, 10**11, n), rng.integers(-10**17, 10**17, n),
              rng.integers(-10**17, 10**17, n),
              np.where(rng.random(n) < 0.2, -2**31, rng.integers(0, 20000, n)),
              np.array([f"s{i % 37}" for i in range(n)], dtype=object)]
    valids = [rng.random(n) < 0.9 for _ in types]
    valids[10] = arrays[10] != -2**31
    batch = batch_from_numpy(types, arrays, valids)
    batch = Batch(batch.columns, n, torch.from_numpy(rng.random(n) < 0.7))
    got = batch.to_pylist()
    b = batch.compact()
    cols = []
    for c in b.columns:
        data, valid = c.to_numpy()
        cols.append([c.type.to_python(data[i], c.dictionary) if valid[i] else None
                     for i in range(b.num_rows)])
    want = [tuple(col[i] for col in cols) for i in range(b.num_rows)]
    assert got == want
    assert [[type(v) for v in row] for row in got] == [[type(v) for v in row] for row in want]
    assert any(row[10] is None for row in got) and any(row[7] is None for row in got)


# --- the repeat tiers' routes against a reference server -------------------

REPEAT_SQL = "select n_regionkey, count(*) from tpch.tiny.nation group by n_regionkey"


@pytest.fixture(scope="module")
def repeat_servers(tmp_path_factory):
    """A reference and a port server, each having run ``REPEAT_SQL`` twice
    with the result cache, history in a directory of its own and a flight
    journal: {name: (base_uri, query ids, flight dir)}."""
    from trino_tpu.server.http import TrinoTpuServer as RefServer
    from trino_tpu_torch.server.http import TrinoTpuServer

    out, servers = {}, []
    try:
        for name, make in (("reference", RefServer), ("port", lambda: TrinoTpuServer(device="cpu"))):
            s = make().start()
            servers.append(s)
            root = tmp_path_factory.mktemp(name)
            props = (f"result_cache=true,execution_mode=distributed,"
                     f"history_dir={root / 'history'},flight_dir={root / 'flight'}")
            qids = []
            for _ in range(2):
                client = StatementClient(s.base_uri, REPEAT_SQL, ClientSession(
                    user="u", properties=dict(p.split("=", 1) for p in props.split(","))))
                while client.advance():
                    pass
                qids.append(client.query_id)
            out[name] = (s.base_uri, qids, str(root / "flight"))
        yield out
    finally:
        for s in servers:
            s.stop()


def _get(base, path):
    status, body = _status(base, "GET", path)
    return status, json.loads(body.decode())


def _shape(doc):
    """A document's structure: keys of every dict, lengths of lists."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_shape(v) for v in doc[:1]] + [len(doc)]
    return type(doc).__name__


def _route_answer(route, base, qids, flight_dir):
    if route == "history":
        # the reference's CPU backend reports XLA flops and peaks, and its
        # tests run on 8 devices (exchange sites); this package's CPU runs
        # capture nothing on a mesh of one: those fields aside
        status, doc = _get(base, "/v1/history")
        stores = [st for st in doc["stores"] if st["path"]]
        out = []
        for st in stores:
            ent = st["fingerprints"][0]
            out.append((st["entries"], st["records"], ent["count"],
                        sorted(set(ent) - {"flops", "peak_hbm_bytes"}),
                        sorted(k for k in ent["capacities"] if not k.startswith(
                            ("exch@", "spill@")))))
        return status, out
    if route == "cache":
        status, doc = _get(base, "/v1/cache")
        return status, ({k: doc[k] for k in ("hits", "misses", "evictions", "maintained",
                                             "invalidations", "memoSize")},
                        [(e["rows"], e["hits"], e["maintainable"]) for e in doc["entries"]],
                        sorted(doc))
    if route == "slo":
        status, doc = _get(base, "/v1/slo")
        return status, sorted(doc)
    if route == "flight":
        status, doc = _get(base, f"/v1/query/{qids[0]}/flight")
        return status, [(e["event"], sorted(e)) for e in doc["events"]]
    if route == "flight_by_dir":
        q = urllib.parse.urlencode({"dir": flight_dir})
        status, doc = _get(base, f"/v1/query/{qids[1]}/flight?{q}")
        return status, [e["event"] for e in doc["events"]]
    status, doc = _get(base, "/v1/query/no_such_query/flight")
    return status, sorted(doc)


@pytest.mark.parametrize("route", ["history", "cache", "slo", "flight", "flight_by_dir",
                                   "flight_unknown"])
def test_repeat_tier_routes_answer_as_the_reference(repeat_servers, route):
    """``/v1/history``, ``/v1/cache``, ``/v1/slo`` and
    ``/v1/query/{id}/flight`` after the same two statements: the same
    status, structure and counters as the reference server's."""
    answers = {name: _route_answer(route, *repeat_servers[name]) for name in repeat_servers}
    assert answers["port"] == answers["reference"]
    status, _ = answers["port"]
    assert status == (404 if route == "flight_unknown" else 200)
