"""The query-history store through trino_tpu_torch, against the reference.

The cases of ``tests/test_history.py``:

- durability, LRU and provenance: the same ``record`` sequence through
  both packages' stores leaves equal store files (the wall-clock
  ``last_ts`` pinned) and equal counters;
- seeding, with this package's premise: its first capacities are sized
  from the data, so a cold run need not overflow (the reference's test
  asserts that it does). A fresh engine sharing only the ``history_dir``
  repeats the query with ``history_seeds`` >= 1, ``history`` provenance,
  no retry and no halving, rows equal to the reference's and to a
  ``query_history=false`` run, and the store's capacity keys equal the
  reference store's keys for the same query on 8 shards;
- the admission gate (``TestAdmission``) and the query manager's
  retained-history knob (``TestManagerKnobs``).
"""

import json
import threading
import types

import numpy as np
import pytest
import torch

from trino_tpu.obs import history as ref_history
from trino_tpu_torch.config import Session
from trino_tpu_torch.obs import history as port_history
from trino_tpu_torch.obs.history import HistoryHbmRejected, QueryHistoryStore

torch.set_num_threads(1)

MODULES = {"reference": ref_history, "port": port_history}


def _obs(**kw):
    base = {"elapsed_ms": 10.0, "rows": 4}
    base.update(kw)
    return base


@pytest.fixture
def pinned_clock(monkeypatch):
    """Both stores stamp ``last_ts`` with the same instant, so their files
    (and the byte bound, which counts the file) compare equal."""
    clock = types.SimpleNamespace(time=lambda: 1_700_000_000.25)
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "time", clock)


def _stores(tmp_path, name, n=1, **kw):
    path = str(tmp_path / name / "query_history.json")
    (tmp_path / name).mkdir(exist_ok=True)
    return path, [MODULES[name].QueryHistoryStore(path, **kw) for _ in range(n)]


def _doc(path):
    with open(path) as f:
        return json.load(f)


def _restart(store_mod, path):
    s2 = store_mod.QueryHistoryStore(path)
    ent = s2.get("fp-a")
    return [ent["count"], ent["max_overflow_retries"], ent["capacities"]]


SEQUENCES = {
    "restart_survival": lambda s: [
        s[0].record("fp-a", _obs(overflow_retries=2, capacities={
            "agg@1#0": {"value": 256, "provenance": "seeded+grown"}})),
        s[0].record("fp-a", _obs(elapsed_ms=20.0)),
    ],
    "sequential_writers_merge": lambda s: [
        s[0].record("fp-a", _obs()), s[1].record("fp-b", _obs()),
        s[0].record("fp-a", _obs()),
    ],
    "halved_provenance_overwrites_capacity": lambda s: [
        s[0].record("fp", _obs(capacities={
            "join@2#0": {"value": 4096, "provenance": "seeded+grown"}})),
        s[0].record("fp", _obs(capacities={
            "join@2#0": {"value": 1024, "provenance": "seeded"}})),
        s[0].record("fp", _obs(capacities={
            "join@2#0": {"value": 512, "provenance": "seeded+halved"}})),
    ],
    "entries_percentiles_and_order": lambda s: [
        *(s[0].record("fp-a", _obs(elapsed_ms=el)) for el in (10.0, 20.0, 30.0, 40.0)),
        s[0].record("fp-b", _obs(elapsed_ms=5.0)),
    ],
    "operators_and_peaks": lambda s: [
        s[0].record("fp", _obs(peak_hbm_bytes=1 << 20, batch_size=4, operators={
            "agg@1#0": {"kind": "partial-agg", "rows_in": 100, "rows_out": 10}})),
        s[0].record("fp", _obs(peak_hbm_bytes=1 << 19, operators={
            "agg@1#0": {"kind": "partial-agg", "rows_in": 100, "rows_out": 30}})),
    ],
}


class TestDurability:
    @pytest.mark.parametrize("seq", sorted(SEQUENCES))
    def test_store_files_equal_the_reference(self, tmp_path, pinned_clock, seq):
        out = {}
        for name, mod in MODULES.items():
            path, stores = _stores(tmp_path, name, n=2)
            SEQUENCES[seq](stores)
            fresh = mod.QueryHistoryStore(path)
            out[name] = (_doc(path), fresh.entries(),
                         [(s.records, s.evictions, s.corrupt_recovered) for s in stores])
        assert out["port"] == out["reference"]
        if seq == "restart_survival":
            path = str(tmp_path / "port" / "query_history.json")
            assert _restart(port_history, path) == [
                2, 2, {"agg@1#0": {"value": 256, "provenance": "seeded+grown"}}]
        if seq == "halved_provenance_overwrites_capacity":
            ent = dict(out["port"][1])["fp"]
            assert ent["capacities"]["join@2#0"]["value"] == 512
        if seq == "entries_percentiles_and_order":
            rows = out["port"][1]
            assert rows[0][0] == "fp-b" and dict(rows)["fp-a"]["elapsed_p50_ms"] == 30.0

    @pytest.mark.parametrize("text", [
        '{"version": 1, "entries": {"fp": {truncated',
        json.dumps({"version": 999, "entries": {"fp": {}}}),
    ])
    def test_corrupt_file_starts_fresh_and_counts(self, tmp_path, pinned_clock, text):
        from trino_tpu_torch.obs.metrics import get_registry

        docs = {}
        for name, mod in MODULES.items():
            (tmp_path / name).mkdir()
            path = str(tmp_path / name / "query_history.json")
            with open(path, "w") as f:
                f.write(text)
            before = get_registry().snapshot()["counters"].get(
                "trino_tpu_history_corrupt_recovered_total", 0)
            store = mod.QueryHistoryStore(path)
            assert store.corrupt_recovered == 1 and store.get("fp") is None
            if name == "port":
                after = get_registry().snapshot()["counters"].get(
                    "trino_tpu_history_corrupt_recovered_total", 0)
                assert after == before + 1
            store.record("fp-new", _obs())
            assert store.get("fp-new")["count"] == 1
            docs[name] = _doc(path)
        assert docs["port"] == docs["reference"]

    def test_concurrent_writers_never_tear(self, tmp_path):
        path = str(tmp_path / "query_history.json")
        stores = [QueryHistoryStore(path) for _ in range(3)]
        errs: list = []
        tears: list = []
        stop = threading.Event()

        def writer(i):
            try:
                for r in range(20):
                    stores[i].record(f"fp-{i}", _obs(elapsed_ms=float(r)))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        def reader():
            while not stop.is_set():
                try:
                    with open(path) as f:
                        assert isinstance(json.load(f).get("entries"), dict)
                except FileNotFoundError:
                    pass
                except Exception as e:  # noqa: BLE001
                    tears.append(e)

        ts = [threading.Thread(target=writer, args=(i,)) for i in range(3)]
        rt = threading.Thread(target=reader)
        rt.start()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        stop.set()
        rt.join()
        assert not errs and not tears
        final = QueryHistoryStore(path)
        for i in range(3):
            assert final.get(f"fp-{i}") is not None

    def test_lru_entry_bound(self):
        out = {}
        for name, mod in MODULES.items():
            store = mod.QueryHistoryStore(max_entries=4)
            for i in range(7):
                store.record(f"fp-{i}", _obs())
            out[name] = (store.snapshot()["entries"], store.evictions,
                         store.get("fp-0"), store.get("fp-6") is not None)
        assert out["port"] == out["reference"] == (4, 3, None, True)

    def test_lru_byte_bound(self, tmp_path, pinned_clock):
        import os

        caps = {f"agg@{i}#0": {"value": 1 << 16, "provenance": "seeded+grown"}
                for i in range(30)}
        out = {}
        for name, mod in MODULES.items():
            (tmp_path / name).mkdir()
            path = str(tmp_path / name / "query_history.json")
            store = mod.QueryHistoryStore(path, max_entries=1000, max_bytes=4096)
            for i in range(12):
                store.record(f"fp-{i}", _obs(capacities=caps))
            assert store.evictions > 0 and store.snapshot()["bytes"] <= 4096
            assert os.path.getsize(path) <= 4096 and store.get("fp-11") is not None
            out[name] = (store.evictions, _doc(path))
        assert out["port"] == out["reference"]

    def test_get_touch_protects_from_eviction(self):
        out = {}
        for name, mod in MODULES.items():
            store = mod.QueryHistoryStore(max_entries=2)
            store.record("fp-a", _obs())
            store.record("fp-b", _obs())
            store.get("fp-a")
            store.record("fp-c", _obs())
            peek = mod.QueryHistoryStore(max_entries=2)
            peek.record("fp-a", _obs())
            peek.record("fp-b", _obs())
            peek.get("fp-a", touch=False)  # an admission peek keeps nothing alive
            peek.record("fp-c", _obs())
            out[name] = (store.get("fp-a") is not None, store.get("fp-b"),
                         peek.get("fp-a"))
        assert out["port"] == out["reference"] == (True, None, None)


# --- seeding ---------------------------------------------------------------

N_ROWS = 1 << 14
JOIN_SQL = ("select sum(f.v * d.name) as chk, count(*) as c "
            "from memory.default.facts f "
            "join memory.default.dims d on f.k = d.k")


def _seed_skewed(catalogs, port: bool, seed=7):
    if port:
        from trino_tpu_torch import types as T
        from trino_tpu_torch.columnar import Batch, Column, as_tensor as arr
        from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
    else:
        from trino_tpu import types as T
        from trino_tpu.columnar import Batch, Column
        from trino_tpu.connectors.api import ColumnSchema, TableSchema

        def arr(a):
            return a
    mem = catalogs.get("memory")
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.2, size=6 * N_ROWS)
    keys = raw[raw <= 8][:N_ROWS].astype(np.int64)
    vals = rng.integers(0, 1000, N_ROWS).astype(np.int64)
    mem.create_table("default", "facts", TableSchema(
        "facts", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))))
    mem.insert("default", "facts", Batch(
        [Column(T.BIGINT, arr(keys)), Column(T.BIGINT, arr(vals))], N_ROWS))
    dk = np.arange(1, 9, dtype=np.int64)
    mem.create_table("default", "dims", TableSchema(
        "dims", (ColumnSchema("k", T.BIGINT), ColumnSchema("name", T.BIGINT))))
    mem.insert("default", "dims", Batch(
        [Column(T.BIGINT, arr(dk)), Column(T.BIGINT, arr(dk * 100))], 8))


def _props(hdir, **extra):
    return {
        "execution_mode": "distributed",
        "join_distribution_type": "PARTITIONED",
        "skew_handling": False,
        "history_dir": str(hdir),
        **extra,
    }


def _port_runner():
    from trino_tpu_torch.testing import DistributedQueryRunner

    runner = DistributedQueryRunner(n_devices=8, device="cpu")
    _seed_skewed(runner.catalogs, port=True)
    return runner


class TestSeeding:
    def test_fresh_engine_repeat_seeds_from_history(self, tmp_path):
        from trino_tpu.config import Session as RefSession
        from trino_tpu.testing import LocalQueryRunner as RefRunner

        ref = RefRunner()  # the reference's mesh: the 8 test devices
        _seed_skewed(ref.catalogs, port=False)
        ref_res = ref.engine.execute_statement(
            JOIN_SQL, RefSession(properties=_props(tmp_path / "ref")))
        ref_keys = set(ref_history.QueryHistoryStore(
            str(tmp_path / "ref" / "query_history.json")).entries()[0][1]["capacities"])

        cold = _port_runner().engine.execute_statement(
            JOIN_SQL, Session(properties=_props(tmp_path)))
        warm_runner = _port_runner()
        warm = warm_runner.engine.execute_statement(
            JOIN_SQL, Session(properties=_props(tmp_path)))
        off = _port_runner().engine.execute_statement(
            JOIN_SQL, Session(properties=_props(tmp_path, query_history=False)))
        assert warm.rows == cold.rows == off.rows == ref_res.rows
        ex = warm.exchange_stats
        assert ex["overflow_retries"] == 0 and ex.get("compile_halvings", 0) == 0
        assert ex["history_seeds"] >= 1 and ex["history_hits"] == 1
        assert "history" in {str(s["provenance"]).split("+")[0]
                             for s in ex["capacities"].values()}
        assert cold.exchange_stats["history_hits"] == 0
        assert off.exchange_stats.get("history_hits", 0) == 0
        # what history saves on this package: the first run's sizing reads
        assert ex.get("host_reads", 0) <= cold.exchange_stats.get("host_reads", 0)

        store = QueryHistoryStore(str(tmp_path / "query_history.json"))
        rows = store.entries()
        assert len(rows) == 1 and rows[0][1]["count"] == 2
        assert set(rows[0][1]["capacities"]) == ref_keys
        assert all("@" in s for s in rows[0][1]["capacities"])
        snap = warm_runner.engine.history_snapshot()
        assert snap["stores"] and snap["stores"][0]["records"] == 1
        sys_rows, names = warm_runner.execute("select * from system.runtime.history")
        assert "fingerprint" in names and len(sys_rows) >= 1

    def test_history_store_resolution(self, tmp_path):
        from trino_tpu_torch.engine import Engine

        eng = Engine(device="cpu")
        assert eng.history_store(Session(properties={"query_history": False})) is None
        mem1 = eng.history_store(Session())
        assert mem1 is eng.history_store(Session()) and mem1.path == ""
        disk = eng.history_store(Session(properties={"history_dir": str(tmp_path)}))
        assert disk is not mem1 and disk.path.endswith("query_history.json")


# --- admission -------------------------------------------------------------

def _manager(engine):
    from trino_tpu_torch.server.querymanager import QueryManager
    from trino_tpu_torch.server.resourcegroups import (
        GroupConfig,
        ResourceGroupManager,
        Selector,
    )

    rgm = ResourceGroupManager(max_wait_seconds=5)
    rgm.configure([GroupConfig("root", max_queued=4, hard_concurrency_limit=2)],
                  [Selector(group="root")])
    return QueryManager(engine, resource_groups=rgm), rgm


class TestAdmission:
    def test_rejection_classified_exceeded_memory(self):
        from trino_tpu.errors import classify_error as ref_classify
        from trino_tpu_torch.errors import classify_error

        got = classify_error(HistoryHbmRejected("fp", 10**12, 10**9))
        assert got == ref_classify(ref_history.HistoryHbmRejected("fp", 10**12, 10**9)) == (
            131075, "EXCEEDED_MEMORY_LIMIT", "INSUFFICIENT_RESOURCES")
        assert str(HistoryHbmRejected("fp", 10**12, 10**9)) == str(
            ref_history.HistoryHbmRejected("fp", 10**12, 10**9))

    def test_over_hbm_fingerprint_rejected_at_admission(self, tmp_path, monkeypatch):
        from trino_tpu_torch.server.statemachine import QueryState
        from trino_tpu_torch.testing import LocalQueryRunner

        runner = LocalQueryRunner(device="cpu")
        session = Session(properties={"execution_mode": "distributed",
                                      "history_dir": str(tmp_path)})
        sql = "select count(*), sum(l_quantity) from tpch.tiny.lineitem"
        fp, _ = runner.engine.fingerprint(sql, session)
        assert fp is not None
        runner.engine.history_store(session).record(fp, _obs(peak_hbm_bytes=10**15))
        monkeypatch.setattr("trino_tpu_torch.ingest.device_hbm_limit", lambda *a: 10**9)
        qm, rgm = _manager(runner.engine)
        q = qm.create_query(sql, session)
        assert q.state.get() == QueryState.FAILED
        assert q.error.error_name == "EXCEEDED_MEMORY_LIMIT"
        assert q.error.error_type == "INSUFFICIENT_RESOURCES"
        assert rgm.info()[0]["runningQueries"] == 0

    def test_fitting_hint_admits_and_runs(self, tmp_path, monkeypatch):
        from trino_tpu_torch.server import resourcegroups as RG
        from trino_tpu_torch.server.statemachine import QueryState
        from trino_tpu_torch.testing import LocalQueryRunner

        runner = LocalQueryRunner(device="cpu")
        session = Session(properties={"execution_mode": "distributed",
                                      "history_dir": str(tmp_path)})
        sql = "select count(*) from tpch.tiny.nation"
        fp, _ = runner.engine.fingerprint(sql, session)
        assert fp is not None
        runner.engine.history_store(session).record(fp, _obs(peak_hbm_bytes=1024))
        monkeypatch.setattr("trino_tpu_torch.ingest.device_hbm_limit", lambda *a: 10**9)
        hints: list = []
        submit = RG.ResourceGroupManager.submit

        def spy(self, *a, **kw):
            hints.append(kw.get("peak_hbm_hint"))
            return submit(self, *a, **kw)

        monkeypatch.setattr(RG.ResourceGroupManager, "submit", spy)
        qm, _ = _manager(runner.engine)
        q = qm.create_query(sql, session)
        q.state.wait_for(lambda st: st in (QueryState.FINISHED, QueryState.FAILED),
                         timeout=30.0)
        assert q.state.get() == QueryState.FINISHED, q.error and q.error.message
        assert hints == [1024]  # the observed peak rode into admission

    def test_waiter_queue_skips_unfitting_hint(self, monkeypatch):
        from trino_tpu_torch.server import resourcegroups as RG

        mgr = RG.ResourceGroupManager(max_wait_seconds=10)
        mgr.configure([RG.GroupConfig("root", max_queued=8, hard_concurrency_limit=1)],
                      [RG.Selector(group="root")])
        headroom = {"free": 100}
        monkeypatch.setattr(RG.ResourceGroupManager, "_hbm_fits",
                            staticmethod(lambda hint: int(hint) <= headroom["free"]))
        order: list = []
        got: dict = {}
        g0, admitted = mgr.submit("u", None, lambda g, e: None, peak_hbm_hint=0)
        assert admitted
        done_big, done_small = threading.Event(), threading.Event()
        _, a_big = mgr.submit("u", None, lambda g, e: (order.append("big"), done_big.set()),
                              peak_hbm_hint=500)
        _, a_small = mgr.submit(
            "u", None,
            lambda g, e: (got.__setitem__("small", g), order.append("small"),
                          done_small.set()),
            peak_hbm_hint=50)
        assert not a_big and not a_small
        mgr.finish(g0)
        assert done_small.wait(5.0) and order == ["small"] and not done_big.is_set()
        headroom["free"] = 1000
        mgr.finish(got["small"])
        assert done_big.wait(5.0) and order == ["small", "big"]


class TestManagerKnobs:
    def test_max_history_session_settable_and_gauge(self):
        from trino_tpu_torch.obs.metrics import get_registry
        from trino_tpu_torch.server.querymanager import QueryManager
        from trino_tpu_torch.server.statemachine import TERMINAL_QUERY_STATES
        from trino_tpu_torch.testing import LocalQueryRunner

        qm = QueryManager(LocalQueryRunner(device="cpu").engine)
        assert qm.max_history == 100
        q = qm.create_query("select 1", Session(properties={"query_manager_max_history": 7}))
        assert qm.max_history == 7
        q.state.wait_for(lambda st: st in TERMINAL_QUERY_STATES, timeout=20.0)
        g = get_registry().snapshot()["gauges"].get("trino_tpu_query_history_retained")
        assert g is not None and g >= 1
