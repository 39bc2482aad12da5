"""The port's ingest tier on the CPU: double-buffered split decode, the
coalesced host-to-device copy, the four ingest session properties, the
synthetic connector's device chunks and the disk cache of generated
splits (reference: ``trino_tpu/ingest.py``, ``tests/test_ingest.py``,
``tests/test_synthetic.py``).

A CPU target copies nothing: the coalesced path packs the same layout
into an unpinned buffer and views it in place, so these tests walk the
layout; the pinned copy itself is held against per-column copies on the
card in ``test_torch_cuda.py``.
"""

import threading

import numpy as np
import pytest
import torch

from chip_smoke import synth_gen, synth_oracle  # config 4's generator and oracle
from trino_tpu_torch import ingest, native
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, batch_from_numpy
from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema, register_catalog_spec
from trino_tpu_torch.connectors.diskcache import DbgenDiskCache
from trino_tpu_torch.connectors.synthetic import SyntheticConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.testing import LocalQueryRunner

torch.set_num_threads(1)


# === split prefetcher =====================================================


@pytest.mark.parametrize("enabled", [True, False])
def test_prefetcher_order_and_stats(enabled):
    stats: dict = {}
    out = list(ingest.SplitPrefetcher(lambda x: x * 2, range(20), enabled=enabled, stats=stats))
    assert out == [x * 2 for x in range(20)]
    assert stats["splits_decoded"] == 20 and stats["decode_ms"] >= 0


def test_prefetcher_propagates_decode_error():
    def boom(x):
        if x == 3:
            raise ValueError("bad split")
        return x

    got = []
    with pytest.raises(ValueError, match="bad split"):
        for x in ingest.SplitPrefetcher(boom, range(6), enabled=True):
            got.append(x)
    assert got == [0, 1, 2]  # the splits before the error, in order


def test_prefetcher_stops_when_the_consumer_stops():
    """A consumer that breaks (a limit) must not leave the producer blocked
    on the full slot."""
    seen = []

    def decode(x):
        seen.append(x)
        return x

    it = iter(ingest.SplitPrefetcher(decode, range(100), enabled=True))
    assert next(it) == 0
    it.close()
    assert len(seen) < 100
    assert not [t for t in threading.enumerate() if t.name == "tt-ingest-decode"]


def test_prefetcher_decodes_on_a_thread_in_the_session_mode():
    seen = []

    def decode(x):
        seen.append((threading.current_thread().name, native.native_mode()))
        return x

    list(ingest.SplitPrefetcher(decode, range(3), enabled=True, native=False))
    assert seen == [("tt-ingest-decode", False)] * 3
    assert native.native_mode()  # the caller's own mode is untouched


# === coalesced copy =======================================================


def _mixed_batch():
    rng = np.random.default_rng(0)
    n = 257
    b = batch_from_numpy(
        [T.BIGINT, T.VARCHAR, T.DOUBLE, T.BOOLEAN, T.INTEGER, T.REAL, T.DATE],
        [rng.integers(-9, 9, n), np.array(["x", "yy", "z"])[rng.integers(0, 3, n)],
         rng.random(n), rng.random(n) < 0.5, rng.integers(0, 99, n), rng.random(n),
         rng.integers(0, 9000, n)],
        [None, rng.random(n) < 0.7, None, rng.random(n) < 0.5, None, None, None],
    )
    wide = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, (n, 2)))
    b.columns.append(Column(T.decimal(38, 2), wide))
    return Batch(b.columns, n, torch.from_numpy(rng.random(n) < 0.9))


@pytest.mark.parametrize("native_mode", [True, False])
def test_coalesced_layout_equals_per_column_copies(native_mode):
    b = _mixed_batch()
    stats: dict = {}
    with native.decode_mode(native_mode):
        out = ingest.to_device(b, "cpu", coalesced=True, min_bytes=0, stats=stats)
    plain = b.to("cpu")
    assert stats == {"coalesced_columns": len(b.columns)}  # nothing copied on the CPU
    for x, y in zip(out.columns, plain.columns):
        assert x.data.dtype == y.data.dtype and x.data.shape == y.data.shape
        assert torch.equal(x.data, y.data)
        assert (x.valid is None) == (y.valid is None)
        assert x.valid is None or torch.equal(x.valid, y.valid)
        assert x.dictionary is y.dictionary
    assert torch.equal(out.sel, plain.sel) and out.to_pylist() == plain.to_pylist()
    offsets, nbytes = ingest.segment_layout(ingest._buffers(b))
    assert all(o % 8 == 0 for o in offsets) and nbytes % 8 == 0
    wide_offset = offsets[-1]  # the DECIMAL(38) lane pairs
    assert wide_offset % 16 == 0


def test_small_scans_copy_column_by_column():
    b = _mixed_batch()
    stats: dict = {}
    out = ingest.to_device(b, "cpu", coalesced=True, min_bytes=1 << 30, stats=stats)
    assert stats == {} and out.to_pylist() == b.to_pylist()


# === the four ingest settings through SQL =================================


@pytest.fixture(scope="module")
def pq_runner(tmp_path_factory):
    runner = LocalQueryRunner(device="cpu")
    register_catalog_spec(runner.engine.catalogs,
                          f"pq=parquet:{tmp_path_factory.mktemp('pq')}")
    runner.execute("create table pq.tiny.lineitem as select l_orderkey, l_returnflag,"
                   " l_quantity, l_extendedprice, l_shipdate, l_comment from tpch.tiny.lineitem")
    runner.execute("insert into pq.tiny.lineitem select l_orderkey, l_returnflag,"
                   " l_quantity, l_extendedprice, l_shipdate, l_comment from tpch.tiny.lineitem"
                   " where l_orderkey < 3000")
    return runner


Q = ("select l_returnflag, count(*), sum(l_quantity), max(l_shipdate), min(l_comment)"
     " from pq.tiny.lineitem group by l_returnflag order by l_returnflag")


@pytest.mark.parametrize("mode", ["local", "distributed"])
def test_ingest_settings_change_the_scan_and_never_the_rows(pq_runner, mode):
    want = pq_runner.execute(Q.replace("pq.tiny", "tpch.tiny").replace(
        "from tpch.tiny.lineitem", "from (select * from tpch.tiny.lineitem union all"
        " select * from tpch.tiny.lineitem where l_orderkey < 3000)"))[0]
    seen = {}
    for nat in (True, False):
        for prefetch in (True, False):
            for coalesced in (True, False):
                s = pq_runner.session
                for k, v in (("execution_mode", mode), ("native_decode", nat),
                             ("ingest_prefetch", prefetch), ("coalesced_h2d", coalesced),
                             ("coalesce_min_bytes", 0), ("table_cache", False)):
                    s.set(k, v)
                res = pq_runner.engine.execute_statement(Q, s)
                assert res.rows == want
                seen[(nat, prefetch, coalesced)] = res.ingest_stats
    for (nat, prefetch, coalesced), st in seen.items():
        assert st["splits_decoded"] == 2
        assert st.get("splits_decoded_numpy", 0) == (0 if nat else 2)
        assert st.get("coalesced_columns", 0) == (4 if coalesced else 0)  # 4 columns read
        assert st.get("h2d_bytes", 0) == 0  # a CPU target copies nothing
    pq_runner.session.properties.clear()


@pytest.mark.parametrize("prefetch", [True, False])
def test_limit_stops_reading_splits(prefetch):
    """The memory connector takes the limit hint: the scan stops after the
    split that covers it, and the decode thread within two splits."""
    runner = LocalQueryRunner(device="cpu")
    runner.session.set("ingest_prefetch", prefetch)
    runner.execute("create table memory.default.li as select l_orderkey from tpch.tiny.lineitem")
    total = len(runner.catalogs.get("memory").get_splits("default", "li", 64))
    res = runner.engine.execute_statement(
        "select l_orderkey from memory.default.li limit 3", runner.session)
    assert len(res.rows) == 3 and total > 10
    decoded = res.ingest_stats["splits_decoded"]
    assert decoded == 1 if not prefetch else 2 <= decoded <= 3


def test_warm_scan_hits_the_table_cache_and_an_insert_misses(pq_runner, tmp_path):
    s = pq_runner.session
    s.set("execution_mode", "distributed")
    register_catalog_spec(pq_runner.engine.catalogs, f"pw=parquet:{tmp_path}")
    pq_runner.execute("create table pw.default.t as select l_orderkey x from tpch.tiny.lineitem")
    sql = "select count(*), sum(x) from pw.default.t"
    cold = pq_runner.engine.execute_statement(sql, s)
    warm = pq_runner.engine.execute_statement(sql, s)
    assert warm.rows == cold.rows
    assert cold.ingest_stats["table_cache_misses"] == 1
    assert warm.ingest_stats["table_cache_hits"] == 1
    assert warm.ingest_stats.get("h2d_bytes", 0) == 0 and "splits_decoded" not in warm.ingest_stats
    pq_runner.execute("insert into pw.default.t select 7")
    after = pq_runner.engine.execute_statement(sql, s)
    assert after.ingest_stats["table_cache_misses"] == 1
    assert after.rows == [(cold.rows[0][0] + 1, cold.rows[0][1] + 7)]
    s.properties.clear()


# === synthetic connector ==================================================

def _synthetic_runner(rows: int, mode: str) -> LocalQueryRunner:
    runner = LocalQueryRunner(device="cpu")
    conn = SyntheticConnector(split_rows=1 << 16)
    conn.add_table("default", "events", TableSchema(
        "events", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))), rows, synth_gen)
    runner.catalogs.register("synthetic", conn)
    runner.session.set("execution_mode", mode)
    runner.session.set("stream_scan_threshold_rows", 1 << 14)
    runner.session.set("stream_device_chunk_rows", 1 << 16)
    return runner


def test_device_generator_equals_the_host_path():
    conn = SyntheticConnector(split_rows=1000)
    conn.add_table("default", "events", TableSchema(
        "events", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))), 2500, synth_gen)
    make_chunk, rows = conn.device_generator("default", "events", ["v", "k"], device="cpu")
    assert rows == 2500
    host = [conn.read_split("default", "events", ["v", "k"], s)
            for s in conn.get_splits("default", "events", 3)]
    want = [r for b in host for r in b.to_pylist()]
    got = Batch(make_chunk(0, 2500), 2500).to_pylist()
    assert got == want
    assert Batch(make_chunk(1000, 500), 500).to_pylist() == want[1000:1500]


@pytest.mark.parametrize("mode", ["local", "distributed"])
def test_synthetic_group_by_equals_its_closed_form(mode):
    rows = (1 << 20) + 12345  # one whole period and a remainder
    runner = _synthetic_runner(rows, mode)
    res = runner.engine.execute_statement(
        "select k, sum(v), count(*) from synthetic.default.events group by k", runner.session)
    assert sorted(res.rows) == synth_oracle(rows)
    ing = res.ingest_stats or {}
    if mode == "distributed":  # streamed from chunks made on the device
        assert res.fragment_modes[2] == "streamed"
        assert ing["device_chunks"] == 17 and "splits_decoded" not in ing
    else:  # the interpreter reads the host splits
        assert ing["splits_decoded"] == 17
    assert ing.get("h2d_bytes", 0) == 0


# === disk cache of generated splits =======================================


def test_disk_cache_round_trip_and_off_switch(tmp_path, monkeypatch):
    cols = ["l_orderkey", "l_shipmode", "l_comment", "l_quantity"]
    first = TpchConnector()
    first._disk_cache = DbgenDiskCache(str(tmp_path))
    split = first.get_splits("tiny", "lineitem", 1)[0]
    want = first.read_split("tiny", "lineitem", cols, split).to_pylist()
    second = TpchConnector()
    second._disk_cache = DbgenDiskCache(str(tmp_path))
    got = second.read_split("tiny", "lineitem", cols, split)
    assert got.to_pylist() == want
    assert first.disk_cache_stats()["misses"] == 1
    assert second.disk_cache_stats() == {"enabled": True, "hits": 1, "misses": 0}
    # distribution-valued dictionaries are the connector's shared instance
    assert got.columns[1].dictionary is second._strings(
        "l_shipmode", list(got.columns[1].dictionary.values))
    monkeypatch.setenv("TRINO_TPU_DBGEN_CACHE", "off")
    assert not DbgenDiskCache().enabled
    monkeypatch.setenv("TRINO_TPU_DBGEN_CACHE", "/elsewhere")
    assert DbgenDiskCache().directory.endswith(".cache/dbgen_torch")
    monkeypatch.setenv("TRINO_TPU_DBGEN_CACHE_BYTES", "10")
    tiny = DbgenDiskCache(str(tmp_path / "small"))
    tiny.put(("k",), got)
    assert tiny.max_bytes == 10 and not list((tmp_path / "small").iterdir())
