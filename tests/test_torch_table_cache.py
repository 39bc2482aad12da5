"""The port's repairs of three faults against the JAX reference, on the
CPU: capacities kept per program-cache entry (canonical plan
fingerprint), and the device table cache.

- A join whose first capacities overflow (a build key repeated past the
  output capacity and the dense table's probe window) reruns its
  fragment on the first run and starts at the grown capacities on the
  repeat, with 0 overflow retries, as the reference's repeat does.
- Capacities do not leak between different queries: a streamed GROUP BY
  whose group budget grows has the same overflow retries and rows after
  another query grew the budget of its fragment id as on a fresh engine.
- The device table cache (``ingest.py``, reference
  ``trino_tpu/ingest.py::DeviceTableCache``) counts
  ``table_cache_hits`` and ``table_cache_misses`` in ``ingestStats`` as
  the reference's warm runs do; a write to a memory table changes its
  ``data_version`` and the next scan misses and reads the new rows;
  ``table_cache=false`` scans as before and counts nothing; a byte limit
  evicts the least recently used table.
"""

import numpy as np
import pytest
import torch

from trino_tpu import types as RT
from trino_tpu.columnar import Batch as RBatch, Column as RColumn
from trino_tpu.connectors.api import ColumnSchema as RColumnSchema, TableSchema as RTableSchema
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import batch_from_numpy
from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
from trino_tpu_torch.testing import LocalQueryRunner

# one intra-op thread: test processes run side by side (pytest-xdist), and
# torch's CPU thread pools then oversubscribe the cores, which slows the
# port's many small tensor ops ten- to a hundredfold
torch.set_num_threads(1)

rng = np.random.default_rng(5)
TABLES = {
    # key 7 on 40 build rows and 60 probe rows: 2,400 matches against a
    # first output capacity of 1,024, and a chain past the 16-slot window
    "b": {"bk": np.r_[np.full(40, 7), rng.integers(100, 10000, 300)],
          "bv": rng.integers(0, 100, 340)},
    "p": {"pk": np.r_[np.full(60, 7), rng.integers(100, 10000, 300)]},
    # a streamed GROUP BY with more groups than the first group budget
    "g": {"k": rng.integers(0, 9000, 12000), "v": rng.integers(0, 100, 12000)},
}
JOIN = "select count(*), sum(bv) from memory.default.p join memory.default.b on pk = bk"
GROUPS_A = "select k, sum(v) from memory.default.g group by k"
GROUPS_B = "select k % 6000, count(*) from memory.default.g group by k % 6000"
PROPS = {"execution_mode": "distributed", "stream_scan_threshold_rows": 1 << 10,
         "stream_device_chunk_rows": 1 << 14}


def port_runner() -> LocalQueryRunner:
    r = LocalQueryRunner(device="cpu")
    for k, v in PROPS.items():
        r.session.set(k, v)
    mem = r.catalogs.get("memory")
    for name, cols in TABLES.items():
        mem.create_table("default", name, TableSchema(
            name, tuple(ColumnSchema(c, T.BIGINT) for c in cols)))
        mem.insert("default", name, batch_from_numpy([T.BIGINT] * len(cols), list(cols.values())))
    return r


def ref_insert(mem, name, cols) -> None:
    n = len(next(iter(cols.values())))
    mem.insert("default", name, RBatch(
        [RColumn(RT.BIGINT, np.asarray(v, dtype=np.int64)) for v in cols.values()], n))


@pytest.fixture(scope="module")
def reference():
    """The reference's JOIN, run three times in distributed mode, then
    once after an insert into ``b``: (rows, overflow_retries,
    ingest_stats) per run."""
    ref = RefRunner()
    ref.session.set("execution_mode", "distributed")
    mem = ref.catalogs.get("memory")
    for name in ("b", "p"):
        cols = TABLES[name]
        mem.create_table("default", name, RTableSchema(
            name, tuple(RColumnSchema(c, RT.BIGINT) for c in cols)))
        ref_insert(mem, name, cols)
    runs = []
    for i in range(4):
        if i == 3:
            ref_insert(mem, "b", {"bk": [7], "bv": [1]})
        res = ref.engine.execute_statement(JOIN, ref.session)
        runs.append((res.rows, res.exchange_stats["overflow_retries"], res.ingest_stats))
    return runs


def run(r, sql):
    res = r.engine.execute_statement(sql, r.session)
    return res.rows, res.exchange_stats["overflow_retries"], res.ingest_stats or {}


def test_overflowing_join_repeats_without_retries(reference):
    r = port_runner()
    first, second, third = run(r, JOIN), run(r, JOIN), run(r, JOIN)
    assert first[0] == second[0] == third[0] == reference[0][0]
    assert first[1] >= 1 and reference[0][1] >= 1
    assert second[1] == third[1] == reference[1][1] == reference[2][1] == 0


def test_capacities_do_not_leak_between_queries():
    """GROUPS_B's fragments have the ids GROUPS_A's have; before the
    repair GROUPS_B inherited GROUPS_A's grown group budget. And a join
    that another plan grew keeps its own first-run retries."""
    warm = port_runner()
    after_a = [run(warm, sql) for sql in (JOIN, GROUPS_A, GROUPS_A, GROUPS_B, GROUPS_B)]
    fresh = port_runner()
    alone_b = [run(fresh, GROUPS_B), run(fresh, GROUPS_B)]
    assert after_a[1][1] >= 1 and after_a[2][1] == 0
    assert [(sorted(x[0]), x[1]) for x in after_a[3:]] == [
        (sorted(x[0]), x[1]) for x in alone_b
    ]
    assert alone_b[0][1] >= 1 and alone_b[1][1] == 0
    fresh_join = run(port_runner(), JOIN)
    assert after_a[0][:2] == fresh_join[:2]
    def fingerprint(r, sql):
        return r.engine.fingerprint(sql, r.session)[0]

    assert fingerprint(warm, GROUPS_A) != fingerprint(warm, GROUPS_B)
    assert fingerprint(warm, JOIN) == fingerprint(fresh, JOIN)


def test_table_cache_counts_as_the_reference(reference):
    r = port_runner()
    cold, warm = run(r, JOIN), run(r, JOIN)
    # one lookup per scan: both tables miss cold and hit warm
    assert cold[2]["table_cache_misses"] == 2 and "table_cache_hits" not in cold[2]
    assert warm[2]["table_cache_hits"] == reference[1][2]["table_cache_hits"] == 2
    assert "table_cache_misses" not in warm[2] and "table_cache_misses" not in reference[1][2]
    assert warm[2]["tableCache"]["entries"] == 2


def test_write_invalidates_the_cached_table(reference):
    r = port_runner()
    run(r, JOIN)
    r.catalogs.get("memory").insert("default", "b", batch_from_numpy(
        [T.BIGINT, T.BIGINT], [np.array([7]), np.array([1])]))
    after = run(r, JOIN)
    # a write bumps the memory connector's version: both tables miss
    assert after[0] == reference[3][0]
    assert after[2]["table_cache_misses"] == reference[3][2]["table_cache_misses"] == 2
    assert run(r, JOIN)[2]["table_cache_hits"] == 2


def test_table_cache_off_and_local_mode_count_nothing():
    r = port_runner()
    on = run(r, JOIN)
    r.session.set("table_cache", False)
    off = [run(r, JOIN), run(r, JOIN)]
    assert off[0][0] == off[1][0] == on[0]
    assert not any(k.startswith("table_cache") for _, _, st in off for k in st)
    r.session.set("execution_mode", "local")
    res = r.engine.execute_statement(JOIN, r.session)
    # the interpreter has no table cache: its ingest stats are the split
    # decode of its two scans only (as the reference's)
    assert res.rows == on[0]
    assert sorted(res.ingest_stats) == ["decode_ms", "splits_decoded"]
    assert res.ingest_stats["splits_decoded"] == 2


def test_byte_limit_evicts_least_recently_used():
    r = port_runner()
    r.session.set("table_cache_max_bytes", 4000)  # about one of b's columns sets
    run(r, "select sum(bv) from memory.default.b")
    run(r, "select sum(pk) from memory.default.p")
    snap = r.engine.table_cache.snapshot()
    assert snap["evictions"] >= 1 and snap["bytes"] <= 4000
    again = run(r, "select sum(bv) from memory.default.b")
    assert again[0] == [(int(TABLES["b"]["bv"].sum()),)]
    assert again[2].get("table_cache_misses") == 1


def test_default_budget_comes_from_the_card():
    """With ``table_cache_max_bytes`` unset the cache's budget is a quarter
    of the engine's memory pool on a card, whose pool is the card's
    memory (21.25 GB on an H100 80GB), and the reference's 1 GiB on the CPU,
    so CPU runs count as the reference's do; a budget the session sets
    wins. Before the repair every device got 1 GiB, which evicted 234
    times over the 64 TPC-DS queries at SF1 on an H100."""
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.engine import Engine, table_cache_budget
    from trino_tpu_torch.memory import MemoryPool

    session = Session()
    assert session.get("table_cache_max_bytes") is None
    card = MemoryPool(80 * 10**9)
    assert table_cache_budget(session, card, torch.device("cuda")) == 20 * 10**9
    assert table_cache_budget(session, card, torch.device("cpu")) == 1 << 30
    engine = Engine(device="cpu")
    assert engine.memory_pool.capacity == 16 << 30
    assert table_cache_budget(session, engine.memory_pool, engine.device) == 1 << 30
    session.set("table_cache_max_bytes", 4000)
    assert table_cache_budget(session, card, torch.device("cuda")) == 4000
    r = port_runner()
    run(r, JOIN)
    executor = r.engine._executor(r.session, r.plan(JOIN))
    assert executor.table_cache_bytes == 1 << 30


def test_a_rerun_releases_the_failed_attempt(monkeypatch):
    """A fragment that overflows reruns with grown capacities; the failed
    attempt's join outputs must be gone when the rerun starts, or the
    fragment's peak grows with every attempt. Before the repair a
    reference cycle among ``strings.lower_string_calls``'s closures held
    every column a filter saw, and the retry loop held the attempt's
    result: TPC-DS Q95 at SF10 peaked at 43.1 GB cold (three attempts'
    payload gathers alive at once) against 26.8 GB warm on an H100."""
    import weakref

    from trino_tpu_torch.exec import fragments as F

    outputs, alive_at_start = [], []
    real_output, real_init = F.join_output, F._FragmentTracer.__init__

    def join_output(*args, **kwargs):
        res = real_output(*args, **kwargs)
        outputs.extend(weakref.ref(c.data) for c in res.batch.columns)
        return res

    def init(self, *args, **kwargs):
        alive_at_start.append(sum(w() is not None for w in outputs))
        real_init(self, *args, **kwargs)

    monkeypatch.setattr(F, "join_output", join_output)
    monkeypatch.setattr(F._FragmentTracer, "__init__", init)
    # one fragment a program: in a fused unit the join's output is the
    # next member's input, alive when that member's tracer starts
    r = port_runner()
    r.session.set("pipeline_fusion", False)
    rows, retries, _ = run(r, JOIN)
    assert retries >= 1 and len(alive_at_start) > 2 and outputs
    assert max(alive_at_start) == 0


def test_a_fused_rerun_releases_the_failed_attempt(monkeypatch):
    """The same leak on the default path, where the join's fragment is a
    member of a fused unit. A join output belongs to a failed attempt
    once a tracer of its fragment has started again; whenever a tracer
    starts for a fragment that already ran (a rerun), every such output
    must be gone. Outputs of earlier units, and of earlier members of the
    running attempt, are legitimately alive and not counted."""
    import weakref

    from trino_tpu_torch.exec import fragments as F

    # (index of the tracer that made it, weak reference) per join output;
    # the fragment of each tracer, by index; the last index of a fragment
    outputs, order, last, alive_at_rerun = [], [], {}, []
    real_output, real_init = F.join_output, F._FragmentTracer.__init__

    def join_output(*args, **kwargs):
        res = real_output(*args, **kwargs)
        outputs.extend((len(order) - 1, weakref.ref(c.data)) for c in res.batch.columns)
        return res

    def init(self, base, inputs, input_layouts, caps=None, fragment_id=0, *args, **kwargs):
        rerun = fragment_id in last
        last[fragment_id] = len(order)
        order.append(fragment_id)
        if rerun:
            alive_at_rerun.append(sum(
                w() is not None for i, w in outputs if last[order[i]] > i
            ))
        real_init(self, base, inputs, input_layouts, caps, fragment_id, *args, **kwargs)

    monkeypatch.setattr(F, "join_output", join_output)
    monkeypatch.setattr(F._FragmentTracer, "__init__", init)
    r = port_runner()
    assert r.session.get("pipeline_fusion")
    rows, retries, _ = run(r, JOIN)
    res = r.engine.execute_statement(JOIN, r.session)
    assert res.rows == rows and res.exchange_stats["fusedFragments"] >= 2
    assert retries >= 1 and alive_at_rerun and outputs
    assert max(alive_at_rerun) == 0
