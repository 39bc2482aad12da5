"""The sort-based streaming step of trino_tpu_torch against the JAX
reference, on the CPU.

One memory table of 2^15 rows, inserted as four parts whose VARCHAR
dictionaries list their strings in different orders, loads into both
engines. In distributed mode with ``stream_scan_threshold_rows`` below its
size the source fragment streams; the group keys span a domain the dense
path refuses, so the chunk step runs: over the device slab (one chunk of
2^16 rows, ``stream_device_chunk_rows`` set in both engines), or over
host chunks when ``stream_device_cache_bytes`` is 0. Rows must equal the
reference's exactly: every result is DECIMAL, BIGINT or VARCHAR.

The reference's streaming step keeps every accumulator in int64, so it
truncates DOUBLE sums and min/max and cannot carry a wide DECIMAL min/max
(ROADMAP Queue 3); those cases are held against an exact Python oracle
instead.
"""

from decimal import Decimal

import numpy as np
import pytest

from trino_tpu import types as RT
from trino_tpu.columnar import Batch as RBatch, Column as RColumn
from trino_tpu.columnar import Dictionary as RDictionary
from trino_tpu.connectors.api import (
    ColumnSchema as RColumnSchema,
    TableSchema as RTableSchema,
)
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import _kernels
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, Dictionary, as_tensor
from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
from trino_tpu_torch.exec.streaming import StreamingAggregator
from trino_tpu_torch.testing import LocalQueryRunner

N = 1 << 15
PARTS = 4
STRINGS = ["AIR", "MAIL", "RAIL", "SHIP", "TRUCK", "FOB"]
DEC = (12, 2)

GROUPED = ("select k, sum(d), sum(d * e), avg(d), count(v), sum(v), count(*) "
           "from memory.default.t group by k")
GLOBAL = ("select sum(d), sum(d * e), avg(e), count(v), sum(v), count(*) "
          "from memory.default.t where e < 50")
MINMAX = ("select s, min(d), max(d), min(v), max(v), count(*) "
          "from memory.default.t where v > -900 group by s")
QUERIES = {"grouped": GROUPED, "global": GLOBAL, "min-max": MINMAX}


def _columns():
    rng = np.random.default_rng(11)
    cols = {
        # about 3000 keys over a domain far wider than the dense path's
        "k": rng.integers(0, 3000, N) * 1_000_003,
        "d": rng.integers(-(10**9), 10**9, N),  # DECIMAL(12,2) cents
        "e": rng.integers(0, 100, N),  # DECIMAL(12,2), like a discount
        "v": rng.integers(-1000, 1000, N),
        "f": rng.random(N) * 1000.0,
        "s": rng.integers(0, len(STRINGS), N),
        "dt": rng.integers(8035, 10561, N),  # DATE: 1992-01-01 .. 1998-12-01
    }
    valid = {"v": rng.random(N) < 0.8}
    return cols, valid


TYPES = {"k": "bigint", "d": "dec", "e": "dec", "v": "bigint", "f": "double",
         "s": "varchar", "dt": "date"}


def _types(mod):
    dec = mod.decimal(*DEC)
    return {
        "bigint": mod.BIGINT, "dec": dec, "double": mod.DOUBLE,
        "varchar": mod.VARCHAR, "date": mod.DATE,
    }


def _parts(cols, valid):
    """The table as PARTS inserts: per part, each column's (data, valid),
    ``s`` as codes under the part's own string order."""
    rng = np.random.default_rng(12)
    step = N // PARTS
    for p in range(PARTS):
        lo, hi = p * step, (p + 1) * step
        order = rng.permutation(len(STRINGS))
        values = [STRINGS[i] for i in order]
        inv = np.argsort(order)
        part = {}
        for c in cols:
            v = valid.get(c)
            v = None if v is None else v[lo:hi]
            if c == "s":
                part[c] = (inv[cols[c][lo:hi]].astype(np.int32), v)
            else:
                dt = {"double": np.float64, "date": np.int32}.get(TYPES[c], np.int64)
                part[c] = (np.ascontiguousarray(cols[c][lo:hi].astype(dt)), v)
        yield step, values, part


def load_ref(ref: RefRunner, cols, valid) -> None:
    rt = _types(RT)
    mem = ref.catalogs.get("memory")
    mem.create_table("default", "t", RTableSchema("t", tuple(
        RColumnSchema(c, rt[TYPES[c]]) for c in cols)))
    for n, values, part in _parts(cols, valid):
        mem.insert("default", "t", RBatch([
            RColumn(rt[TYPES[c]], d, v, RDictionary(values) if c == "s" else None)
            for c, (d, v) in part.items()
        ], n))


def load_port(port: LocalQueryRunner, cols, valid) -> None:
    pt = _types(T)
    mem = port.catalogs.get("memory")
    mem.create_table("default", "t", TableSchema("t", tuple(
        ColumnSchema(c, pt[TYPES[c]]) for c in cols)))
    for n, values, part in _parts(cols, valid):
        mem.insert("default", "t", Batch([
            Column(pt[TYPES[c]], as_tensor(d), None if v is None else as_tensor(v),
                   Dictionary(values) if c == "s" else None)
            for c, (d, v) in part.items()
        ], n))


PROPS = {
    "execution_mode": "distributed",
    "stream_scan_threshold_rows": 1 << 14,
    "stream_device_chunk_rows": 1 << 16,
}


@pytest.fixture(scope="module")
def table():
    return _columns()


@pytest.fixture(scope="module")
def ref(table):
    ref = RefRunner()
    for k, v in PROPS.items():
        ref.session.set(k, v)
    load_ref(ref, *table)
    return ref


@pytest.fixture(scope="module")
def want(ref):
    """The reference's rows for every query, computed once."""
    out = {}
    for name, sql in QUERIES.items():
        rows, names = ref.execute(sql)
        out[name] = (sorted(rows), names)
    return out


def _loaded(table, **props) -> LocalQueryRunner:
    """A fresh port runner (its own streamed budgets) over the table."""
    port = LocalQueryRunner(device="cpu")
    for k, v in {**PROPS, **props}.items():
        port.session.set(k, v)
    load_port(port, *table)
    return port


def _run(port, sql):
    before = _kernels.PLAIN_CALLS["dense_groupby"]
    res = port.engine.execute_statement(sql, port.session)
    assert _kernels.PLAIN_CALLS["dense_groupby"] == before  # not the dense path
    assert "streamed" in res.fragment_modes.values()
    return res


@pytest.mark.parametrize("name", list(QUERIES))
def test_slab_step_matches_reference(table, want, name):
    port = _loaded(table)
    res = _run(port, QUERIES[name])
    assert res.column_names == want[name][1]
    assert sorted(res.rows) == want[name][0]
    assert res.exchange_stats["overflow_retries"] == 0


def test_overflow_ladder_grows_the_group_budget(table, want):
    port = _loaded(table, stream_group_budget=16)
    res = _run(port, GROUPED)
    assert sorted(res.rows) == want["grouped"][0]
    # 16 -> 64 -> 256 -> 1024 -> 4096 groups for about 3000 keys
    assert res.exchange_stats["overflow_retries"] == 4
    # the grown budget is kept for the next query of the engine
    again = _run(port, GROUPED)
    assert again.exchange_stats["overflow_retries"] == 0
    assert sorted(again.rows) == want["grouped"][0]


def _count_chunks(monkeypatch, source: str) -> list:
    """Count the chunks the named chunk source yields."""
    seen = []
    orig = getattr(StreamingAggregator, source)

    def counted(self, *args):
        for chunk in orig(self, *args):
            seen.append(chunk.capacity)
            yield chunk

    monkeypatch.setattr(StreamingAggregator, source, counted)
    return seen


@pytest.mark.parametrize("name", list(QUERIES))
def test_slab_step_over_many_chunks(table, want, name, monkeypatch):
    """2^13-row views of the slab: four chunks carry state across."""
    seen = _count_chunks(monkeypatch, "_slab_chunks")
    port = _loaded(table, stream_device_chunk_rows=1 << 13)
    res = _run(port, QUERIES[name])
    assert sorted(res.rows) == want[name][0]
    assert seen == [1 << 13] * 4


@pytest.mark.parametrize("name", ["grouped", "min-max"])
def test_host_chunk_source(table, want, name, monkeypatch):
    """No device slab: splits stream as host chunks of 2^12 rows, string
    codes remapped onto one running dictionary per column."""
    seen = _count_chunks(monkeypatch, "_chunks")
    port = _loaded(table, stream_device_cache_bytes=0, stream_chunk_rows=1 << 12)
    res = _run(port, QUERIES[name])
    assert sorted(res.rows) == want[name][0]
    assert seen == [1 << 12] * 8


def test_double_and_wide_min_max_stream_exactly(table):
    cols, valid = table
    port = _loaded(table)
    res = _run(
        port,
        "select s, min(f), max(f), min(d * e), max(d * e) "
        "from memory.default.t group by s",
    )
    got = {r[0]: r[1:] for r in res.rows}
    assert len(got) == len(STRINGS)
    for i, s in enumerate(STRINGS):
        m = cols["s"] == i
        prod = [int(a) * int(b) for a, b in zip(cols["d"][m], cols["e"][m])]
        assert got[s] == (
            float(cols["f"][m].min()), float(cols["f"][m].max()),
            Decimal(min(prod)) / 10**4, Decimal(max(prod)) / 10**4,
        )


# DECIMAL and DATE expressions of the compiler, row by row: narrow and wide
# arithmetic with rescale (d * e is DECIMAL(24,4), wide), division and
# modulus by zero (NULL), negation and comparison of wide values, mixed
# scales, casts among DECIMAL, BIGINT and DOUBLE, DATE literals and
# interval arithmetic, IF and COALESCE over wide operands
EXPRESSIONS = (
    "select k, d + e, d - 2.5, d * e, d * e + d, d / e, d % e, e / 3, "
    "-(d * e), d * e > 12345.6789, d * e <= d, d > 99.999, "
    "cast(d as double), cast(d as bigint), cast(v as decimal(10, 3)), "
    "cast(f as decimal(12, 2)), cast(d * e as decimal(15, 2)), "
    "if(v > 0, d * e, -(d * e)), coalesce(if(v > 5, d * e), d), "
    "dt + interval '3' day, dt > date '1995-06-17', "
    "d between -1000000 and 1000000 "
    "from memory.default.t where v between 0 and 15"
)
# ORDER BY and TopN over a wide DECIMAL key
WIDE_ORDER = (
    "select k, d * e from memory.default.t where v between 0 and 15 "
    "order by d * e desc, k limit 40"
)


def test_decimal_and_date_expressions_match_reference(table, ref):
    port = _loaded(table, execution_mode="local")
    ref.session.set("execution_mode", "local")
    try:
        want_rows, want_names = ref.execute(EXPRESSIONS)
    finally:
        ref.session.set("execution_mode", "distributed")
    res = port.engine.execute_statement(EXPRESSIONS, port.session)
    assert res.column_names == want_names
    assert len(want_rows) > 100
    assert sorted(res.rows, key=repr) == sorted(want_rows, key=repr)


@pytest.mark.parametrize("mode", ["local", "distributed"])
def test_order_by_wide_decimal_matches_reference(table, ref, mode):
    port = _loaded(table, execution_mode=mode)
    ref.session.set("execution_mode", "local")
    try:
        want_rows, _ = ref.execute(WIDE_ORDER)
    finally:
        ref.session.set("execution_mode", "distributed")
    rows, _ = port.execute(WIDE_ORDER)
    assert len(want_rows) == 40
    assert rows == want_rows
