"""The port's Parquet and ORC readers and writers against the JAX
reference's and pyarrow's, on the CPU.

Each package reads the files the other writes, for every engine scalar
type with nulls, every codec the writers have, several row groups and
stripes, and DECIMAL(38) in ORC; both writers make the same bytes from
the same batches; pyarrow reads the port's files and the port reads
pyarrow's; row-group and stripe statistics are equal.
"""

import io
import os
from decimal import Decimal

import numpy as np
import pytest
import torch

from trino_tpu import columnar as RC
from trino_tpu import types as RT
from trino_tpu.formats import orc as ref_orc
from trino_tpu.formats import parquet as ref_pq
from trino_tpu_torch import native
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, batch_from_numpy
from trino_tpu_torch.formats import orc, parquet

torch.set_num_threads(1)

PQ_TYPES = ["boolean", "integer", "bigint", "real", "double", "decimal(12,2)",
            "date", "timestamp", "varchar"]
ORC_TYPES = ["boolean", "integer", "bigint", "real", "double", "decimal(12,2)",
             "date", "varchar"]


def columns(types, n: int, seed: int):
    """Seeded numpy columns, one in five values NULL in every other column."""
    rng = np.random.default_rng(seed)
    arrays, valids = [], []
    for j, t in enumerate(types):
        if t == "boolean":
            a = rng.random(n) < 0.5
        elif t == "varchar":
            a = np.array([["", "alpha", "Δδ", "a b", "zz"][i] + str(i % 3)
                          for i in rng.integers(0, 5, n)])
        elif t in ("real", "double"):
            a = rng.normal(0, 1e3, n)
        elif t == "date":
            a = rng.integers(-400, 20000, n)
        elif t == "timestamp":
            a = rng.integers(0, 10**15, n)
        elif t == "integer":
            a = rng.integers(-(1 << 31), 1 << 31, n)
        else:
            a = rng.integers(-(10**11), 10**11, n)
        arrays.append(a)
        valids.append(rng.random(n) < 0.8 if j % 2 else None)
    return arrays, valids


def port_batch(types, arrays, valids):
    return batch_from_numpy([T.parse_type(t) for t in types], arrays, valids)


def ref_batch(types, arrays, valids):
    cols = []
    for t, a, v in zip(types, arrays, valids):
        t = RT.parse_type(t)
        d = None
        if RT.is_string(t):
            d, a = RC.Dictionary.from_strings([str(x) for x in a])
        cols.append(RC.Column(t, np.asarray(a).astype(t.storage_dtype), v, d))
    return RC.Batch(cols, len(arrays[0]))


def batches(types, pkg: str, groups: int = 3, n: int = 300):
    make = port_batch if pkg == "port" else ref_batch
    return [make(types, *columns(types, n + 17 * g, seed=g)) for g in range(groups)]


def rows(batch_list):
    return [r for b in batch_list for r in b.to_pylist()]


# --- Parquet ---------------------------------------------------------------


def write_pq(pkg: str, types, codec: int) -> bytes:
    f = io.BytesIO()
    names = [f"c{j}" for j in range(len(types))]
    if pkg == "port":
        parquet.write_parquet(f, names, batches(types, "port"), codec=codec)
    else:
        ref_pq.write_parquet(f, names, batches(types, "ref"), codec=codec)
    return f.getvalue()


@pytest.mark.parametrize("codec", [parquet.CODEC_UNCOMPRESSED, parquet.CODEC_SNAPPY])
def test_parquet_files_cross_read(codec):
    mine, theirs = write_pq("port", PQ_TYPES, codec), write_pq("ref", PQ_TYPES, codec)
    assert mine == theirs  # the same writer: the same bytes
    want = rows(batches(PQ_TYPES, "ref"))
    names = [f"c{j}" for j in range(len(PQ_TYPES))]
    meta = parquet.read_footer(mine)
    ref_meta = ref_pq.read_footer(mine)
    assert len(meta.row_groups) == 3
    for rg in range(3):
        got = parquet.read_batch(mine, meta, rg, names).to_pylist()
        ref = ref_pq.read_batch(mine, ref_meta, rg, names).to_pylist()
        assert got == ref
        with native.decode_mode(False):
            assert parquet.read_batch(mine, meta, rg, names).to_pylist() == got
        with io.BytesIO(mine) as f:
            part = parquet.read_row_group(f, parquet.read_file_footer(f), rg, names[::-1])
        assert part.to_pylist() == [r[::-1] for r in got]
        assert parquet.row_group_stats(meta, rg) == ref_pq.row_group_stats(ref_meta, rg)
    assert [r for rg in range(3)
            for r in parquet.read_batch(mine, meta, rg, names).to_pylist()] == want


def test_parquet_reads_pyarrow_files_and_pyarrow_reads_ours(tmp_path):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    rng = np.random.default_rng(3)
    n = 1000
    table = pa.table({
        "i": pa.array(rng.integers(-5, 5, n), type=pa.int64()),
        "j": pa.array([None if x % 7 == 0 else int(x) for x in range(n)], type=pa.int32()),
        "f": pa.array(rng.random(n)),
        "s": pa.array([None if x % 5 == 0 else f"s{x % 13}" for x in range(n)]),
        "b": pa.array([bool(x % 3) for x in range(n)]),
        "d": pa.array([int(x) for x in rng.integers(0, 20000, n)], type=pa.date32()),
    })
    for compression in ("none", "snappy", "gzip"):
        path = str(tmp_path / f"{compression}.parquet")
        pq.write_table(table, path, compression=compression, row_group_size=300,
                       use_dictionary=compression != "none")
        data = open(path, "rb").read()
        meta = parquet.read_footer(data)
        ref_meta = ref_pq.read_footer(data)
        assert len(meta.row_groups) == 4
        got = [r for rg in range(4)
               for r in parquet.read_batch(data, meta, rg, list(table.column_names)).to_pylist()]
        ref = [r for rg in range(4)
               for r in ref_pq.read_batch(data, ref_meta, rg, list(table.column_names)).to_pylist()]
        assert got == ref
        assert [r[0] for r in got] == table.column("i").to_pylist()
        assert [r[3] for r in got] == table.column("s").to_pylist()
        for rg in range(4):
            assert parquet.row_group_stats(meta, rg) == ref_pq.row_group_stats(ref_meta, rg)
    path = tmp_path / "ours.parquet"
    path.write_bytes(write_pq("port", PQ_TYPES, parquet.CODEC_SNAPPY))
    back = pq.read_table(str(path))
    assert back.num_rows == sum(b.num_rows for b in batches(PQ_TYPES, "port"))
    want = rows(batches(PQ_TYPES, "port"))
    assert back.column("c2").to_pylist() == [r[2] for r in want]
    assert back.column("c8").to_pylist() == [r[8] for r in want]


# --- ORC -------------------------------------------------------------------


def write_orc_bytes(pkg: str, types, compression: int, groups: int = 3) -> bytes:
    f = io.BytesIO()
    names = [f"c{j}" for j in range(len(types))]
    if pkg == "port":
        orc.write_orc(f, names, batches(types, "port", groups), compression=compression)
    else:
        ref_orc.write_orc(f, names, batches(types, "ref", groups), compression=compression)
    return f.getvalue()


def _stats(f):
    return [{k: (s.num_values, s.has_null, s.min_value, s.max_value)
             for k, s in f.stripe_stats(i).items()} for i in range(len(f.stripes))]


@pytest.mark.parametrize("compression", [orc.COMPRESSION_NONE, orc.COMPRESSION_ZLIB,
                                         orc.COMPRESSION_SNAPPY])
def test_orc_files_cross_read(compression):
    mine = write_orc_bytes("port", ORC_TYPES, compression)
    theirs = write_orc_bytes("ref", ORC_TYPES, compression)
    assert mine == theirs
    names = [f"c{j}" for j in range(len(ORC_TYPES))]
    f, rf = orc.OrcFile(mine), ref_orc.OrcFile(mine)
    assert len(f.stripes) == 3
    assert _stats(f) == _stats(rf)
    for stripe, rstripe in zip(f.stripes, rf.stripes):
        got = f.read_stripe(stripe, set(names))
        ref = rf.read_stripe(rstripe, set(names))
        got_rows = Batch([got[n] for n in names], stripe.num_rows).to_pylist()
        ref_rows = RC.Batch([ref[n] for n in names], rstripe.num_rows).to_pylist()
        assert got_rows == ref_rows
        with native.decode_mode(False):
            slow = orc.OrcFile(mine).read_stripe(stripe, set(names))
        assert Batch([slow[n] for n in names], stripe.num_rows).to_pylist() == got_rows


def test_orc_wide_decimal_crosses_both_ways(tmp_path):
    # past 2^63 (two lanes) and within the 28 digits of the writer's statistics
    wide = [(10**24 + 7) * s for s in (1, -1)] + [0, None, 5]
    pairs = np.zeros((5, 2), dtype=np.int64)
    from trino_tpu_torch.ops.decimal128 import int_to_pair

    for i, v in enumerate(wide):
        if v is not None:
            pairs[i] = int_to_pair(v)
    valid = np.array([v is not None for v in wide])
    t = T.decimal(38, 3)
    b = Batch([Column(t, torch.from_numpy(pairs), torch.from_numpy(valid))], 5)
    f = io.BytesIO()
    orc.write_orc(f, ["w"], [b, b])
    path = tmp_path / "w.orc"
    path.write_bytes(f.getvalue())
    got = orc.read_orc(str(path)).to_pylist()
    assert got == ref_orc.read_orc(str(path)).to_pylist() == b.to_pylist() * 2
    pa_orc = pytest.importorskip("pyarrow.orc")
    back = pa_orc.read_table(str(path)).column("w").to_pylist()
    assert [None if x is None else int(x.scaleb(3)) for x in back] == wide * 2


def test_orc_reads_pyarrow_files_and_pyarrow_reads_ours(tmp_path):
    pa = pytest.importorskip("pyarrow")
    pa_orc = pytest.importorskip("pyarrow.orc")
    n = 3000
    rng = np.random.default_rng(5)
    table = pa.table({
        "i": pa.array([None if x % 11 == 0 else int(v) for x, v in
                       enumerate(rng.integers(-(1 << 40), 1 << 40, n))], type=pa.int64()),
        "s": pa.array([f"k{x % 17}" for x in range(n)]),
        "f": pa.array(rng.random(n)),
        "dec": pa.array([None if x % 9 == 0 else Decimal(int(v)).scaleb(-2) for x, v in
                         enumerate(rng.integers(-10**9, 10**9, n))], type=pa.decimal128(12, 2)),
    })
    for compression in ("uncompressed", "zlib", "snappy"):
        path = str(tmp_path / f"{compression}.orc")
        pa_orc.write_table(table, path, compression=compression, stripe_size=1 << 14)
        got = orc.read_orc(path).to_pylist()
        assert got == ref_orc.read_orc(path).to_pylist()
        assert [r[0] for r in got] == table.column("i").to_pylist()
        assert [r[1] for r in got] == table.column("s").to_pylist()
        assert [r[3] for r in got] == table.column("dec").to_pylist()
    path = tmp_path / "ours.orc"
    path.write_bytes(write_orc_bytes("port", ORC_TYPES, orc.COMPRESSION_ZLIB))
    back = pa_orc.read_table(str(path))
    want = rows(batches(ORC_TYPES, "port"))
    assert back.num_rows == len(want)
    assert back.column("c2").to_pylist() == [r[2] for r in want]
    assert back.column("c7").to_pylist() == [r[7] for r in want]
    assert os.path.getsize(path) > 0
