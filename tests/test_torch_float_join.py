"""Joins on floating-point keys and ``matmul_join_counts`` in
trino_tpu_torch against the JAX reference, on the CPU.

The reference joins DOUBLE and REAL keys on the float64 bit pattern with
+0 and -0 made equal, a DECIMAL or integer side converted to DOUBLE
first, and NULL keys matching nothing (``trino_tpu/exec/local.py``
``_join_keys`` and ``_f64_key``). The same memory tables load into both
engines; each join runs through the port's interpreter
(``execution_mode=local``) and its fragment executor (``distributed``),
and its rows must equal the reference interpreter's exactly.
"""

import numpy as np
import pytest
import torch

from trino_tpu import types as RT
from trino_tpu.columnar import Batch as RBatch, Column as RColumn
from trino_tpu.connectors.api import ColumnSchema as RColumnSchema, TableSchema as RTableSchema
from trino_tpu.ops.dense_join import matmul_join_counts as ref_matmul_join_counts
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import batch_from_numpy
from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
from trino_tpu_torch.ops.dense_join import matmul_join_counts
from trino_tpu_torch.testing import LocalQueryRunner

torch.set_num_threads(1)

NAN = float("nan")
# (name, {column: (type name, values, valid)}): NULL rows carry a value
# that would match if NULLs were not excluded
TABLES = {
    "f1": {"a": ("double", [0.0, -0.0, 1.5, 1.5, 2.0, 2.25, 3.0, 4.0], [1, 1, 1, 1, 0, 1, 1, 1]),
           "x": ("bigint", list(range(8)), None)},
    "f2": {"b": ("double", [-0.0, 1.5, 2.0, 2.25, 7.0, 0.0, 3.0], [1, 1, 0, 1, 1, 1, 1]),
           "y": ("bigint", list(range(10, 17)), None)},
    "r1": {"c": ("real", [0.5, -0.0, 1.25, 8.0, 3.5], [1, 1, 1, 1, 0]),
           "x": ("bigint", list(range(5)), None)},
    "r2": {"d": ("real", [0.0, 0.5, 0.5, 3.5, 9.0], [1, 1, 1, 1, 1]),
           "y": ("bigint", list(range(10, 15)), None)},
    # DECIMAL(10,2) cents: 0.00, 1.50, 2.25, 3.00, NULL, 7.00
    "d1": {"e": ("dec", [0, 150, 225, 300, 200, 700], [1, 1, 1, 1, 0, 1]),
           "z": ("bigint", list(range(20, 26)), None)},
}
QUERIES = {
    "double": "select x, y from memory.default.f1 join memory.default.f2 on a = b",
    "double-left": "select x, y, b from memory.default.f1 left join memory.default.f2 on a = b",
    "real": "select x, y from memory.default.r1 join memory.default.r2 on c = d",
    "decimal-double": "select z, y from memory.default.d1 join memory.default.f2 on e = b",
    "double-semi": "select x from memory.default.f1 where a in (select b from memory.default.f2)",
    "double-group": (
        "select b, count(*) from memory.default.f1 join memory.default.f2 on a = b group by b"
    ),
}


def _types(mod):
    return {"double": mod.DOUBLE, "real": mod.REAL, "bigint": mod.BIGINT,
            "dec": mod.decimal(10, 2)}


@pytest.fixture(scope="module")
def runners():
    ref = RefRunner()
    port = LocalQueryRunner(device="cpu")
    rmem, pmem = ref.catalogs.get("memory"), port.catalogs.get("memory")
    rtypes, ptypes = _types(RT), _types(T)
    for name, cols in TABLES.items():
        rmem.create_table("default", name, RTableSchema(
            name, tuple(RColumnSchema(c, rtypes[t]) for c, (t, _, _) in cols.items())))
        pmem.create_table("default", name, TableSchema(
            name, tuple(ColumnSchema(c, ptypes[t]) for c, (t, _, _) in cols.items())))
        n = len(next(iter(cols.values()))[1])
        rcols = []
        for t, vals, valid in cols.values():
            v = None if valid is None else np.asarray(valid, dtype=np.bool_)
            rcols.append(RColumn(rtypes[t], np.asarray(vals, dtype=rtypes[t].storage_dtype), v))
        rmem.insert("default", name, RBatch(rcols, n))
        pmem.insert("default", name, batch_from_numpy(
            [ptypes[t] for t, _, _ in cols.values()],
            [np.asarray(vals) for _, vals, _ in cols.values()],
            [None if valid is None else np.asarray(valid, dtype=np.bool_)
             for _, _, valid in cols.values()],
        ))
    return ref, port


@pytest.fixture(scope="module")
def want(runners):
    ref, _ = runners
    return {name: sorted(ref.execute(sql)[0], key=repr) for name, sql in QUERIES.items()}


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_float_keys_join_as_the_reference(runners, want, name, mode):
    _, port = runners
    port.session.set("execution_mode", mode)
    try:
        rows, _ = port.execute(QUERIES[name])
    finally:
        port.session.set("execution_mode", "local")
    assert sorted(rows, key=repr) == want[name]


def test_signed_zeros_and_nulls_match_as_sql_says(want):
    """+0 matches -0 (four pairs among the zeros), NULL keys match nothing."""
    zeros = [(x, y) for x, y in want["double"] if x in (0, 1)]
    assert sorted(zeros) == [(0, 10), (0, 15), (1, 10), (1, 15)]
    assert not any(x == 4 or y == 12 for x, y in want["double"])


def test_matmul_join_counts_matches_the_reference():
    rng = np.random.default_rng(3)
    domain = 512
    probe = rng.integers(0, domain, 5000).astype(np.int32)
    build = rng.integers(0, domain, 3000).astype(np.int32)
    puse = rng.random(5000) < 0.9
    buse = rng.random(3000) < 0.8
    got = matmul_join_counts(torch.from_numpy(probe), torch.from_numpy(build),
                             torch.from_numpy(puse), torch.from_numpy(buse), domain)
    want = np.asarray(ref_matmul_join_counts(probe, build, puse, buse, domain))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    hist = np.bincount(build[buse], minlength=domain)
    assert np.array_equal(got.numpy(), np.where(puse, hist[probe], 0))
