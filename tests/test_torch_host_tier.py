"""trino_tpu_torch's host tier (parser, analyzer, planner, civil-date
math) against the JAX reference, on the CPU.

The host tier is the reference's own code with its device ties cut, so
the same statement over the same catalog must give the same optimized
plan text (the planner's global symbol counters stripped), and the
civil-date helpers that replace the reference's jnp versions must give
the same integers. Exact equality throughout.
"""

import re

import numpy as np
import pytest

from trino_tpu import compiler as RC
from trino_tpu import types as RT
from trino_tpu.columnar import Batch as RBatch, Column as RColumn
from trino_tpu.connectors.api import (
    ColumnSchema as RColumnSchema,
    TableSchema as RTableSchema,
)
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import civil
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import batch_from_numpy
from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
from trino_tpu_torch.testing import LocalQueryRunner

TABLES = {
    # name: (rows, {column: (port type, reference type)})
    "orders": (2048, {"o_id": (T.BIGINT, RT.BIGINT), "o_cust": (T.BIGINT, RT.BIGINT),
                      "o_total": (T.BIGINT, RT.BIGINT), "o_date": (T.DATE, RT.DATE)}),
    "cust": (256, {"c_id": (T.BIGINT, RT.BIGINT), "c_region": (T.BIGINT, RT.BIGINT)}),
}

QUERIES = {
    "filter-project": "select o_id, o_total * 2 from memory.default.orders "
                      "where o_total > 10 and o_cust < 50",
    "having": "select o_cust, count(*) from memory.default.orders "
              "group by o_cust having count(*) > 3",
    "order-limit": "select o_id, o_total from memory.default.orders "
                   "order by o_total desc, o_id limit 10",
    "join": "select c_region, sum(o_total) from memory.default.orders "
            "join memory.default.cust on o_cust = c_id group by c_region",
    "dates": "select count(*) from memory.default.orders "
             "where o_date >= date '1995-03-15' "
             "and o_date < date '1995-03-15' + interval '3' month",
    "global-agg": "select min(o_total), max(o_total), avg(o_total) "
                  "from memory.default.orders where o_cust in (1, 2, 3)",
}


@pytest.fixture(scope="module")
def runners():
    rng = np.random.default_rng(3)
    ref, port = RefRunner(), LocalQueryRunner(device="cpu")
    for name, (n, cols) in TABLES.items():
        data = {c: rng.integers(0, 9000 if c == "o_date" else 100, n) for c in cols}
        ref_mem = ref.catalogs.get("memory")
        ref_mem.create_table("default", name, RTableSchema(
            name, tuple(RColumnSchema(c, rt) for c, (_, rt) in cols.items())))
        ref_mem.insert("default", name, RBatch(
            [RColumn(rt, data[c].astype(rt.storage_dtype), None)
             for c, (_, rt) in cols.items()], n))
        port_mem = port.catalogs.get("memory")
        port_mem.create_table("default", name, TableSchema(
            name, tuple(ColumnSchema(c, t) for c, (t, _) in cols.items())))
        port_mem.insert("default", name, batch_from_numpy(
            [t for t, _ in cols.values()], [data[c] for c in cols]))
    return ref, port


def _normalised(plan_text: str) -> str:
    return re.sub(r"_\d+\b", "_#", plan_text)


@pytest.mark.parametrize("sql", QUERIES.values(), ids=QUERIES.keys())
def test_optimized_plan_text_matches_reference(runners, sql):
    ref, port = runners
    assert _normalised(port.explain(sql)) == _normalised(ref.explain(sql))


def test_civil_from_days_matches_reference():
    days = np.arange(-800_000, 800_000, 997, dtype=np.int64)
    want = RC._civil_from_days(days)
    got = civil.civil_from_days(days)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize(
    "ymd", [(1970, 1, 1), (1969, 12, 31), (2000, 2, 29), (1900, 3, 1),
            (1, 1, 1), (-44, 3, 15), (9999, 12, 31)],
)
def test_days_from_civil_matches_reference(ymd):
    assert civil.days_from_civil(*ymd) == RC.days_from_civil(*ymd)
