"""SQL through trino_tpu_torch against the JAX reference, on the CPU.

One numpy table loads into both engines' memory connectors (the port's
side through ``trino_tpu_torch.columnar.batch_from_numpy``); the same
statements run through the reference's ``LocalQueryRunner`` and the
port's ``LocalQueryRunner(device="cpu")``. Rows must be equal as
multisets, exactly: the results are integers, or an AVG that both engines
compute as float64(integer sum) / count.

In distributed mode with ``stream_scan_threshold_rows`` below the table
size, the source fragment streams: through the dense group-by path where
the shape allows, else through the sort-based chunk step. The port's
dense wrapper counts its runs (``_kernels.PLAIN_CALLS`` on CPU
tensors; ``LAUNCHES`` counts CUDA launches only).
"""

import re

import numpy as np
import pytest

from trino_tpu import types as RT
from trino_tpu.columnar import Batch as RBatch, Column as RColumn
from trino_tpu.connectors.api import (
    ColumnSchema as RColumnSchema,
    TableSchema as RTableSchema,
)
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import _kernels
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import batch_from_numpy
from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
from trino_tpu_torch.testing import LocalQueryRunner

N = 1 << 15

Q_A = "select k, sum(v), count(*) from memory.default.t group by k"
Q_B = ("select k, sum(w), avg(v), count(*) from memory.default.t "
       "where v < 524288 group by k")
# key domain far wider than the dense path's 8192 bins: the sort-based step
Q_WIDE = "select kw, sum(v), count(*) from memory.default.t group by kw"
# NULL logic: OR with IS NULL over a column holding NULLs, global agg
Q_NULLS = ("select count(*), sum(v), count(n) from memory.default.t "
           "where v < 100000 or n is null")
# a two-key dense group-by under a NOT/AND filter
Q_KEYS2 = ("select k2, k3, sum(w), count(*) from memory.default.t "
           "where not (k2 = 1 and v > 500000) group by k2, k3")
# a computed aggregate input carries a validity mask: the sort-based step,
# as in the reference (the dense path takes null-free inputs only)
Q_ARITH = ("select k2, sum(v * 3 - w), count(*) from memory.default.t "
           "group by k2")


def _table():
    rng = np.random.default_rng(7)
    cols = {
        "k": rng.integers(0, 4096, N),
        "v": rng.integers(0, 1 << 20, N),
        "w": rng.integers(-(1 << 40), 1 << 40, N),
        "kw": rng.integers(0, 1 << 40, N) * 7,
        "k2": rng.integers(0, 5, N),
        "k3": rng.integers(-3, 20, N),
        "n": rng.integers(-50, 50, N),
    }
    valid = {"n": rng.random(N) < 0.7}
    return cols, valid


def load_table(ref: RefRunner, port: LocalQueryRunner, cols, valid) -> None:
    """Load the same numpy columns into both engines' memory catalogs."""
    names = list(cols)
    ref_mem = ref.catalogs.get("memory")
    ref_mem.create_table(
        "default", "t",
        RTableSchema("t", tuple(RColumnSchema(c, RT.BIGINT) for c in names)),
    )
    ref_mem.insert(
        "default", "t",
        RBatch(
            [RColumn(RT.BIGINT, cols[c], valid.get(c)) for c in names], N
        ),
    )
    port_mem = port.catalogs.get("memory")
    port_mem.create_table(
        "default", "t",
        TableSchema("t", tuple(ColumnSchema(c, T.BIGINT) for c in names)),
    )
    port_mem.insert(
        "default", "t",
        batch_from_numpy(
            [T.BIGINT] * len(names), [cols[c] for c in names],
            [valid.get(c) for c in names],
        ),
    )


@pytest.fixture(scope="module")
def runners():
    cols, valid = _table()
    ref = RefRunner()
    port = LocalQueryRunner(device="cpu")
    load_table(ref, port, cols, valid)
    for r in (ref, port):
        r.session.set("execution_mode", "distributed")
        r.session.set("stream_scan_threshold_rows", 1 << 14)
    return ref, port


def _normalised(plan_text: str) -> str:
    """Plan text with the planner's global symbol counters stripped."""
    return re.sub(r"_\d+\b", "_#", plan_text)


def _run_both(runners, sql, mode):
    ref, port = runners
    for r in runners:
        r.session.set("execution_mode", mode)
    try:
        want, want_names = ref.execute(sql)
        before = _kernels.PLAIN_CALLS["dense_groupby"]
        res = port.engine.execute_statement(sql, port.session)
        dense_runs = _kernels.PLAIN_CALLS["dense_groupby"] - before
    finally:
        for r in runners:
            r.session.set("execution_mode", "distributed")
    assert res.column_names == want_names
    assert sorted(res.rows) == sorted(want)
    return res, dense_runs


@pytest.mark.parametrize("sql", [Q_A, Q_B, Q_KEYS2], ids=["Q-A", "Q-B", "two-keys"])
def test_dense_path_matches_reference(runners, sql):
    res, dense_runs = _run_both(runners, sql, "distributed")
    assert dense_runs == 1  # the source fragment went through the kernel
    assert sorted(res.fragment_modes.values()) == [
        "materialized", "materialized", "streamed"
    ]
    assert len(res.rows) > 4000 or sql == Q_KEYS2


@pytest.mark.parametrize(
    "sql", [Q_WIDE, Q_NULLS, Q_ARITH], ids=["wide-keys", "nulls", "arith"]
)
def test_non_dense_shapes_stream(runners, sql):
    """Shapes the dense path refuses stream through the sort-based step."""
    res, dense_runs = _run_both(runners, sql, "distributed")
    assert dense_runs == 0
    assert "streamed" in res.fragment_modes.values()


@pytest.mark.parametrize(
    "sql", [Q_A, Q_B, Q_NULLS], ids=["Q-A", "Q-B", "nulls"]
)
def test_local_mode_matches_reference(runners, sql):
    res, dense_runs = _run_both(runners, sql, "local")
    assert dense_runs == 0 and res.fragment_modes is None


@pytest.mark.parametrize("sql", [Q_A, Q_B], ids=["Q-A", "Q-B"])
def test_optimized_plans_match_reference(runners, sql):
    ref, port = runners
    assert _normalised(port.explain(sql)) == _normalised(ref.explain(sql))
