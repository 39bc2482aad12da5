"""Cross-query batching in the port (``exec/batching.py`` and
``FragmentedExecutor.execute_batched``) against the reference's contract
(``tests/test_batching.py``, outside resource-group admission): K
concurrent literal variants share one batch, K replays of one program
with one host read, and equal their sequential runs and the reference's
rows bit for bit; a batch that fails falls back to sequential runs in
which a failing member fails alone; ``batch_window_ms=0`` never touches
the collector.
"""

import threading
import time

import numpy as np
import pytest
import torch

from trino_tpu import types as RT
from trino_tpu.columnar import Batch as RBatch, Column as RColumn
from trino_tpu.connectors.api import ColumnSchema as RColumnSchema, TableSchema as RTableSchema
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import batch_from_numpy
from trino_tpu_torch.config import Session
from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
from trino_tpu_torch.engine import Engine
from trino_tpu_torch.testing import LocalQueryRunner

torch.set_num_threads(1)

Q = ("select k, sum(v), count(*) from memory.default.bt_facts"
     " where v < {} group by k order by k")


def _columns(rows: int = 2048, seed: int = 7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 32, rows).astype(np.int64),
            rng.integers(0, 1000, rows).astype(np.int64))


@pytest.fixture(scope="module")
def runner():
    r = LocalQueryRunner(Session(user="t", catalog="memory", schema="default"), device="cpu")
    r.session.set("execution_mode", "distributed")
    mem = r.catalogs.get("memory")
    mem.create_table("default", "bt_facts", TableSchema(
        "bt_facts", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))))
    mem.insert("default", "bt_facts", batch_from_numpy([T.BIGINT, T.BIGINT], list(_columns())))
    return r


@pytest.fixture(scope="module")
def reference():
    ref = RefRunner()
    mem = ref.catalogs.get("memory")
    mem.create_table("default", "bt_facts", RTableSchema(
        "bt_facts", (RColumnSchema("k", RT.BIGINT), RColumnSchema("v", RT.BIGINT))))
    k, v = _columns()
    mem.insert("default", "bt_facts",
               RBatch([RColumn(RT.BIGINT, k), RColumn(RT.BIGINT, v)], len(k)))
    return ref


def _batch_session(runner, window_ms: int = 5000, max_size: int = 4) -> Session:
    s = Session(user="t", catalog="memory", schema="default")
    s.properties.update(runner.session.properties)
    s.set("batch_window_ms", window_ms)
    s.set("batch_max_size", max_size)
    return s


def _run_concurrent(runner, lits, session_fn):
    """One query a literal, each from its own thread; ``max_size`` equal
    to the member count flushes the batch as soon as all have joined."""
    results, errors = {}, {}

    def work(lit):
        try:
            results[lit] = runner.engine.execute_statement(Q.format(lit), session_fn())
        except Exception as e:  # noqa: BLE001
            errors[lit] = e

    threads = [threading.Thread(target=work, args=(lit,)) for lit in lits]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errors


def test_batched_bit_identical_to_sequential(runner, reference):
    lits = (100, 250, 500, 750)
    seq = {lit: runner.engine.execute_statement(Q.format(lit), runner.session) for lit in lits}
    hits_before = runner.engine.batch_collector.dispatches.get(len(lits), 0)
    results, errors = _run_concurrent(
        runner, lits, lambda: _batch_session(runner, max_size=len(lits)))
    assert not errors, errors
    assert runner.engine.batch_collector.dispatches[len(lits)] == hits_before + 1
    for lit in lits:
        assert results[lit].rows == seq[lit].rows == reference.execute(Q.format(lit))[0]
        bs = results[lit].batch_stats
        assert bs["batchSize"] == bs["batchedQueries"] == len(lits)
        assert bs["batchWaitMs"] >= 0.0
        ex = results[lit].exchange_stats
        assert ex["batchedQueries"] == len(lits)
        # the members replayed the program the sequential runs stored,
        # and their words came back in one read for the group
        assert results[lit].trace_count == 0
        assert results[lit].program_cache_hits >= len(lits) - 1
        assert ex["host_reads"] == 1


def test_window_zero_is_todays_behavior(runner):
    """batch_window_ms=0, the default, never reaches the collector."""
    calls = []
    orig = runner.engine.batch_collector.submit
    runner.engine.batch_collector.submit = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        res = runner.engine.execute_statement(Q.format(300), runner.session)
    finally:
        runner.engine.batch_collector.submit = orig
    assert calls == [] and res.batch_stats is None


def test_solo_query_in_window_runs_single(runner):
    seq = runner.engine.execute_statement(Q.format(421), runner.session)
    res = runner.engine.execute_statement(
        Q.format(421), _batch_session(runner, window_ms=30, max_size=8))
    assert res.rows == seq.rows and res.batch_stats is None


def test_batched_failure_falls_back_sequentially(runner):
    lits = (120, 340, 560)
    seq = {lit: runner.engine.execute_statement(Q.format(lit), runner.session) for lit in lits}
    orig = Engine._execute_query_plan_batched

    def boom(self, *a, **k):
        raise RuntimeError("injected batch failure")

    Engine._execute_query_plan_batched = boom
    try:
        results, errors = _run_concurrent(
            runner, lits, lambda: _batch_session(runner, max_size=len(lits)))
    finally:
        Engine._execute_query_plan_batched = orig
    assert not errors, errors
    for lit in lits:
        assert results[lit].rows == seq[lit].rows
        assert results[lit].batch_stats is None


def test_failing_member_fails_alone(runner):
    lits = (130, 350, 570)
    seq = {lit: runner.engine.execute_statement(Q.format(lit), runner.session) for lit in lits}
    orig_batched, orig_single = Engine._execute_query_plan_batched, Engine._execute_query_plan

    def boom(self, *a, **k):
        raise RuntimeError("injected batch failure")

    def poisoned_single(self, plan, session, *a, **k):
        if any(v == 350 for v, _ in k.get("params") or []):
            raise RuntimeError("injected member failure")
        return orig_single(self, plan, session, *a, **k)

    Engine._execute_query_plan_batched = boom
    Engine._execute_query_plan = poisoned_single
    try:
        results, errors = _run_concurrent(
            runner, lits, lambda: _batch_session(runner, max_size=len(lits)))
    finally:
        Engine._execute_query_plan_batched = orig_batched
        Engine._execute_query_plan = orig_single
    assert set(errors) == {350}
    assert "injected member failure" in str(errors[350])
    for lit in (130, 570):
        assert results[lit].rows == seq[lit].rows


def test_window_timeout_flushes_partial_batch(runner):
    t0 = time.monotonic()
    res = runner.engine.execute_statement(
        Q.format(777), _batch_session(runner, window_ms=50, max_size=64))
    assert res.rows and time.monotonic() - t0 < 30.0


def test_incompatible_sessions_do_not_share_a_batch(runner):
    """Members whose session overrides differ run in separate groups."""
    a = _batch_session(runner, window_ms=200, max_size=2)
    b = _batch_session(runner, window_ms=200, max_size=2)
    b.set("batch_capacity", 1 << 15)
    out = {}

    def work(name, sess, lit):
        out[name] = runner.engine.execute_statement(Q.format(lit), sess)

    threads = [threading.Thread(target=work, args=("a", a, 610)),
               threading.Thread(target=work, args=("b", b, 620))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out["a"].batch_stats is None and out["b"].batch_stats is None
