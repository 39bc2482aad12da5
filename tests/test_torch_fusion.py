"""Fused units in the port (``FragmentedExecutor._fusion_units``,
``run_fused_program``) against the reference's (``tests/test_fusion.py``,
the cases that need no cluster and no multi-shard mesh): the
eligibility matrix, equal to the reference's grouping of the same plans;
fused rows equal to unfused rows over the TPC-H corpus with
``join_distribution_type=PARTITIONED``; a 3-fragment chain in at most 2
host round trips; the fallback census of ``tests/test_tpch_fused.py``;
and the capacity-halving ladder, driven by an injected
``torch.cuda.OutOfMemoryError``.
"""

import pytest
import torch

from test_tpch_fused import EXPECTED_FALLBACK
from trino_tpu.exec import fragments as RF
from trino_tpu.planner import fragmenter as RFR
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import types as T
from trino_tpu_torch.benchmarks.tpch import queries
from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.exec import fragments as F
from trino_tpu_torch.exec.local import Result
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.fragmenter import (
    FusedFragment,
    fragment_plan,
    fuse_groups,
    partitioned_join_pairs,
)
from trino_tpu_torch.testing import LocalQueryRunner

torch.set_num_threads(1)

PARTITIONED = {"execution_mode": "distributed", "join_distribution_type": "PARTITIONED"}
QUERIES = queries("tpch.tiny")
JOIN_SQL = """
    select o_orderpriority, count(*) as c, sum(l_extendedprice) as s
    from tpch.tiny.orders o
    join tpch.tiny.lineitem l on o.o_orderkey = l.l_orderkey
    group by o_orderpriority
    order by o_orderpriority
"""


def _runner(**props) -> LocalQueryRunner:
    r = LocalQueryRunner(device="cpu")
    for k, v in {**PARTITIONED, **props}.items():
        r.session.set(k, v)
    return r


def _ref_subplan(sql):
    r = RefRunner()
    for k, v in PARTITIONED.items():
        r.session.set(k, v)
    return RFR.fragment_plan(r.plan(sql))


def _unit_ids(units) -> list:
    return [u.fragment_ids if hasattr(u, "fragment_ids") else (u.id,) for u in units]


@pytest.fixture(scope="module")
def fused():
    return _runner()


@pytest.fixture(scope="module")
def unfused():
    return _runner(pipeline_fusion=False, program_cache=False)


# === the eligibility matrix ===================================================


def test_fusable_chain_forms_one_unit(fused):
    sub = fragment_plan(fused.plan(JOIN_SQL), fused.session)
    units = fuse_groups(sub, fusable=F.fragment_fusable)
    unit = max((u for u in units if isinstance(u, FusedFragment)),
               key=lambda u: len(u.fragments))
    assert len(unit.fragments) >= 3 and unit.root is unit.fragments[-1]
    assert sorted(f for ids in _unit_ids(units) for f in ids) == sorted(
        f.id for f in sub.all_fragments())
    ref = RFR.fuse_groups(_ref_subplan(JOIN_SQL), fusable=RF.fragment_fusable)
    assert _unit_ids(units) == _unit_ids(ref)


def test_blocked_fragment_stays_on_per_fragment_path(fused):
    sub = fragment_plan(fused.plan(JOIN_SQL), fused.session)
    scan_fid = next(f.id for f in sub.all_fragments()
                    if any(isinstance(n, P.TableScan) for n in P.walk_plan(f.root)))
    units = fuse_groups(sub, fusable=F.fragment_fusable, blocked=frozenset({scan_fid}))
    assert all(scan_fid not in u.fragment_ids for u in units if isinstance(u, FusedFragment))


def test_spill_threshold_feeds_the_blocked_set():
    r = _runner()
    sub = fragment_plan(r.plan(JOIN_SQL), r.session)
    ex = F.FragmentedExecutor(r.engine.catalogs, r.session, "cpu")
    assert ex._fusion_blocked(sub) == set()
    r.session.set("spill_enabled", True)
    r.session.set("spill_threshold_rows", 1)
    assert ex._fusion_blocked(sub) == set()  # graceful overflow: dense joins
    r.session.set("dense_join", False)
    scans = {f.id for f in sub.all_fragments()
             if any(isinstance(n, P.TableScan) for n in P.walk_plan(f.root))}
    assert scans <= ex._fusion_blocked(sub)
    r.session.set("dense_join", True)
    r.session.set("join_strategy", "sort")
    assert scans <= ex._fusion_blocked(sub)


def test_skew_pair_absorbed_atomically(fused):
    sub = fragment_plan(fused.plan(JOIN_SQL), fused.session)
    pairs = partitioned_join_pairs(sub)
    probe, build = pairs[0]
    units = fuse_groups(sub, fusable=F.fragment_fusable, skew_pairs=pairs)
    unit = next(u for u in units if isinstance(u, FusedFragment)
                and {probe, build} & set(u.fragment_ids))
    assert {probe, build} <= set(unit.fragment_ids)
    for u in fuse_groups(sub, fusable=F.fragment_fusable, skew_pairs=pairs, max_fragments=2):
        if isinstance(u, FusedFragment):
            assert len({probe, build} & set(u.fragment_ids)) != 1


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_units_equal_the_reference(fused, qid):
    """The port groups every TPC-H plan into the units the reference
    groups it into."""
    sub = fragment_plan(fused.plan(QUERIES[qid]), fused.session)
    ref = _ref_subplan(QUERIES[qid])
    got = fuse_groups(sub, fusable=F.fragment_fusable, broadcast_links=True)
    want = RFR.fuse_groups(ref, fusable=RF.fragment_fusable, broadcast_links=True)
    assert _unit_ids(got) == _unit_ids(want)


def test_fallback_census(fused):
    """The TPC-H plans with a fragment no program takes are the
    reference's census."""
    fallbacks = {q for q, sql in QUERIES.items()
                 if not F.query_fusable(fragment_plan(fused.plan(sql), fused.session))}
    assert fallbacks == EXPECTED_FALLBACK


# === rows and round trips =====================================================


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_fused_matches_unfused(fused, unfused, qid):
    got = fused.engine.execute_statement(QUERIES[qid], fused.session)
    want = unfused.engine.execute_statement(QUERIES[qid], unfused.session)
    assert got.rows == want.rows
    if qid not in EXPECTED_FALLBACK and got.exchange_stats.get("fusedFragments"):
        assert not want.exchange_stats.get("fusedFragments")


def test_chain_runs_in_at_most_two_round_trips(fused, unfused):
    sub = fragment_plan(fused.plan(JOIN_SQL), fused.session)
    assert len(sub.all_fragments()) >= 3
    res = fused.engine.execute_statement(JOIN_SQL, fused.session)
    ex = res.exchange_stats
    assert ex["dispatchRoundTrips"] <= 2 and ex["fusedFragments"] >= 3
    assert ex["host_reads"] <= 2
    res_u = unfused.engine.execute_statement(JOIN_SQL, unfused.session)
    assert res_u.exchange_stats.get("fusedFragments", 0) == 0
    assert res_u.exchange_stats["dispatchRoundTrips"] > ex["dispatchRoundTrips"]
    assert res.rows == res_u.rows


def test_repeat_query_hits_fused_program_cache(fused):
    first = fused.engine.execute_statement(JOIN_SQL, fused.session)
    again = fused.engine.execute_statement(JOIN_SQL, fused.session)
    assert again.rows == first.rows
    assert again.trace_count == 0 and again.program_cache_hits > 0


# === the capacity-halving ladder =============================================


def test_shrink_all_halves_and_floors():
    caps = F._Caps()
    caps.get("join", 1024)
    caps.get("small", 64)
    assert caps.shrink_all() is True
    assert caps.vals == {"join": 512, "small": 64}
    assert caps.provenance["join"].endswith("+halved")
    while caps.shrink_all():
        pass
    assert all(v == 64 for v in caps.vals.values()) and caps.shrink_all() is False


def test_resource_exhausted_classifier():
    assert F._is_resource_exhausted(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    assert F._is_resource_exhausted(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))
    assert not F._is_resource_exhausted(ValueError("syntax error"))


def _ladder_executor():
    r = _runner()
    ex = F.FragmentedExecutor(r.engine.catalogs, r.session, "cpu")
    return ex


def test_retry_traced_halves_until_the_program_fits():
    """A program that runs out of memory above 1024 slots: the ladder
    halves every capacity (4096 -> 2048 -> 1024) instead of failing, and
    counts each halving."""
    ex = _ladder_executor()
    caps = F._Caps()
    caps.get("buf", 4096)

    def build(meta):
        def fn(inp):
            if caps.vals["buf"] > 1024:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")
            x = inp["remote0"].columns[0].data
            res = Result(Batch([Column(T.BIGINT, x + 1)], x.shape[0]), {"x": 0})
            summary = F._TracerSummary()
            meta.capture(res, summary)
            return res, F._Meta.words(summary, "cpu")

        return fn

    inp = {"remote0": Batch([Column(T.BIGINT, torch.arange(8))], 8)}
    out = ex._retry_traced(caps, build, inp, {"remote0"}, ("frag", 0, 0))
    assert caps.vals["buf"] == 1024 and caps.provenance["buf"].endswith("+halved")
    assert ex.exchange_stats["compile_halvings"] == 2
    assert out.batch.columns[0].data.tolist() == list(range(1, 9))


def test_non_resource_errors_still_raise():
    ex = _ladder_executor()
    caps = F._Caps()
    caps.get("buf", 4096)

    def build(meta):
        def fn(inp):
            raise ValueError("genuine bug, not capacity")

        return fn

    inp = {"remote0": Batch([Column(T.BIGINT, torch.arange(4))], 4)}
    with pytest.raises(ValueError, match="genuine bug"):
        ex._retry_traced(caps, build, inp, {"remote0"}, ("frag", 0, 0))
    assert caps.vals["buf"] == 4096


def test_out_of_memory_evicts_least_recently_used_programs_first():
    """The ladder's first out-of-memory drops the least recently used
    programs until those left hold half the stored bytes, the second
    drops the rest, the third halves the capacities."""
    from trino_tpu_torch.exec.programs import Program, ProgramPool

    r = _runner()
    pool = ProgramPool("cpu")
    store = {}
    ex = F.FragmentedExecutor(r.engine.catalogs, r.session, "cpu", programs=store, pool=pool)
    for k in (10, 11, 12, 13):
        store[(("frag", k), ())] = Program(("frag", k), f"frag:{k}", None, None)
        store[(("frag", k), ())].held_bytes = 100
        pool.touch(store, (("frag", k), ()))
    pool.touch(store, (("frag", 10), ()))  # 10 is the most recently used
    caps = F._Caps()
    caps.get("buf", 4096)
    ooms, left = [], []

    def build(meta):
        def fn(inp):
            if len(ooms) < 3:
                ooms.append(caps.vals["buf"])
                left.append(sorted(k[0][1] for k in store if isinstance(k, tuple)
                                   and len(k) == 2 and isinstance(k[0], tuple)))
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
            x = inp["remote0"].columns[0].data
            res = Result(Batch([Column(T.BIGINT, x * 2)], x.shape[0]), {"x": 0})
            summary = F._TracerSummary()
            meta.capture(res, summary)
            return res, F._Meta.words(summary, "cpu")

        return fn

    inp = {"remote0": Batch([Column(T.BIGINT, torch.arange(4))], 4)}
    out = ex._retry_traced(caps, build, inp, {"remote0"}, ("frag", 0, 0))
    assert ooms == [4096, 4096, 4096]
    assert left == [[10, 11, 12, 13], [10, 13], []]
    assert ex.exchange_stats["program_evictions"] == 2
    assert ex.exchange_stats["compile_halvings"] == 1 and caps.vals["buf"] == 2048
    assert out.batch.columns[0].data.tolist() == [0, 2, 4, 6]


def test_out_of_memory_evicts_the_pool_before_halving():
    """With programs stored, the first out-of-memory evicts the pool's
    least recently used programs and retries at the same capacities; the
    next one halves."""
    from trino_tpu_torch.exec.programs import Program, ProgramPool

    r = _runner()
    pool = ProgramPool("cpu")
    store = {}
    ex = F.FragmentedExecutor(r.engine.catalogs, r.session, "cpu", programs=store, pool=pool)
    for k in range(3):  # three stored programs of other fragments
        store[(("frag", 10 + k), ())] = Program(("frag", 10 + k), f"frag:{10 + k}", None, None)
        pool.touch(store, (("frag", 10 + k), ()))
    caps = F._Caps()
    caps.get("buf", 4096)
    ooms = []

    def build(meta):
        def fn(inp):
            if len(ooms) < 2:
                ooms.append(caps.vals["buf"])
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
            x = inp["remote0"].columns[0].data
            res = Result(Batch([Column(T.BIGINT, x * 2)], x.shape[0]), {"x": 0})
            summary = F._TracerSummary()
            meta.capture(res, summary)
            return res, F._Meta.words(summary, "cpu")

        return fn

    inp = {"remote0": Batch([Column(T.BIGINT, torch.arange(4))], 4)}
    out = ex._retry_traced(caps, build, inp, {"remote0"}, ("frag", 0, 0))
    assert ooms == [4096, 4096]  # evicted first, at the same capacity
    assert ex.exchange_stats["program_evictions"] == 1
    assert ex.exchange_stats["compile_halvings"] == 1 and caps.vals["buf"] == 2048
    assert not any(k[0][1] >= 10 for k in store if isinstance(k, tuple) and len(k) == 2
                   and isinstance(k[0], tuple))
    assert out.batch.columns[0].data.tolist() == [0, 2, 4, 6]
