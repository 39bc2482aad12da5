"""trino_tpu_torch's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a GPU: a
CUDA kernel has no CPU mode. The file imports neither JAX nor the
reference package, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Integer results throughout: the tolerance is zero.
"""

import numpy as np
import pytest
import torch

from trino_tpu_torch import _kernels
from trino_tpu_torch.ops import dense_groupby as D

N = 1 << 15

# (G, (nonneg, bits) per column, pair128 per column, value makers): the
# slice's shape (a), a signed 128-bit sum (b), mixed columns near M=4096 (c)
PLANS = {
    "a": (4096, [(True, 20)], [False],
          lambda r, n: [r.integers(0, 1 << 20, n)]),
    "b": (128, [(False, 64)], [True],
          lambda r, n: [r.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)]),
    "c": (8192, [(True, 30), (False, 64), (True, 62)], [False, True, True],
          lambda r, n: [r.integers(0, 1 << 30, n),
                        r.integers(-(1 << 40), 1 << 40, n),
                        r.integers(0, 1 << 62, n)]),
}


# K2 edge cases as (slot bases, use flags, capacity, window), shared with
# the CPU emulation of the kernel's round protocol
def k2_edge_case(name):
    rng = np.random.default_rng(17)
    n = 1 << 12
    if name == "random":
        return rng.integers(0, 1 << 14, n), rng.random(n) < 0.9, 1 << 14, 16
    if name == "dup-chains":  # 100 keys, ~40 rows a base: chains past W
        slots = rng.permutation(1 << 14)[:100]
        return slots[rng.integers(0, 100, n)], rng.random(n) < 0.9, 1 << 14, 16
    if name == "too-small":  # 4096 rows, 1024 slots
        return rng.integers(0, 1 << 10, n), np.ones(n, bool), 1 << 10, 16
    if name == "bases-5-5-6":
        return np.array([5, 5, 6]), np.ones(3, bool), 16, 2
    if name == "empty":
        return np.zeros(0, np.int64), np.zeros(0, bool), 64, 16
    if name == "all-dead":
        return rng.integers(0, 1024, 1000), np.zeros(1000, bool), 1024, 16
    raise KeyError(name)


K2_EDGE_CASES = ["random", "dup-chains", "too-small", "bases-5-5-6", "empty",
                 "all-dead"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PLANS))
def test_dense_groupby_kernel_matches_plain(cuda, name):
    G, cols, pair, make = PLANS[name]
    rng = np.random.default_rng(5)
    plan = D.DensePlan(
        G=G, cols=tuple(D.DenseCol(*c) for c in cols), pair128=tuple(pair)
    )
    # ~10% dead rows (bin == G), as a filter leaves them
    bins = np.where(rng.random(N) < 0.9, rng.integers(0, G, N), G)
    b = torch.from_numpy(bins.astype(np.int32)).to(cuda)
    v = [torch.from_numpy(x.astype(np.int64)).to(cuda) for x in make(rng, N)]
    before = _kernels.LAUNCHES["dense_groupby"]
    lt = D.dense_groupby_device(plan, b, v)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["dense_groupby"] == before + 1
    assert torch.equal(lt, D.dense_groupby_plain(plan, b, v))


def _plan(G, cols, pair):
    return D.DensePlan(
        G=G, cols=tuple(D.DenseCol(*c) for c in cols), pair128=tuple(pair)
    )


@pytest.mark.cuda
def test_dense_groupby_flushes_past_2_to_the_32(cuda):
    """One block, 2^25 rows all in bin 0, every value -1: every limb is
    255, each lane's total passes 2^32, so the uint32 counters are exact
    only because the block flushes every 2^24 rows."""
    n = 1 << 25
    plan = _plan(128, [(False, 64)], [True])
    launch = D.k1_launch_plan(plan, 132, n, blocks=1)
    assert len(launch.slices) == 1 and launch.rows_per_flush < n
    b = torch.zeros(n, dtype=torch.int32, device=cuda)
    v = [torch.full((n,), -1, dtype=torch.int64, device=cuda)]
    lt = D.dense_groupby_cuda(plan, b, v, blocks=1)
    want = D.dense_groupby_plain(plan, b, v)
    assert int(want[:8, 0].min()) == 255 * n > 1 << 32
    assert torch.equal(lt, want)


# plans that need more than one lane slice: the slice's plan c, 60 columns
# in three launch groups, and the largest plan the dense path admits
SLICED = {
    "c": PLANS["c"][:3],
    "groups": (128, [(False, 64)] * 60, [True] * 60),
    "max-m": (8192, [(False, 64)] * 7, [False] * 7),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SLICED))
def test_dense_groupby_lane_slices_match_plain(cuda, name):
    plan = _plan(*SLICED[name])
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    launch = D.k1_launch_plan(plan, sms, N)
    assert len(launch.slices) > 1
    assert (len(launch.groups) > 1) == (name == "groups")
    if name == "max-m":
        assert plan.m == 4096
    rng = np.random.default_rng(6)
    b = torch.from_numpy(
        np.where(rng.random(N) < 0.9, rng.integers(0, plan.G, N), plan.G)
        .astype(np.int32)).to(cuda)
    v = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, N)).to(cuda)
         for _ in plan.cols]
    assert torch.equal(D.dense_groupby_device(plan, b, v),
                       D.dense_groupby_plain(plan, b, v))


@pytest.mark.cuda
def test_dense_groupby_hot_cells_match_plain(cuda):
    """G = 128 and every row live: per-warp copies of 1,280 hot cells."""
    n = 1 << 22
    plan = _plan(*PLANS["b"][:3])
    assert D.k1_launch_plan(plan, 132, n).copies == 32
    rng = np.random.default_rng(8)
    b = torch.from_numpy(rng.integers(0, 128, n).astype(np.int32)).to(cuda)
    v = [torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                       dtype=np.int64)).to(cuda)]
    assert torch.equal(D.dense_groupby_device(plan, b, v),
                       D.dense_groupby_plain(plan, b, v))


@pytest.mark.cuda
def test_group_by_query_launches_the_kernel(cuda):
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import batch_from_numpy
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
    from trino_tpu_torch.testing import LocalQueryRunner

    rng = np.random.default_rng(7)
    k = rng.integers(0, 4096, N)
    v = rng.integers(0, 1 << 20, N)
    runner = LocalQueryRunner(device=cuda)
    runner.session.set("execution_mode", "distributed")
    runner.session.set("stream_scan_threshold_rows", 1 << 14)
    mem = runner.catalogs.get("memory")
    mem.create_table(
        "default", "t",
        TableSchema("t", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))),
    )
    mem.insert("default", "t", batch_from_numpy([T.BIGINT] * 2, [k, v]))
    before = _kernels.LAUNCHES["dense_groupby"]
    rows, _ = runner.execute(
        "select k, sum(v), count(*) from memory.default.t group by k"
    )
    assert _kernels.LAUNCHES["dense_groupby"] == before + 1
    counts = np.bincount(k, minlength=4096)
    sums = np.bincount(k, weights=v, minlength=4096).astype(np.int64)  # < 2^53
    want = [(g, int(sums[g]), int(counts[g])) for g in np.flatnonzero(counts)]
    assert sorted(rows) == want


# (key domain, capacity) for K2 at n = 2^15: random keys, duplicate
# chains past the 16-slot window, a table too small for the rows
K2_CASES = {"random": (1 << 40, 1 << 17), "dup-chains": (1000, 1 << 17),
            "overflow": (1 << 40, 1 << 14)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_dense_join_build_kernel_matches_plain(cuda, case):
    from trino_tpu_torch.ops import dense_join as DJ
    from trino_tpu_torch.ops import join as J

    domain, cap = K2_CASES[case]
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(rng.integers(0, domain, N)).to(cuda)
    use = torch.from_numpy(rng.random(N) < 0.9).to(cuda)
    base = DJ.slot_base_hash(J.hash_keys([(keys, use)])[0], cap)
    before = _kernels.LAUNCHES["dense_join_build"]
    table, unplaced = DJ.build_table_device(base, use, cap)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["dense_join_build"] == before + 1
    ptable, punplaced = DJ.build_table_plain(base, use, cap)
    assert torch.equal(table, ptable)
    assert int(unplaced) == int(punplaced)
    assert (int(unplaced) > 0) == (case != "random")


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_EDGE_CASES)
def test_dense_join_build_edge_cases_match_plain(cuda, case):
    from trino_tpu_torch.ops import dense_join as DJ

    base_np, use_np, cap, window = k2_edge_case(case)
    base = torch.from_numpy(base_np.astype(np.int32)).to(cuda)
    use = torch.from_numpy(use_np).to(cuda)
    table, unplaced, lens = DJ.build_table_cuda(base, use, cap, window)
    ptable, punplaced = DJ.build_table_plain(base, use, cap, window)
    assert torch.equal(table, ptable)
    assert int(unplaced) == int(punplaced) == int(lens[window])
    lens = lens.tolist()
    assert lens[0] == int(use_np.sum())
    assert lens[0] - lens[window] == int((table != DJ.EMPTY).sum())  # placed


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1 << 20, 1 << 27])
def test_dense_join_build_buckets_and_windows_match_plain(cuda, cap):
    """Tables of 64 slot buckets (2^20 slots), and of 4096 buckets twice
    as wide as round 0's shared window (2^27 slots)."""
    from trino_tpu_torch.ops import dense_join as DJ

    rng = np.random.default_rng(19)
    n = 1 << 18
    keys = rng.integers(0, 1 << 16, n)  # duplicates: later rounds run too
    slots = rng.integers(0, cap, 1 << 16)
    base = torch.from_numpy(slots[keys].astype(np.int32)).to(cuda)
    use = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    table, unplaced, lens = DJ.build_table_cuda(base, use, cap, 16)
    ptable, punplaced = DJ.build_table_plain(base, use, cap, 16)
    assert torch.equal(table, ptable) and int(unplaced) == int(punplaced)
    assert int(lens[1]) > 0


@pytest.mark.cuda
def test_dense_join_build_raises_instead_of_falling_back(cuda):
    from trino_tpu_torch.ops import dense_join as DJ

    base = torch.zeros(64, dtype=torch.int32, device=cuda)
    use = torch.ones(64, dtype=torch.bool)
    with pytest.raises(ValueError):
        DJ.build_table_device(base, use, 256)  # use on the CPU
    with pytest.raises(ValueError):
        DJ.build_table_device(base, use.to(cuda), 384)  # not a power of two


@pytest.mark.cuda
def test_join_queries_launch_the_build_kernel(cuda):
    from chip_smoke import JOIN_QUERIES, load_tpch, tpch_oracle, tpch_tables
    from trino_tpu_torch.testing import LocalQueryRunner

    tables = tpch_tables(0.01, seed=7)
    want = tpch_oracle(tables)
    runner = LocalQueryRunner(device=cuda)
    runner.session.set("execution_mode", "distributed")
    load_tpch(runner, tables)
    for name, sql in JOIN_QUERIES.items():
        before = _kernels.LAUNCHES["dense_join_build"]
        rows, _ = runner.execute(sql)
        assert (rows if name == "Q-J1" else sorted(rows)) == want[name]
        if name != "Q-J3":  # the semi join probes the sort tier
            assert _kernels.LAUNCHES["dense_join_build"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["local", "distributed"])
def test_tpch_queries_on_the_card_equal_the_cpu(cuda, mode):
    """The 22 TPC-H queries at ``tpch.tiny`` on the card return the rows
    and column types they return on the CPU (rows whose ORDER BY keys tie
    as a multiset); the join-build kernel launches in distributed mode."""
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.testing import LocalQueryRunner

    runners = [LocalQueryRunner(device=d) for d in ("cpu", cuda)]
    for r in runners:
        r.session.set("execution_mode", mode)
    before = _kernels.LAUNCHES["dense_join_build"]
    for q, sql in B.queries("tpch.tiny").items():
        cpu, card = (r.engine.execute_statement(sql, r.session) for r in runners)
        assert [t.name for t in card.column_types] == [t.name for t in cpu.column_types]
        order = B.order_positions(runners[0].plan(sql))
        bad = B.first_mismatch(B.canonical_rows(card.rows),
                               B.canonical_rows(cpu.rows), order)
        assert bad is None, f"Q{q}: {bad}"
    if mode == "distributed":
        assert _kernels.LAUNCHES["dense_join_build"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["local", "distributed"])
def test_tpcds_queries_on_the_card_equal_the_answers(cuda, mode):
    """The 64 TPC-DS queries at ``tpcds.tiny`` on the card return the
    reference's committed rows and column types; the join-build kernel
    launches in distributed mode."""
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.benchmarks.tpcds import ANSWERS_TINY, queries
    from trino_tpu_torch.testing import LocalQueryRunner

    answers = B.load_answers(ANSWERS_TINY)["queries"]
    runner = LocalQueryRunner(device=cuda)
    runner.session.set("execution_mode", mode)
    before = _kernels.LAUNCHES["dense_join_build"]
    for q, sql in queries("tpcds.tiny").items():
        res = runner.engine.execute_statement(sql, runner.session)
        want = answers[str(q)]
        assert [t.name for t in res.column_types] == want["types"], f"Q{q}"
        bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"], want["order_by"])
        assert bad is None, f"Q{q}: {bad}"
    if mode == "distributed":
        assert _kernels.LAUNCHES["dense_join_build"] > before


@pytest.mark.cuda
def test_table_cache_budget_is_a_quarter_of_the_card(cuda):
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.engine import Engine, table_cache_budget

    engine = Engine(device=cuda)
    total = torch.cuda.get_device_properties(engine.device).total_memory
    assert engine.memory_pool.capacity == total
    assert table_cache_budget(Session(), engine.memory_pool, engine.device) == total // 4
