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


@pytest.mark.cuda
def test_ctas_table_group_by_launches_the_kernel(cuda):
    """A memory table made by CREATE TABLE AS from the tpch connector, then
    a small-domain GROUP BY over it: the dense path launches K1 over the
    staged slab, each launch equal to its plain version on the same
    tensors, and the rows equal the same query over the source and the
    CPU's (where the engine runs the plain version)."""
    from trino_tpu_torch.testing import LocalQueryRunner

    runners = [LocalQueryRunner(device=d) for d in ("cpu", cuda)]
    q = ("select l_linenumber, sum(l_quantity), count(*) from {} group by"
         " l_linenumber")
    real, errs = D.dense_groupby_device, []

    def checked(plan, bins, vals):
        lt = real(plan, bins, vals)
        errs.append(int((lt - D.dense_groupby_plain(plan, bins, vals)).abs().max()))
        return lt

    out = []
    for r in runners:
        r.session.set("execution_mode", "distributed")
        r.session.set("stream_scan_threshold_rows", 1 << 14)
        res = r.engine.execute_statement(
            "create table memory.default.li1 as select l_orderkey, l_linenumber,"
            " l_quantity from tpch.tiny.lineitem", r.session,
        )
        assert res.update_count == 60175
        before = _kernels.LAUNCHES["dense_groupby"]
        D.dense_groupby_device = checked
        try:
            rows = sorted(r.execute(q.format("memory.default.li1"))[0])
        finally:
            D.dense_groupby_device = real
        launched = _kernels.LAUNCHES["dense_groupby"] - before
        assert rows == sorted(r.execute(q.format("tpch.tiny.lineitem"))[0])
        out.append((rows, launched))
    assert out[0][0] == out[1][0] and len(out[0][0]) == 7
    assert out[1][1] == 1  # K1 on the card (the CPU runs its plain version)
    assert len(errs) == 2 and max(errs) == 0


@pytest.mark.cuda
def test_rollup_over_a_join_launches_the_build_kernel(cuda):
    """ROLLUP over lineitem ⋈ orders with a FILTER count and a VARCHAR max
    on the card: the join builds through K2, every build equals
    ``build_table_plain`` on the same inputs, and the rows equal the
    CPU's and the reference's. The reference's rows are committed as their
    count and the SHA-256 of their canonical text (the reference needs JAX,
    which a GPU machine need not have); ``tests/test_torch_grouping.py``
    holds the same digest, case ``surface_rollup``, and its ``slow`` test
    recomputes it with the reference."""
    import hashlib

    from trino_tpu_torch.ops import dense_join as DJ
    from trino_tpu_torch.testing import LocalQueryRunner

    sql = ("select o_orderpriority, l_returnflag, count(*), sum(l_quantity),"
           " count(*) filter (where l_discount > 0.05), max(o_clerk)"
           " from tpch.tiny.lineitem join tpch.tiny.orders on l_orderkey = o_orderkey"
           " group by rollup(o_orderpriority, l_returnflag)")
    real, errs = DJ.build_table_cuda, []

    def checked(slot_base, use, capacity, window):
        out = real(slot_base, use, capacity, window)
        ptable, punplaced = DJ.build_table_plain(slot_base, use, capacity, window)
        errs.append(int((out[0].to(torch.int64) - ptable.to(torch.int64)).abs().max())
                    + abs(int(out[1]) - int(punplaced)))
        return out

    rows = []
    for d in ("cpu", cuda):
        r = LocalQueryRunner(device=d)
        r.session.set("execution_mode", "distributed")
        before = _kernels.LAUNCHES["dense_join_build"]
        DJ.build_table_cuda = checked
        try:
            rows.append(sorted(r.execute(sql)[0], key=repr))
        finally:
            DJ.build_table_cuda = real
        if d == cuda:
            assert _kernels.LAUNCHES["dense_join_build"] > before
    assert rows[0] == rows[1] and len(rows[0]) == 21
    assert errs and max(errs) == 0
    canonical = sorted(rows[1], key=lambda row: tuple(
        (0, "") if v is None else (1, repr(v)) for v in row))
    assert hashlib.sha256(repr(canonical).encode()).hexdigest() == (
        "2e9e3c00d5bddbff422e7e452d63e200abd3f6a0357ea7cd10b7d7354d3323fe")


@pytest.mark.cuda
def test_coalesced_pinned_copy_equals_per_column_copies(cuda):
    """One pinned staging buffer and one copy carry every buffer of a scan
    (selection, data, valid masks, DECIMAL(38) lane pairs) to the card,
    equal to copying each buffer on its own."""
    from trino_tpu_torch import ingest
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch, Column, batch_from_numpy

    rng = np.random.default_rng(3)
    n = 1 << 20
    b = batch_from_numpy(
        [T.BIGINT, T.VARCHAR, T.DOUBLE, T.BOOLEAN, T.INTEGER, T.REAL],
        [rng.integers(-9, 9, n), np.array(["x", "yy", "z"])[rng.integers(0, 3, n)],
         rng.random(n), rng.random(n) < 0.5, rng.integers(0, 99, n), rng.random(n)],
        [None, rng.random(n) < 0.7, None, rng.random(n) < 0.5, None, None],
    )
    cols = b.columns + [Column(T.decimal(38, 2),
                               torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, (n, 2))))]
    b = Batch(cols, n, torch.from_numpy(rng.random(n) < 0.9))
    stats: dict = {}
    out = ingest.to_device(b, cuda, coalesced=True, min_bytes=0, stats=stats)
    plain = b.to(cuda)
    torch.cuda.synchronize()
    assert stats["h2d_transfers"] == 1 and stats["coalesced_columns"] == len(cols)
    assert stats["h2d_bytes"] >= sum(t.numel() * t.element_size() for t in ingest._buffers(b))
    for x, y in zip(out.columns, plain.columns):
        assert x.data.device.type == "cuda" and x.data.dtype == y.data.dtype
        assert torch.equal(x.data, y.data)
        assert (x.valid is None) == (y.valid is None)
        assert x.valid is None or torch.equal(x.valid, y.valid)
    assert torch.equal(out.sel, plain.sel)
    per_column: dict = {}
    ingest.to_device(b, cuda, coalesced=False, stats=per_column)
    assert per_column["h2d_transfers"] == len(ingest._buffers(b))


@pytest.mark.cuda
def test_tpch_q3_over_parquet_launches_k2_equal_to_plain(cuda, tmp_path):
    """TPC-H Q3 at tiny over a Parquet catalog the port wrote: the rows of
    the tpch catalog, K2 launching with every build equal to plain."""
    from chip_smoke import k2_against_plain
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.connectors.api import register_catalog_spec
    from trino_tpu_torch.testing import LocalQueryRunner

    runner = LocalQueryRunner(device=cuda)
    runner.session.set("execution_mode", "distributed")
    register_catalog_spec(runner.engine.catalogs, f"pq=parquet:{tmp_path}")
    for t in ("customer", "orders", "lineitem"):
        runner.execute(f"create table pq.tiny.{t} as select * from tpch.tiny.{t}")
    want, _ = runner.execute(B.queries("tpch.tiny")[3])
    sql = B.queries("pq.tiny")[3]
    before = _kernels.LAUNCHES["dense_join_build"]
    rows, _ = runner.execute(sql)
    assert rows == want and _kernels.LAUNCHES["dense_join_build"] > before
    builds = k2_against_plain(runner, {"Q3": sql})
    assert builds and all(b["max_abs_err"] == 0 and b["unplaced_err"] == 0 for b in builds)


@pytest.mark.cuda
def test_synthetic_device_chunks_equal_the_host_path(cuda):
    from chip_smoke import synth_gen
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
    from trino_tpu_torch.connectors.synthetic import SyntheticConnector

    conn = SyntheticConnector(split_rows=1 << 16)
    conn.add_table("default", "events", TableSchema(
        "events", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))),
        10 ** 9, synth_gen)
    make_chunk, rows = conn.device_generator("default", "events", ["k", "v"], device=cuda)
    # the last split: idx * 2654435761 near 2^61.2
    last = conn.get_splits("default", "events", 1 << 20)[-1]
    per = -(-rows // last.total)
    off = last.index * per
    chunk = Batch(make_chunk(off, rows - off), rows - off)
    assert chunk.columns[0].data.device.type == "cuda"
    host = conn.read_split("default", "events", ["k", "v"], last)
    assert host.num_rows == rows - off and chunk.to_pylist() == host.to_pylist()


@pytest.mark.cuda
def test_fused_q3_program_replays_literal_variants(cuda):
    """TPC-H Q3 at ``tpch.tiny`` through the program cache: its cold run
    captures its fragments' and fused units' CUDA graphs; two literal
    variants then replay them, each whole run under
    ``programs.checked_syncs`` (sync debug mode ``"error"`` but for the
    counted host reads), each equal to the same text run eagerly with
    the program cache off."""
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.exec.programs import checked_syncs
    from trino_tpu_torch.testing import LocalQueryRunner

    r = LocalQueryRunner(device=cuda)
    r.session.set("execution_mode", "distributed")
    eager = LocalQueryRunner(engine=r.engine)
    eager.session.set("execution_mode", "distributed")
    eager.session.set("program_cache", False)
    sql = B.queries("tpch.tiny")[3]
    before = r.engine.program_pool.captures
    cold = r.engine.execute_statement(sql, r.session)
    assert cold.trace_count >= 1 and r.engine.program_pool.captures > before
    assert cold.exchange_stats.get("fusedFragments", 0) >= 2
    for day in ("1995-03-08", "1995-03-22"):
        variant = sql.replace("date '1995-03-15'", f"date '{day}'")
        with checked_syncs(cuda):
            hit = r.engine.execute_statement(variant, r.session)
        want = r.engine.execute_statement(variant, eager.session)
        assert hit.program_cache_hits >= 1
        assert hit.rows == want.rows and hit.rows


@pytest.mark.cuda
def test_program_pool_stays_within_its_budget(cuda):
    """Captures past the program pool's budget: with the budget cut to
    4 MiB, the TPC-H queries at ``tpch.tiny`` capture one program after
    another, and after every query the generations' segments are at or
    under the budget; a warm repeat of the last query still hits its
    stored program, and every run's rows equal the first run's."""
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.testing import LocalQueryRunner

    r = LocalQueryRunner(device=cuda)
    r.session.set("execution_mode", "distributed")
    pool = r.engine.program_pool
    # a few MiB: the pool's smallest segments are 2 MiB, so the captures
    # pass it even where they reuse each other's scratch
    pool.budget_bytes = 4 << 20
    qs = B.queries("tpch.tiny")
    first = {}
    for q in (1, 3, 5, 6, 10, 12):
        first[q] = r.engine.execute_statement(qs[q], r.session).rows
        reserved = pool.reserved_bytes() or 0
        assert reserved <= pool.budget_bytes, (q, reserved)
    assert pool.captures >= 6 and pool.dropped >= 1
    warm = r.engine.execute_statement(qs[12], r.session)
    assert warm.program_cache_hits >= 1 and warm.rows == first[12]
    assert (pool.reserved_bytes() or 0) <= pool.budget_bytes
    for q in (1, 3):
        assert r.engine.execute_statement(qs[q], r.session).rows == first[q]


@pytest.mark.cuda
def test_sharded_scan_is_one_pinned_copy(cuda):
    """A scan on 4 shards of the card (``DistributedExecutor._sharded_scan``,
    the counterpart of the reference's ``ingest.shard_batch_coalesced``):
    the shards' host parts are assembled into one shard-major batch and
    moved in one pinned copy, and the rows equal a mesh of one's."""
    from trino_tpu_torch.testing import DistributedQueryRunner, LocalQueryRunner

    sql = ("select l_returnflag, count(*), sum(l_quantity) from lineitem "
           "group by l_returnflag")
    r = DistributedQueryRunner(n_devices=4, device=cuda)
    r.session.set("coalesce_min_bytes", 0)
    res = r.engine.execute_statement(sql, r.session)
    st = res.ingest_stats
    assert st["h2d_transfers"] == 1 and st["h2d_bytes"] > 0, st
    one = LocalQueryRunner(device=cuda)
    assert sorted(res.rows) == sorted(one.engine.execute_statement(sql, one.session).rows)


@pytest.mark.cuda
def test_group_by_over_http_launches_the_kernel(cuda):
    """Q-A at 2^22 rows through the port's server and client: K1 launches
    for the statement sent over HTTP, and the rows equal the same
    statement run in-process on the same engine."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.client import ClientSession, Connection
    from trino_tpu_torch.columnar import batch_from_numpy
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.server.http import TrinoTpuServer

    n = 1 << 22
    rng = np.random.default_rng(7)
    k = rng.integers(0, 4096, n)
    v = rng.integers(0, 1 << 20, n)
    engine = Engine(device=cuda)
    mem = engine.catalogs.get("memory")
    mem.create_table(
        "default", "qa",
        TableSchema("qa", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))),
    )
    mem.insert("default", "qa", batch_from_numpy([T.BIGINT] * 2, [k, v]))
    props = {"execution_mode": "distributed", "stream_scan_threshold_rows": 1 << 20}
    sql = "select k, sum(v), count(*) from memory.default.qa group by k"
    server = TrinoTpuServer(engine=engine).start()
    try:
        before = _kernels.LAUNCHES["dense_groupby"]
        rows, _ = Connection(server.base_uri, ClientSession(properties=dict(props))).execute(sql)
        assert _kernels.LAUNCHES["dense_groupby"] > before
    finally:
        server.stop()
    local = engine.execute_statement(sql, Session(properties=dict(props)))
    assert sorted(rows) == sorted(local.rows)
    counts = np.bincount(k, minlength=4096)
    assert sorted(rows)[:3] == [(g, int(v[k == g].sum()), int(counts[g])) for g in range(3)]


def _qa_engine(cuda, n=1 << 22):
    """An engine on the card with ``memory.default.qa`` (``n`` rows of k in
    [0, 4096) and v), and Q-A's SQL and session properties."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import batch_from_numpy
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
    from trino_tpu_torch.engine import Engine

    rng = np.random.default_rng(7)
    k = rng.integers(0, 4096, n)
    v = rng.integers(0, 1 << 20, n)
    engine = Engine(device=cuda)
    mem = engine.catalogs.get("memory")
    mem.create_table("default", "qa", TableSchema(
        "qa", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))))
    mem.insert("default", "qa", batch_from_numpy([T.BIGINT] * 2, [k, v]))
    props = {"execution_mode": "distributed", "stream_scan_threshold_rows": 1 << 20}
    return engine, "select k, sum(v), count(*) from memory.default.qa group by k", props


@pytest.mark.cuda
def test_result_cache_hit_launches_no_kernel(cuda):
    """Q-A with ``result_cache`` on: the miss launches K1, the hit leaves
    K1's launch counter where it was and returns the same rows."""
    from trino_tpu_torch.config import Session

    engine, sql, props = _qa_engine(cuda)
    session = Session(properties={**props, "result_cache": True})
    before = _kernels.LAUNCHES["dense_groupby"]
    miss = engine.execute_statement(sql, session)
    after_miss = _kernels.LAUNCHES["dense_groupby"]
    assert after_miss > before and miss.result_cache_stats is None
    hit = engine.execute_statement(sql, session)
    assert _kernels.LAUNCHES["dense_groupby"] == after_miss
    assert hit.result_cache_stats["resultCacheHit"] == 1
    assert sorted(hit.rows) == sorted(miss.rows)


@pytest.mark.cuda
def test_profiled_program_reports_its_pool_bytes(cuda):
    """A captured Q-A's programs: ``temp_bytes`` is each program's
    ``capture_bytes`` (its pool growth), its peak at least its arguments
    and outputs, and the rollup's peak the largest program's."""
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.exec.programs import Program

    engine, sql, props = _qa_engine(cuda)
    res = engine.execute_statement(sql, Session(properties=dict(props)))
    fp, _ = engine.fingerprint(sql, Session(properties=dict(props)))
    programs = {p.label: p for key, e in engine._query_cache.items() if key[0] == fp
                for p in e["programs"].values() if isinstance(p, Program)}
    stats = {k: v for k, v in res.device_stats["programs"].items() if "temp_bytes" in v}
    assert stats
    for label, st in stats.items():
        assert st["temp_bytes"] == programs[label].capture_bytes
        assert st["peak_hbm_bytes"] >= st["argument_bytes"] + st["output_bytes"]
    assert res.device_stats["peak_hbm_bytes"] == max(s["peak_hbm_bytes"] for s in stats.values())


@pytest.mark.cuda
def test_fresh_engine_seeds_k2_from_history(cuda, tmp_path):
    """TPC-H Q3 at tiny on a fresh engine whose ``history_dir`` holds an
    earlier engine's run: its sites start at the history's capacities
    (``history_seeds``), with no retry, K2 launching with every build
    equal to plain, and the earlier run's rows."""
    from chip_smoke import k2_checked
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.engine import Engine

    sql = B.queries("tpch.tiny")[3]
    props = {"execution_mode": "distributed", "history_dir": str(tmp_path)}
    cold = Engine(device=cuda).execute_statement(sql, Session(properties=dict(props)))
    assert cold.exchange_stats["history_hits"] == 0
    builds = []
    before = _kernels.LAUNCHES["dense_join_build"]
    with k2_checked(builds, ["Q3"]):
        seeded = Engine(device=cuda).execute_statement(sql, Session(properties=dict(props)))
    ex = seeded.exchange_stats
    assert seeded.rows == cold.rows
    assert ex["history_hits"] == 1 and ex["history_seeds"] >= 1
    assert ex["overflow_retries"] == 0 and ex.get("compile_halvings", 0) == 0
    assert _kernels.LAUNCHES["dense_join_build"] > before
    assert builds and all(b["max_abs_err"] == 0 and b["unplaced_err"] == 0 for b in builds)


# --- the cluster tier on the card ----------------------------------------


def _query_doc(runner, marker):
    """The coordinator's document of the newest query holding ``marker``."""
    import json
    import urllib.request

    from trino_tpu_torch.server import auth

    def get(path):
        req = urllib.request.Request(runner.coordinator_uri + path, headers=auth.headers())
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read().decode())

    qs = [q for q in get("/v1/query") if marker in q["query"]]
    return get("/v1/query/" + max(qs, key=lambda q: q["createTime"])["queryId"])


@pytest.mark.cuda
def test_cluster_join_launches_k2_in_a_worker(cuda):
    """TPC-H Q3 at tiny over a coordinator and one worker process on the
    card: the worker's join tasks launch K2 (their stage's
    ``kernelLaunches``), the tasks run programs (``fused`` or
    ``fused-pipeline``), and the rows equal the in-process engine's."""
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.testing import MultiProcessQueryRunner

    sql = B.queries("tpch.tiny")[3]
    with MultiProcessQueryRunner(n_workers=1, device="cuda") as runner:
        rows, _ = runner.execute(sql, {"join_distribution_type": "PARTITIONED"})
        doc = _query_doc(runner, "revenue")
    stages = doc["queryStats"]["stages"]
    k2 = sum((st.get("kernelLaunches") or {}).get("dense_join_build", 0) for st in stages)
    assert k2 > 0, stages
    paths = {p for st in stages for p in (st.get("executionPaths") or {})}
    assert paths and paths <= {"fused", "fused-pipeline"}, paths
    local = Engine(device=cuda).execute_statement(
        sql, Session(properties={"execution_mode": "distributed"}))
    assert rows == local.rows


@pytest.mark.cuda
def test_concurrent_tasks_in_one_worker_while_one_captures(cuda):
    """Several tasks of one worker engine run at once while one of them
    captures its program as a CUDA graph, and another thread reads the
    card on the host the while: the capture (thread-local error mode,
    one capture at a time) is neither broken nor breaks the others, every
    task finishes, and a retried attempt of the captured fragment
    replays it with the same output."""
    import threading

    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.planner.fragmenter import fragment_plan
    from trino_tpu_torch.planner.serde import fragment_to_json
    from trino_tpu_torch.server.task import SqlTask
    from trino_tpu_torch.testing import LocalQueryRunner

    engine = Engine(device=cuda)
    planner = LocalQueryRunner(device="cpu")
    sub = fragment_plan(planner.plan(
        "select l_returnflag, sum(l_quantity), count(*) from tpch.tiny.lineitem"
        " group by l_returnflag"))
    leaf = next(f for f in sub.all_fragments() if not f.source_fragment_ids)
    key = next(iter({f"{n.catalog}.{n.schema}.{n.table}" for n in _scans(leaf)}))
    table = key.split(".")[-1]

    def payload(index):
        return {"fragment": fragment_to_json(leaf), "sources": {}, "session": {},
                "output_partitions": 1, "splits": {key: [
                    {"table": table, "index": index, "total": 4, "info": None}]}}

    stop = threading.Event()

    def host_reads():
        x = torch.arange(1 << 20, device=cuda)
        while not stop.is_set():
            (x * 3).sum().item()  # an allocation and a sync, eager

    reader = threading.Thread(target=host_reads, daemon=True)
    reader.start()
    captures = engine.program_pool.captures
    try:
        tasks = [SqlTask(f"cq.1.{i}", engine, payload(i)) for i in range(4)]
        for t in tasks:
            t._thread.join(timeout=300)
    finally:
        stop.set()
        reader.join(timeout=30)
    assert [t.state for t in tasks] == ["FINISHED"] * 4, [t.error for t in tasks]
    assert all(t.execution_path == "fused" for t in tasks)
    assert engine.program_pool.captures > captures
    # the first task's retry replays the program captured for its entry
    again = SqlTask("cq.1.0r2", engine, payload(0))
    again._thread.join(timeout=300)
    assert again.state == "FINISHED"
    assert again.buffer.get(0, 0, 0)[0] == tasks[0].buffer.get(0, 0, 0)[0]


def _scans(frag):
    from trino_tpu_torch.planner import plan as P

    return [n for n in P.walk_plan(frag.root) if isinstance(n, P.TableScan)]


@pytest.mark.cuda
def test_process_budgets_sum_within_the_card(cuda):
    """A coordinator and two workers on one card each hold a third of it:
    their memory pools (``/v1/status``) sum to at most the card, and a
    worker on a machine with a card refuses ``--device cpu``."""
    import json
    import os
    import subprocess
    import sys
    import urllib.request

    from trino_tpu_torch.server import auth
    from trino_tpu_torch.testing import MultiProcessQueryRunner

    total = torch.cuda.get_device_properties(cuda).total_memory
    with MultiProcessQueryRunner(n_workers=2, device="cuda") as runner:
        pools = []
        for uri in [runner.coordinator_uri, *runner.worker_uris]:
            req = urllib.request.Request(uri + "/v1/status", headers=auth.headers())
            with urllib.request.urlopen(req, timeout=30) as r:
                pools.append(json.loads(r.read().decode())["memoryInfo"]["totalNodeMemory"])
    assert len(pools) == 3 and all(p > 0 for p in pools)
    assert sum(pools) <= total
    assert max(pools) <= total // 3 + 1
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "trino_tpu_torch.server.main", "--role",
                          "worker", "--device", "cpu"], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2 and "runs on the GPU" in out.stderr


@pytest.mark.cuda
def test_verifier_local_against_distributed_launches_k1_and_k2(cuda, tmp_path, capsys):
    """The verifier's CLI with the interpreter as control and the program
    path as test, both on the card, over a K1 GROUP BY of a CTAS-made
    memory table and TPC-H Q3 at ``tpch.tiny``: 0 failures, and the run
    launches K1 and K2."""
    from trino_tpu_torch import verifier
    from trino_tpu_torch.benchmarks import tpch as B

    corpus = tmp_path / "q.sql"
    corpus.write_text(";\n".join([
        "set session stream_scan_threshold_rows = 16384",
        "create table memory.default.li1 as select l_orderkey, l_linenumber,"
        " l_quantity from tpch.tiny.lineitem",
        "select l_linenumber, sum(l_quantity), count(*) from memory.default.li1"
        " group by l_linenumber",
        B.queries("tpch.tiny")[3],
    ]) + ";\n")
    before = dict(_kernels.LAUNCHES)
    assert verifier.main(["--control", "local", "--test", "distributed",
                          "--queries", str(corpus)]) == 0
    out = capsys.readouterr().out
    assert "4 queries, 0 failures" in out and out.count(" OK ") == 4
    assert _kernels.LAUNCHES["dense_groupby"] > before["dense_groupby"]
    assert _kernels.LAUNCHES["dense_join_build"] > before["dense_join_build"]
