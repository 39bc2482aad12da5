"""The designs of the port's CUDA kernels, checked on the CPU.

A CUDA kernel cannot run here, but what surrounds it can:

* K1 (``csrc/dense_groupby.cu``): the launch plan that
  ``ops/dense_groupby.py::k1_launch_plan`` computes (lane slices, launch
  groups, per-warp copies, rows between flushes) and the descriptors the
  wrapper passes by value. A torch emulation walks the descriptors as the
  kernel does (block by block, flushing uint32 counters) and must equal
  the plain version.
* K2 (``csrc/dense_join_build.cu``): its round protocol (the live rows
  ordered by slot bucket, round 0 one bucket at a time in a shared window,
  proposals tagged with bit 30 by atomicMin, commits that store the plain
  id, worklists of the unplaced rows), emulated step by step in torch. It must equal
  ``build_table_plain`` and the reference's jnp ``build_table``
  elementwise.

Everything compared is an integer: the tolerance is zero.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from test_torch_cuda import K2_EDGE_CASES, k2_edge_case
from trino_tpu.ops import dense_join as RDJ
from trino_tpu_torch.exec.streaming import _MAX_BINS, _MAX_M
from trino_tpu_torch.ops import dense_groupby as D
from trino_tpu_torch.ops import dense_join as DJ

SMS = 132  # multiprocessors of an H100 SXM


def plan_of(G, cols, pair):
    return D.DensePlan(
        G=G, cols=tuple(D.DenseCol(*c) for c in cols), pair128=tuple(pair)
    )


# chip_smoke.py's plans a-c, and the largest plans the dense path admits
PLANS = {
    "a": plan_of(4096, [(True, 20)], [False]),
    "b": plan_of(128, [(False, 64)], [True]),
    "c": plan_of(8192, [(True, 30), (False, 64), (True, 62)], [False, True, True]),
    "max-m-G128": plan_of(128, [(False, 64)] * 455, [True] * 455),
    "max-m-G8192": plan_of(_MAX_BINS, [(False, 64)] * 7, [False] * 7),
}


def check_launch(plan, launch, n):
    """The launch plan's invariants: every live lane in exactly one slice,
    every slice and descriptor within its budget, exact flushes."""
    cols, ops = D.lane_ops(plan)
    live = [l for l, op in enumerate(ops) if op != D._OP_ZERO]
    assert [l for sl in launch.slices for l in sl] == live
    assert all(sl for sl in launch.slices)
    assert launch.max_lanes == max(len(sl) for sl in launch.slices)
    assert launch.smem_bytes == launch.copies * launch.max_lanes * 4 * plan.G
    assert launch.smem_bytes <= D.SMEM_BLOCK_BYTES
    assert launch.copies & (launch.copies - 1) == 0
    assert launch.copies <= D.K1_THREADS // 32
    for g in launch.groups:
        gcols = {cols[l] for sl in g.slices for l in sl if ops[l] != D._OP_COUNT}
        assert set(g.cols) == gcols and len(g.cols) <= D.K1_MAX_COLS
        assert len(g.slices) <= D.K1_MAX_SLICES
        assert sum(map(len, g.slices)) <= D.K1_MAX_LANES
        assert 1 <= g.blocks <= max(1, -(-n // D.K1_TILE_ROWS))
    assert 0 < launch.rows_per_flush <= 1 << 24
    assert launch.rows_per_flush % D.K1_TILE_ROWS == 0
    assert 255 * launch.rows_per_flush < 1 << 32


@pytest.mark.parametrize("name", sorted(PLANS))
def test_k1_launch_plan_fits_the_card(name):
    plan = PLANS[name]
    assert plan.m <= _MAX_M
    launch = D.k1_launch_plan(plan, SMS, 1 << 25)
    check_launch(plan, launch, 1 << 25)
    want = {"a": (1, 2), "b": (1, 32), "c": (4, 1)}  # (slices, copies)
    if name in want:
        assert (len(launch.slices), launch.copies) == want[name]
        assert len(launch.groups) == 1
        assert launch.groups[0].blocks * len(launch.slices) <= SMS
    else:
        assert plan.m == _MAX_M and len(launch.slices) > 1


@settings(max_examples=60, deadline=None)
@given(
    tiles=st.integers(1, _MAX_BINS // 128),
    cols=st.lists(
        st.tuples(st.booleans(), st.integers(1, 64), st.booleans()),
        min_size=1, max_size=40,
    ),
    n=st.integers(0, 1 << 26),
    sms=st.sampled_from([1, 8, 132]),
)
def test_k1_launch_plan_sweep(tiles, cols, n, sms):
    plan = plan_of(128 * tiles, [(nn, b) for nn, b, _ in cols], [p for *_, p in cols])
    if plan.m > _MAX_M:
        return  # the dense path runs such a plan materialized
    check_launch(plan, D.k1_launch_plan(plan, sms, n), n)


def emulate_k1(plan, launch, bins, vals):
    """csrc/dense_groupby.cu in torch, from the descriptors the wrapper
    builds: per group, slice and block, uint32 counters for the slice's
    lanes, flushed into lt every ``rows_per_flush`` rows of the block."""
    G, L, n = plan.G, plan.lanes, bins.shape[0]
    lt = torch.zeros(plan.m * 128, dtype=torch.int64)
    # fake column "pointers" 16 * (index + 1), read back from the slot
    descs = D.k1_descriptors(plan, launch, [16 * (c + 1) for c in range(len(vals))])
    tile_rows = D.K1_TILE_ROWS
    ntiles = -(-n // tile_rows)
    for d in descs:
        for s in range(d.nslices):
            words = list(d.lane)[d.slice_begin[s]:d.slice_begin[s + 1]]
            for x in range(d.blocks):
                mine = [t for t in range(x, ntiles, d.blocks)]
                per = launch.rows_per_flush // tile_rows
                for f in range(0, len(mine), per):
                    rows = torch.cat([torch.arange(t * tile_rows, min(n, (t + 1) * tile_rows))
                                      for t in mine[f:f + per]] or [torch.zeros(0, dtype=torch.int64)])
                    b = bins[rows].to(torch.int64)
                    ok = (b >= 0) & (b < G)
                    cnt = torch.zeros(len(words) * G, dtype=torch.int64)
                    for j, w in enumerate(words):
                        lane, op, c = w & 0xFFFF, (w >> 16) & 255, w >> 24
                        if op == D._OP_COUNT:
                            add = torch.ones_like(b)
                        else:
                            v = vals[d.cols[c] // 16 - 1][rows]
                            add = (v < 0).to(torch.int64) if op == D._OP_SIGN else (v >> op) & 255
                        cnt.index_add_(0, j * G + b[ok], add[ok])
                    assert int(cnt.max()) < 1 << 32  # uint32 exact
                    for j, w in enumerate(words):
                        lane = w & 0xFFFF
                        g = torch.arange(G)
                        lt.index_add_(0, ((g >> 7) * L + lane) * 128 + (g & 127),
                                      cnt[j * G:(j + 1) * G])
    return lt.reshape(plan.m, 128)


@pytest.mark.parametrize("name,blocks,flush", [
    ("a", None, None), ("b", 3, 1), ("c", 2, 2), ("max-m-G8192", None, 1),
])
def test_k1_descriptors_drive_the_kernel_to_plain(name, blocks, flush):
    """The lane words, column slots and slice bounds, walked as the kernel
    walks them, give the plain version's totals; ``flush`` (in tiles) makes
    the blocks flush mid-run as they do past 2^24 rows."""
    plan = PLANS[name]
    n = 3 * D.K1_TILE_ROWS + 77
    launch = D.k1_launch_plan(plan, 4, n, blocks)
    if flush is not None:
        launch = dataclasses.replace(launch, rows_per_flush=flush * D.K1_TILE_ROWS)
    rng = np.random.default_rng(2)
    bins = torch.from_numpy(np.where(rng.random(n) < 0.9, rng.integers(0, plan.G, n),
                                     plan.G).astype(np.int32))
    vals = [torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64))
            for _ in plan.cols]
    assert torch.equal(emulate_k1(plan, launch, bins, vals),
                       D.dense_groupby_plain(plan, bins, vals))


def test_k1_descriptor_words_decode_to_the_lane_table():
    plan = PLANS["max-m-G128"]
    launch = D.k1_launch_plan(plan, SMS, 1 << 20)
    assert len(launch.groups) > 1
    cols, ops = D.lane_ops(plan)
    ptrs = [1000 + 16 * c for c in range(len(plan.cols))]
    seen = []
    for d, g in zip(D.k1_descriptors(plan, launch, ptrs), launch.groups):
        assert d.nslices == len(g.slices) and d.blocks == g.blocks
        assert [d.cols[i] for i in range(len(g.cols))] == [ptrs[c] for c in g.cols]
        for j in range(d.slice_begin[d.nslices]):
            w = d.lane[j]
            lane, op, slot = w & 0xFFFF, (w >> 16) & 255, w >> 24
            assert op == ops[lane]
            if op != D._OP_COUNT:
                assert g.cols[slot] == cols[lane]
            seen.append(lane)
    assert seen == [l for l, op in enumerate(ops) if op != D._OP_ZERO]


EMPTY = DJ.EMPTY
PROPOSAL = 1 << 30  # the tag of a proposal while the build runs


def emulate_k2(base, use, cap, window, seed=0, max_buckets=4096, win_slots=16384):
    """csrc/dense_join_build.cu step by step (``max_buckets`` and
    ``win_slots`` are its kMaxBuckets and kWindow): returns (table, lens)
    with lens[d] the rows entering round d. Appends keep no order, so the
    rows are shuffled wherever the kernel appends."""
    perm = np.random.default_rng(seed).permutation

    def shuffled(w):
        return w[torch.from_numpy(perm(len(w)))]

    mask = cap - 1
    nb = min(max_buckets, max(1, cap // win_slots))
    span = cap // nb
    win = min(span, win_slots)
    # never filled: round 0 writes every slot
    table = torch.full((cap,), -7, dtype=torch.int32)
    # the compaction: live rows as (row, base), in any order, then the scan
    # and the scatter order them by bucket (in no order inside a bucket)
    live = torch.nonzero(use).reshape(-1)
    work = shuffled(torch.stack([live, base[live].to(torch.int64)], 1))
    bucket = (work[:, 1] & mask) // span
    order = torch.argsort(bucket, stable=True)
    work, bucket = work[order], bucket[order]
    lens = [len(work)]
    # round 0: a block a bucket, window by window in shared memory
    losers = []
    for k in range(nb):
        wk = work[bucket == k]
        for w0 in range(k * span, (k + 1) * span, win):
            slots = torch.full((win,), EMPTY, dtype=torch.int32)
            s_ = (wk[:, 1] & mask) - w0
            inw = (s_ >= 0) & (s_ < win)
            rows, s_ = wk[inw, 0].to(torch.int32), s_[inw]
            slots.scatter_reduce_(0, s_, rows + PROPOSAL, "amin")
            won = slots[s_] == rows + PROPOSAL
            slots[s_[won]] = rows[won]
            losers.append(shuffled(wk[inw][~won]))
            table[w0:w0 + win] = slots
    work = torch.cat(losers) if losers else work[:0]
    lens.append(len(work))
    # rounds 1..W-1 on the table
    for d in range(1, window):
        rows, b = work[:, 0].to(torch.int32), work[:, 1]
        slot = (b + d) & mask
        # at the start of every round each occupied slot holds a committed
        # (untagged) id
        assert bool((table[table != EMPTY] < PROPOSAL).all())
        # propose: one atomicMin of the tagged id per row, no read before it
        table.scatter_reduce_(0, slot, rows + PROPOSAL, "amin")
        # commit: the winner stores its plain id; losers go on
        won = table[slot] == rows + PROPOSAL
        table[slot[won]] = rows[won]
        work = shuffled(work[~won])
        lens.append(len(work))
    return table, lens


@pytest.mark.parametrize("case", K2_EDGE_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_k2_round_protocol_equals_plain_and_reference(case, seed):
    base_np, use_np, cap, window = k2_edge_case(case)
    base = torch.from_numpy(base_np.astype(np.int32))
    use = torch.from_numpy(use_np)
    table, lens = emulate_k2(base, use, cap, window, seed)
    ptable, unplaced = DJ.build_table_plain(base, use, cap, window)
    assert torch.equal(table, ptable)
    assert lens[window] == int(unplaced)
    assert lens[0] == int(use.sum())
    rtable, rovf = RDJ.build_table(
        jnp.asarray(base_np.astype(np.int32)), jnp.asarray(use_np),
        jnp.ones(len(use_np), bool), cap, window,
    )
    np.testing.assert_array_equal(np.asarray(rtable), table.numpy())
    assert bool(rovf) == (lens[window] > 0)
    if case in ("dup-chains", "too-small", "bases-5-5-6"):
        assert lens[window] > 0
    if case in ("empty", "all-dead"):
        assert lens == [0] * (window + 1)


@pytest.mark.parametrize("case", ["random", "dup-chains", "too-small"])
@pytest.mark.parametrize("max_buckets,win_slots", [(4, 64), (16, 256), (64, 4096)])
def test_k2_buckets_and_windows_equal_plain(case, max_buckets, win_slots):
    """Round 0 over many buckets, and over buckets wider than the shared
    window, as the kernel runs it on tables of 2^17 slots and more: the
    kernel's constants scaled down so the CPU reaches both."""
    base_np, use_np, cap, window = k2_edge_case(case)
    base = torch.from_numpy(base_np.astype(np.int32))
    use = torch.from_numpy(use_np)
    table, lens = emulate_k2(base, use, cap, window, 3, max_buckets, win_slots)
    ptable, unplaced = DJ.build_table_plain(base, use, cap, window)
    assert torch.equal(table, ptable)
    assert lens[window] == int(unplaced)
