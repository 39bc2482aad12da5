"""Smoke test of trino_tpu_torch on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printed as it ends (any failure raises and exits non-zero):

1. device: the card's name and power limit, the time to build every
   CUDA kernel of the port from ``trino_tpu_torch/csrc/``, and what ptxas
   reports for each (registers, shared memory, spills);
2. kernel: the dense group-by kernel against its plain PyTorch version on
   the card over three lane plans at 2^25 rows; the limb totals must be
   equal bit for bit (integer sums: the tolerance is zero). Kernel, plain
   and library-call times are CUDA-event medians of 10 runs; each plan
   logs its launch plan (lane slices, blocks per slice, copies);
3. k2: the dense hash-join build kernel against its plain PyTorch version
   on the card in four plans (the orders build of Q-J2 at SF10, the same
   rows keyed on ``o_custkey`` so that duplicate chains overflow the probe
   window, a small build, and the build of Q-J1's second join); the table
   must be equal elementwise and the count of unplaced rows equal. Each
   plan also logs its worklist lengths, its launches and the rounds they
   skipped (the later rounds stop at the first empty worklist), the device
   time of one build by grid (from torch.profiler) and the device memory
   one build takes;
4. sql: ``select k, sum(v), count(*) ... group by k`` (Q-A) and a filtered
   signed-sum/avg variant (Q-B) over a 2^25-row memory table through
   ``LocalQueryRunner(device="cuda")`` in distributed mode, once cold and
   5 times warm; rows must equal a numpy oracle exactly, and the kernel's
   launch count must rise on every query;
5. join: TPC-H-shaped customer, orders and lineitem tables at SF10
   (:func:`tpch_tables`) in memory tables, and Q-J1 (TPC-H Q3), Q-J2 (a
   LEFT join) and Q-J3 (TPC-H Q4, an EXISTS semi join) through the same
   runner in distributed mode, once cold and 5 times warm; rows must equal
   a numpy oracle exactly, and the join-build kernel's launch count must
   rise on every run of Q-J1 and Q-J2.

Phases 4 and 5 each end with one warm run of each query under
``torch.profiler`` (phase ``profile``); phase 5 then times the layers of
one more warm run of each join query on the host clock (phase ``spans``).
The line before the last is a JSON
object with one entry per kernel of the path; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

ROWS = 1 << 25           # the bench.py headline's table size
KEYS = 4096              # k in [0, 4096)
VBITS = 20               # v in [0, 2^20)
WARM = 5
SF = 10                  # TPC-H scale factor of the join phase
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
L2_BYTES = 50e6          # H100 L2 cache


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


# TPC-H generation rules (TPC-H v3 §4.2.3), with BIGINT in place of DECIMAL
# (cents, discount percent), DATE (days since 1970-01-01) and the
# low-cardinality VARCHARs (codes 0-4)
TPCH_START_DAY = 8035    # 1992-01-01
TPCH_LAST_ORDER_DAY = 10440  # 1998-08-02: ENDDATE - 151 days

TPCH_COLUMNS = {
    "customer": ("c_custkey", "c_mktsegment"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_orderpriority",
               "o_shippriority"),
    "lineitem": ("l_orderkey", "l_linenumber", "l_quantity", "l_extendedprice",
                 "l_discount", "l_shipdate", "l_commitdate", "l_receiptdate"),
}


Q_J1 = (  # TPC-H Q3
    "select l_orderkey, sum(l_extendedprice * (100 - l_discount)) as revenue, "
    "o_orderdate, o_shippriority "
    "from memory.default.customer join memory.default.orders on c_custkey = o_custkey "
    "join memory.default.lineitem on l_orderkey = o_orderkey "
    "where c_mktsegment = 1 and o_orderdate < 9204 and l_shipdate > 9204 "
    "group by l_orderkey, o_orderdate, o_shippriority "
    "order by revenue desc, o_orderdate limit 10"
)
Q_J2 = (  # a LEFT join leaving about half the probe rows unmatched
    "select l_linenumber, count(*), count(o_orderkey), sum(l_quantity) "
    "from memory.default.lineitem left join (select o_orderkey from "
    "memory.default.orders where o_orderdate < 9204) o on l_orderkey = o_orderkey "
    "group by l_linenumber"
)
Q_J3 = (  # TPC-H Q4: an EXISTS semi join
    "select o_orderpriority, count(*) from memory.default.orders "
    "where o_orderdate >= 8582 and o_orderdate < 8674 and exists (select * from "
    "memory.default.lineitem where l_orderkey = o_orderkey "
    "and l_commitdate < l_receiptdate) group by o_orderpriority"
)


def tpch_tables(sf: float, seed: int) -> dict:
    """TPC-H-shaped customer, orders and lineitem columns at scale factor
    ``sf`` as int64 numpy arrays: ``{table: {column: array}}``.

    Row counts, key distributions and value ranges follow the TPC-H
    specification: sparse order keys (the first 8 of every 32), customers
    whose key is a multiple of 3 place no orders, 1-7 lines per order,
    dates relative to the order date, and the extended price as quantity
    times the part's retail price."""
    rng = np.random.default_rng(seed)
    n_cust = max(1, int(150_000 * sf))
    n_ord = max(1, int(1_500_000 * sf))
    n_part = max(1, int(200_000 * sf))
    customer = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_mktsegment": rng.integers(0, 5, n_cust),
    }
    i = np.arange(n_ord, dtype=np.int64)
    # j-th customer key that is not a multiple of 3: 1, 2, 4, 5, 7, ...
    j = rng.integers(0, n_cust - n_cust // 3, n_ord)
    odate = rng.integers(TPCH_START_DAY, TPCH_LAST_ORDER_DAY + 1, n_ord)
    orders = {
        "o_orderkey": (i // 8) * 32 + (i % 8) + 1,
        "o_custkey": 3 * (j // 2) + (j % 2) + 1,
        "o_orderdate": odate,
        "o_orderpriority": rng.integers(0, 5, n_ord),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
    }
    lines = rng.integers(1, 8, n_ord)
    n_line = int(lines.sum())
    starts = np.cumsum(lines) - lines
    line_odate = np.repeat(odate, lines)
    qty = rng.integers(1, 51, n_line)
    pk = rng.integers(1, n_part + 1, n_line)
    retail = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1_000)
    ship = line_odate + rng.integers(1, 122, n_line)
    lineitem = {
        "l_orderkey": np.repeat(orders["o_orderkey"], lines),
        "l_linenumber": np.arange(n_line, dtype=np.int64)
        - np.repeat(starts, lines) + 1,
        "l_quantity": qty,
        "l_extendedprice": qty * retail,
        "l_discount": rng.integers(0, 11, n_line),
        "l_shipdate": ship,
        "l_commitdate": line_odate + rng.integers(30, 91, n_line),
        "l_receiptdate": ship + rng.integers(1, 31, n_line),
    }
    return {"customer": customer, "orders": orders, "lineitem": lineitem}


def tpch_oracle(tables: dict) -> dict:
    """Rows of Q-J1, Q-J2 and Q-J3 over ``tpch_tables`` output, in numpy:
    each join as a binary search of the foreign key into the sorted primary
    key, each aggregate as a ``bincount``. Per-order sums stay below 2^53,
    so the float64 weights are exact."""
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    n_ord = len(o["o_orderkey"])
    # both primary keys are generated ascending: binary search joins them
    assert np.all(np.diff(c["c_custkey"]) > 0) and np.all(np.diff(o["o_orderkey"]) > 0)
    ci = np.searchsorted(c["c_custkey"], o["o_custkey"])
    oi = np.searchsorted(o["o_orderkey"], li["l_orderkey"])
    assert np.array_equal(o["o_orderkey"][oi], li["l_orderkey"])
    odate = o["o_orderdate"]

    # Q-J1 (TPC-H Q3): revenue per order, top 10 by revenue desc, date
    ok_line = ((c["c_mktsegment"][ci] == 1) & (odate < 9204))[oi] & (
        li["l_shipdate"] > 9204
    )
    rev = li["l_extendedprice"] * (100 - li["l_discount"])
    revenue = np.bincount(oi[ok_line], weights=rev[ok_line], minlength=n_ord)
    cand = np.flatnonzero(np.bincount(oi[ok_line], minlength=n_ord))
    cand_rev = revenue[cand].astype(np.int64)
    top = cand[np.lexsort((odate[cand], -cand_rev))[:11]]
    keys = [(int(revenue[t]), int(odate[t])) for t in top]
    # ORDER BY revenue desc, o_orderdate: no tie inside the first 11 rows,
    # so the 10 rows are one answer
    assert len(set(keys)) == len(keys)
    q1 = [(int(o["o_orderkey"][t]), int(revenue[t]), int(odate[t]),
           int(o["o_shippriority"][t])) for t in top[:10]]

    # Q-J2: lineitem LEFT JOIN the orders before the date cut
    ln = li["l_linenumber"]
    matched = (odate < 9204)[oi]
    cnt = np.bincount(ln)
    cnt_matched = np.bincount(ln[matched], minlength=len(cnt))
    qty = np.bincount(ln, weights=li["l_quantity"])
    q2 = [(k, int(cnt[k]), int(cnt_matched[k]), int(qty[k]))
          for k in np.flatnonzero(cnt).tolist()]

    # Q-J3 (TPC-H Q4): orders of one quarter with a late line, per priority
    late = np.bincount(oi[li["l_commitdate"] < li["l_receiptdate"]],
                       minlength=n_ord) > 0
    in_q = (odate >= 8582) & (odate < 8674) & late
    per_prio = np.bincount(o["o_orderpriority"][in_q])
    q3 = [(p, int(per_prio[p])) for p in np.flatnonzero(per_prio).tolist()]
    return {"Q-J1": q1, "Q-J2": q2, "Q-J3": q3}


def cuda_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profile_grids(fn, names) -> dict:
    """Device ms of one run of ``fn`` by kernel, for the kernels whose
    (mangled) name contains one of ``names``, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in names}
    for e in prof.key_averages():
        for name in names:
            if name in e.key:
                out[name] += getattr(e, "self_device_time_total", 0) / 1e3
    return out


def nonzero_adds(DG, plan, bins, vals) -> int:
    """The adds this data needs: per lane, the live rows whose limb, sign
    bit or count is nonzero (the kernel skips zero limbs)."""
    live = (bins >= 0) & (bins < plan.G)
    total = 0
    for ci, op in zip(*DG.lane_ops(plan)):
        if op == DG._OP_ZERO:
            continue
        if op == DG._OP_COUNT:
            add = live
        elif op == DG._OP_SIGN:
            add = live & (vals[ci] < 0)
        else:
            add = live & (((vals[ci] >> op) & 255) != 0)
        total += int(add.sum())
    return total


def phase_device():
    import torch

    from trino_tpu_torch import _kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _kernels.build_all()
    build_s = time.perf_counter() - t0
    log(
        "device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, kernel_build_s=round(build_s, 3),
    )
    # registers, shared memory and spills of every kernel, from ptxas
    for name in _kernels.LAUNCHES:
        lines = [ln.strip() for ln in _kernels.build_log(name).splitlines()
                 if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
        log("ptxas", kernel=name, info=lines)
    return smi


def phase_kernel():
    """Kernel vs plain version at the main path's shape (a) and two more
    lane plans; returns the plan (a) measurements for the kernels line."""
    import numpy as np
    import torch

    from trino_tpu_torch.ops import dense_groupby as DG

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(11)
    n = ROWS
    plans = {
        "a": (4096, [(True, VBITS)], [False],
              lambda: [rng.integers(0, 1 << VBITS, n)]),
        "b": (128, [(False, 64)], [True],
              lambda: [rng.integers(-(1 << 40), 1 << 40, n)]),
        "c": (8192, [(True, 30), (False, 64), (True, 62)], [False, True, True],
              lambda: [rng.integers(0, 1 << 30, n),
                       rng.integers(-(1 << 40), 1 << 40, n),
                       rng.integers(0, 1 << 62, n)]),
    }
    out = {}
    worst = 0
    for name, (G, cols, pair, make) in plans.items():
        plan = DG.DensePlan(
            G=G, cols=tuple(DG.DenseCol(*c) for c in cols), pair128=tuple(pair)
        )
        bins = torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev)
        vals = [torch.from_numpy(v.astype(np.int64)).to(dev) for v in make()]
        lt = DG.dense_groupby_device(plan, bins, vals)
        ref = DG.dense_groupby_plain(plan, bins, vals)
        torch.cuda.synchronize()
        err = int((lt - ref).abs().max())
        if not torch.equal(lt, ref):
            raise AssertionError(f"plan {name}: kernel != plain, max |err| {err}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: DG.dense_groupby_cuda(plan, bins, vals))
        plain_ms = cuda_ms(lambda: DG.dense_groupby_plain(plan, bins, vals))
        # least time: each input read once and the (M, 128) int64 output
        # written once at the HBM peak, or this data's nonzero limb adds at
        # the peak rate outside the tensor cores, whichever is larger
        nbytes = bins.numel() * 4 + sum(v.numel() * 8 for v in vals) + plan.m * 128 * 8
        nops = nonzero_adds(DG, plan, bins, vals)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / CUDA_CORE_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        library_ms = None
        if name == "a":
            # yardstick only (never used by the port): one library sum and
            # one library count over the same bins
            v0 = vals[0]

            def library():
                torch.zeros(G, dtype=torch.int64, device=dev).index_add_(0, bins, v0)
                torch.bincount(bins, minlength=G)

            library_ms = cuda_ms(library)
        launch = DG.k1_launch_plan(plan, sms, n)
        out[name] = dict(
            G=G, m=plan.m, lanes=plan.lanes, rows=n,
            slices=len(launch.slices), launch_groups=len(launch.groups),
            blocks_per_slice=[g.blocks for g in launch.groups],
            copies=launch.copies, smem_bytes=launch.smem_bytes,
            rows_per_flush=launch.rows_per_flush, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            bytes=nbytes, ops=nops,
            matches_plain=True, max_abs_err=err,
        )
        log("kernel", plan=name, **out[name])
        del bins, vals, lt, ref
    out["max_abs_err"] = worst
    return out


def phase_k2(tables, dev="cuda"):
    """The join-build kernel vs its plain version in four plans; returns
    them by name. Plans (a) and (d) are the builds of Q-J2 and of Q-J1's
    second join at SF10, at the shapes the executor gives them."""
    import torch

    from trino_tpu_torch.columnar import bucket_capacity
    from trino_tpu_torch.ops import dense_join as DJ
    from trino_tpu_torch.ops import join as J

    c, o = tables["customer"], tables["orders"]
    n_ord = len(o["o_orderkey"])
    # the executor sizes a table at 4x the build side's capacity
    ord_cap = bucket_capacity(4 * n_ord)
    # Q-J1's second build is the customer-orders join output: its matches
    # first, in orders row order, in bucket_capacity(2 x orders) slots
    seg = c["c_mktsegment"][np.searchsorted(c["c_custkey"], o["o_custkey"])]
    q1_keys = o["o_orderkey"][(seg == 1) & (o["o_orderdate"] < 9204)]
    q1_n = bucket_capacity(2 * n_ord)
    rng = np.random.default_rng(13)
    plans = {
        # Q-J2's build: the orders before the date cut
        "a": (o["o_orderkey"], o["o_orderdate"] < 9204, ord_cap),
        # every order keyed on o_custkey: 15 orders a key on average,
        # chains past the 16-slot window leave rows unplaced
        "b": (o["o_custkey"], np.ones(n_ord, bool), ord_cap),
        "c": (rng.integers(0, 1 << 40, 1 << 16), rng.random(1 << 16) < 0.9,
              1 << 18),
        "d": (np.r_[q1_keys, np.zeros(q1_n - len(q1_keys), np.int64)],
              np.arange(q1_n) < len(q1_keys), 4 * q1_n),
    }
    out = {}
    for name, (keys, use_np, cap) in plans.items():
        kt = torch.from_numpy(keys).to(dev)
        use = torch.from_numpy(use_np).to(dev)
        h, _ = J.hash_keys([(kt, torch.ones_like(use))])
        base = DJ.slot_base_hash(h, cap)
        table, unplaced = DJ.build_table_device(base, use, cap)
        ptable, punplaced = DJ.build_table_plain(base, use, cap)
        torch.cuda.synchronize()
        err = int((table.to(torch.int64) - ptable.to(torch.int64)).abs().max())
        if not torch.equal(table, ptable) or int(unplaced) != int(punplaced):
            raise AssertionError(
                f"k2 plan {name}: kernel != plain (max |err| {err}, unplaced "
                f"{int(unplaced)} vs {int(punplaced)})"
            )
        if name == "b" and int(unplaced) == 0:
            raise AssertionError("k2 plan b: expected rows past the probe window")
        ms = cuda_ms(lambda: DJ.build_table_device(base, use, cap))
        plain_ms = cuda_ms(lambda: DJ.build_table_plain(base, use, cap))
        # the worklists of one build, and the device memory it takes
        window = min(DJ.PROBE_WINDOW, cap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        lens = DJ.build_table_cuda(base, use, cap, window)[2].tolist()
        torch.cuda.synchronize()
        build_peak = torch.cuda.max_memory_allocated() - held
        # launches: the compaction, the scan, the scatters (two above 64
        # buckets, that is 2^20 slots), round 0 and one cooperative launch
        # for the later rounds, which stops at the first empty worklist
        launches = 4 + (cap > 1 << 20) + (window > 1)
        skipped = sum(x == 0 for x in lens[1:window])
        # device time of one build by grid
        grid_ms = profile_grids(
            lambda: DJ.build_table_device(base, use, cap),
            ("compact_kernel", "scan_kernel", "scatter_kernel", "round0_kernel",
             "rounds_kernel"),
        )
        # least time: slot bases (4 B) and use flags (1 B) read once, the
        # int32 table written once; the operations, one proposal per live
        # row per round it takes (this data's rounds, from the table), are
        # far below the bytes at the peak rate outside the tensor cores
        live_rows = int(use.sum())
        occ = ptable != DJ.EMPTY
        rounds = (torch.nonzero(occ).reshape(-1)
                  - base[ptable[occ].long()].to(torch.int64)) & (cap - 1)
        proposals = int((rounds + 1).sum()) + DJ.PROBE_WINDOW * int(punplaced)
        rows = int(base.shape[0])
        nbytes = 5 * rows + 4 * cap
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = proposals / CUDA_CORE_OPS_PER_S * 1e3
        # one random 32-byte sector per live row, where the table is
        # larger than L2
        sector_bytes = 32 * live_rows if 4 * cap > L2_BYTES else 0
        out[name] = dict(
            rows=rows, live_rows=live_rows, capacity=cap,
            unplaced=int(unplaced), ms=ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, proposals=proposals,
            bound_with_sectors_ms=(nbytes + sector_bytes) / HBM_BYTES_PER_S * 1e3,
            worklist_lens=lens, placed=lens[0] - lens[window],
            launches=launches, rounds_skipped=int(skipped), grid_ms=grid_ms,
            build_peak_device_bytes=build_peak,
            library_ms=None, matches_plain=True, max_abs_err=err,
        )
        log("k2", plan=name, **out[name])
        del kt, use, h, base, table, ptable
    return out


def _oracle(keys, vals_list, sel):
    """Exact per-key integer sums and counts over selected rows: a stable
    sort by key, int64 prefix sums, differences at group boundaries."""
    import numpy as np

    k = keys[sel]
    order = np.argsort(k, kind="stable")
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    uniq = ks[starts]
    counts = np.diff(np.r_[starts, len(ks)])
    sums = []
    for v in vals_list:
        cs = np.r_[0, np.cumsum(v[sel][order], dtype=np.int64)]
        ends = np.r_[starts[1:], len(ks)]
        sums.append(cs[ends] - cs[starts])
    return uniq, sums, counts


def phase_sql():
    import numpy as np
    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import batch_from_numpy
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
    from trino_tpu_torch.testing import LocalQueryRunner

    rng = np.random.default_rng(7)
    k = rng.integers(0, KEYS, ROWS)
    v = rng.integers(0, 1 << VBITS, ROWS)
    w = rng.integers(-(1 << 40), 1 << 40, ROWS)
    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    runner.session.set("stream_scan_threshold_rows", 1 << 20)
    mem = runner.catalogs.get("memory")
    mem.create_table(
        "default", "bench_groupby",
        TableSchema("bench_groupby", tuple(
            ColumnSchema(c, T.BIGINT) for c in ("k", "v", "w")
        )),
    )
    mem.insert("default", "bench_groupby", batch_from_numpy([T.BIGINT] * 3, [k, v, w]))

    # oracles
    uk, (sv,), cnt = _oracle(k, [v], np.ones(ROWS, bool))
    want_a = sorted(zip(uk.tolist(), sv.tolist(), cnt.tolist()))
    sel = v < 524288
    uk, (sw, sv2), cnt = _oracle(k, [w, v], sel)
    want_b = sorted(
        zip(uk.tolist(), sw.tolist(), (sv2.astype(np.float64) / cnt).tolist(),
            cnt.tolist())
    )
    queries = {
        "Q-A": ("select k, sum(v), count(*) from memory.default.bench_groupby "
                "group by k", want_a),
        "Q-B": ("select k, sum(w), avg(v), count(*) from "
                "memory.default.bench_groupby where v < 524288 group by k",
                want_b),
    }
    # the main path's run: every count starts at 0 here and is read after
    _kernels.reset_counts()
    report = {}
    for name, (sql, want) in queries.items():
        times = []
        for i in range(1 + WARM):
            before = _kernels.LAUNCHES["dense_groupby"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = runner.engine.execute_statement(sql, runner.session)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if _kernels.LAUNCHES["dense_groupby"] <= before:
                raise AssertionError(f"{name}: the dense kernel did not launch")
            if sorted(res.rows) != want:
                raise AssertionError(f"{name}: rows differ from the numpy oracle")
        warm = statistics.median(times[1:])
        report[name] = dict(
            groups=len(want), cold_ms=times[0], warm_median_ms=warm,
            warm_ms=times[1:], rows_per_s=ROWS / (warm / 1e3),
            fragment_modes={str(f): m for f, m in (res.fragment_modes or {}).items()},
            matches_oracle=True,
        )
        log("sql", query=name, **report[name])
    launches = dict(_kernels.LAUNCHES)
    log("sql", launches=launches)
    phase_profile(runner, {q: sql for q, (sql, _) in queries.items()})
    return launches


def load_tpch(runner, tables) -> None:
    """``tables`` into the runner's memory catalog as BIGINT columns of
    ``memory.default``."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import batch_from_numpy
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema

    mem = runner.catalogs.get("memory")
    for name, cols in tables.items():
        mem.create_table("default", name, TableSchema(
            name, tuple(ColumnSchema(c, T.BIGINT) for c in cols)
        ))
        mem.insert("default", name, batch_from_numpy(
            [T.BIGINT] * len(cols), list(cols.values())
        ))


JOIN_QUERIES = {"Q-J1": Q_J1, "Q-J2": Q_J2, "Q-J3": Q_J3}


def phase_join(tables, oracle):
    """Q-J1..3 at SF10 through the port in distributed mode, against the
    numpy oracle; returns the launch counts of this path's run."""
    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch.testing import LocalQueryRunner

    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    load_tpch(runner, tables)
    n_line = len(tables["lineitem"]["l_orderkey"])
    # the main path's run: every count starts at 0 here and is read after
    _kernels.reset_counts()
    for name, sql in JOIN_QUERIES.items():
        times, per_run = [], []
        for _ in range(1 + WARM):
            before = _kernels.LAUNCHES["dense_join_build"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = runner.engine.execute_statement(sql, runner.session)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            per_run.append(_kernels.LAUNCHES["dense_join_build"] - before)
            if name != "Q-J3" and per_run[-1] < 1:
                raise AssertionError(f"{name}: the join-build kernel did not launch")
            rows = res.rows if name == "Q-J1" else sorted(res.rows)
            if rows != oracle[name]:
                raise AssertionError(f"{name}: rows differ from the numpy oracle")
        warm = statistics.median(times[1:])
        stats = res.exchange_stats or {}
        log(
            "join", query=name, rows=len(res.rows), cold_ms=times[0],
            warm_median_ms=warm, warm_ms=times[1:],
            lineitem_rows_per_s=n_line / (warm / 1e3),
            k2_launches_per_run=per_run,
            joinStrategy=stats.get("joinStrategy"),
            overflow_retries=stats.get("overflow_retries"),
            fragment_modes={str(f): m for f, m in (res.fragment_modes or {}).items()},
            peak_device_bytes=torch.cuda.max_memory_allocated(),
            matches_oracle=True,
        )
    launches = dict(_kernels.LAUNCHES)
    log("join", launches=launches)
    phase_profile(runner, JOIN_QUERIES)
    phase_spans(runner, JOIN_QUERIES)
    return launches


def phase_spans(runner, queries) -> None:
    """Where a warm join query's wall time goes: one more warm run of each
    query with the table scans (split concatenation and host-to-device
    copies), the dynamic filters, the join steps and, inside them, the
    K2 builds, and the grouped aggregations timed on the host clock, each
    span ending in a synchronise. ``probe_ms`` is the join steps less
    their builds: the probe, the exactness pass and the payload gathers."""
    import torch

    from trino_tpu_torch import dynfilter
    from trino_tpu_torch.exec import local
    from trino_tpu_torch.ops import dense_join as DJ
    from trino_tpu_torch.parallel import distributed

    spans = [(local.LocalExecutor, "_exec_tablescan", "scan_ms"),
             (dynfilter, "fragment_dynamic_filters", "dynamic_filter_ms"),
             (distributed, "_sharded_probe", "join_ms"),
             (DJ, "build_table", "k2_build_ms"),
             (local, "group_aggregate", "group_by_ms")]
    originals = [getattr(owner, attr) for owner, attr, _ in spans]
    spent: dict[str, float] = {}

    def timed(fn, label):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spent[label] = spent.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
        return run

    try:
        for (owner, attr, label), fn in zip(spans, originals):
            setattr(owner, attr, timed(fn, label))
        for name, sql in queries.items():
            spent.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.engine.execute_statement(sql, runner.session)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            out = {label: spent.get(label, 0.0) for _, _, label in spans}
            out["probe_ms"] = out.pop("join_ms") - out["k2_build_ms"]
            out["rest_ms"] = wall_ms - sum(out.values())
            log("spans", query=name, wall_ms=wall_ms, **out)
    finally:
        for (owner, attr, _), fn in zip(spans, originals):
            setattr(owner, attr, fn)


def phase_profile(runner, queries) -> None:
    """Where a warm query's time goes: one more warm run of each query
    under torch.profiler, device time by kernel name against the host
    wall time (the device's idle share is 1 - busy / wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for name, sql in queries.items():
        runner.engine.execute_statement(sql, runner.session)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.engine.execute_statement(sql, runner.session)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events (kernels, copies, fills) where the trace has
        # them: the host ops that launched them carry the same time again
        on_device, on_host = [], []
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", 0)
            if dev_us > 0:
                side = getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                (on_device if side else on_host).append(
                    (dev_us / 1e3, e.count, e.key[:60])
                )
        kernels = on_device or on_host
        kernels.sort(reverse=True)
        busy_ms = sum(k[0] for k in kernels)
        log(
            "profile", query=name, events="device" if on_device else "host",
            wall_ms=wall_ms, device_busy_ms=busy_ms,
            device_idle_share=1 - busy_ms / wall_ms if wall_ms else None,
            top=[{"ms": ms, "calls": c, "name": k} for ms, c, k in kernels[:8]],
        )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = phase_device()
    kern = phase_kernel()
    t0 = time.perf_counter()
    tables = tpch_tables(SF, seed=7)
    oracle = tpch_oracle(tables)
    log("tpch", sf=SF, rows={t: len(next(iter(c.values()))) for t, c in tables.items()},
        generate_and_oracle_s=time.perf_counter() - t0)
    k2 = phase_k2(tables)
    sql_launches = phase_sql()
    if sql_launches["dense_groupby"] < 1:
        raise AssertionError("the group-by path launched no dense group-by kernel")
    join_launches = phase_join(tables, oracle)
    if join_launches["dense_join_build"] < 1:
        raise AssertionError("the join path launched no join-build kernel")
    a, ka = kern["a"], k2["a"]
    print(json.dumps({"kernels": [{
        "name": "dense_groupby",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/dense_groupby.cu",
        "replaces": "trino_tpu/ops/dense_groupby.py:229",
        "launches": sql_launches["dense_groupby"] + join_launches["dense_groupby"],
        "matches_plain": True,
        "max_abs_err": kern["max_abs_err"],
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"],
        "library_ms": a["library_ms"],
    }, {
        "name": "dense_join_build",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/dense_join_build.cu",
        "replaces": "trino_tpu/ops/dense_join.py:344",
        "launches": join_launches["dense_join_build"],
        "matches_plain": True,
        "max_abs_err": max(p["max_abs_err"] for p in k2.values()),
        "ms": ka["ms"],
        "plain_ms": ka["plain_ms"],
        "bound_ms": ka["bound_ms"],
        "bound_by": ka["bound_by"],
        "library_ms": ka["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
