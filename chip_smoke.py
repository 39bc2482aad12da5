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
   on the card in four plans over the SF10 tables (the orders before Q-J2's
   date cut, the same rows keyed on ``o_custkey`` so that duplicate chains
   overflow the probe window, a small build, and the order keys that
   Q-J1's second join builds on, each in a table of fixed size); the table
   must be equal elementwise and the count of unplaced rows equal. Each
   plan also logs its worklist lengths, its launches and the rounds they
   skipped (the later rounds stop at the first empty worklist), the device
   time of one build by grid (from torch.profiler) and the device memory
   one build takes;
4. sql: ``select k, sum(v), count(*) ... group by k`` (Q-A) and a filtered
   signed-sum/avg variant (Q-B) over a 2^25-row memory table through
   ``LocalQueryRunner(device="cuda")`` in distributed mode, once cold and
   3 times warm; rows must equal a numpy oracle exactly, and the kernel's
   launch count must rise on every query;
5. join: TPC-H-shaped customer, orders and lineitem tables at SF10
   (:func:`tpch_tables`) in memory tables, and Q-J1 (TPC-H Q3), Q-J2 (a
   LEFT join) and Q-J3 (TPC-H Q4, an EXISTS semi join) through the same
   runner in distributed mode, once cold and 3 times warm; rows must equal
   a numpy oracle exactly, and the join-build kernel's launch count must
   rise on every run of Q-J1 and Q-J2 (their lineitem fragments stream
   through the joins: one build a join site an attempt). Every K2 build
   of the three queries, the streamed ones included, is then held against
   its plain version at the shapes the executor gives it;
5b. spill: the same three queries over the same memory tables through the
   interpreter (``execution_mode=local``) under the reference's spill
   defaults, once each (a repeat is the same work: the interpreter keeps
   no program), against the oracle; Q-J1's and
   Q-J2's joins must run partitioned, Q-J3's semi join must not. Each
   line gives the spilled operators by kind, partitions, host
   partitioning seconds, the allocator's and the accounted peak and the
   K2 launches.
5c. mesh (SF10 part): Q-J1 and Q-J2 over the same memory tables on a
   mesh of 4 shards on the card (``DistributedQueryRunner(n_devices=4,
   device="cuda")`` over the same engine) with
   ``join_distribution_type=PARTITIONED``: both sides hash-repartitioned
   between the shards, one K2 build a shard; once cold and once warm
   against the oracle, each run with its exchange counters; every K2
   build of the cold runs held against its plain version as it runs.

6. tpch: TPC-H Q1 (Q-T1) and Q6 (Q-T6), spec text, over ``tpch.sf10``
   generated by the port's tpch connector (the generate-and-stage seconds
   on a line of their own), and Q-D, a narrow-DECIMAL GROUP BY over a
   memory table of the first 2^25 generated lineitem rows, through the
   same runner in distributed mode, once cold and 3 times warm. Q-T1 and
   Q-T6 stream through the sort-based step (their slab of 15 x 2^22 rows
   is not a power of two, so the dense path declines); Q-D must launch the
   dense group-by kernel once a run with a ``pair128`` plan. Rows must
   equal exact integer oracles over the same generated arrays; every line
   names the card and its power limit.

7. tpch22: all 22 TPC-H queries, spec text, over ``tpch.sf1``: the port's
   native loader builds ``trino_tpu_torch/csrc/columnar.cpp`` and the
   comment text pool,
   the connector generates the eight tables and stages them on the card
   (seconds and staged bytes per table on a line), then each query runs
   through the same runner in distributed mode once cold and twice
   warm. Rows and column types must equal the reference's answers
   committed in ``trino_tpu_torch/benchmarks/tpch_sf1_answers.json``
   exactly (rows whose ORDER BY keys tie compared as a multiset); a
   mismatch names the query and its first differing row. Each query's
   line gives its cold and warm times, K1 and K2 launches per run, join
   strategies, overflow retries and peak device memory (the peak counter
   reset per query); the join-build kernel must launch, and every K2
   build of the cold runs is held against its plain version as it runs
   (the cold times include that). Q5's and Q6's
   peaks are then attributed (phase ``peak``): each fragment's own peak
   and the largest allocations alive at the query's peak, with the line
   of the port that made them, from the allocator's history.

7a. server: the port's coordinator server (``TrinoTpuServer``) over the
   same engine and staged ``tpch.sf1`` tables, on ``127.0.0.1:0``, queried
   over HTTP: Q-A and Q-B over the 2^25-row table through
   ``client.Connection``, once cold (each K1 launch held against plain)
   and 3 times warm, every run launching K1 and equal to the oracle; the
   22 TPC-H queries through ``dbapi``, replaying the programs that phases
   tpch22 and programs stored, once (every K2 build that is no replay
   held against plain) and once warm, decoded rows and column types
   against the committed answers; 8 clients at once, a
   Q6 literal variant each (batched; ``batchStats`` from
   ``/v1/query/{id}``); 500,000 orders rows paged under the 1 MiB
   budget (pages, rows/s, the pager's peak within 3x the budget); a
   partitioned join on 4 shards whose ``/v1/query/{id}`` carries at
   least 2 exchanges; ``/v1/metrics`` and ``/v1/status``. The kernel
   counts cover these HTTP steps. Then, uncounted, the same statements
   in-process on the same engine (the protocol's cost per statement, the
   rows and the extraction's checksum the HTTP steps must equal) and a
   graceful drain with 4 clients in flight, none dropped.

7a2. obs: observability and the repeat tiers over the same engine (kernel
   counts 0 at its start): the result cache on Q-A (a cold run with K1, a
   pure hit with no K1 launch, an INSERT of one more part maintained from
   that part alone, a DELETE that invalidates and runs K1 again, each
   against its oracle); the history store (TPC-H Q3, Q5, Q7 at SF1 cold
   on a fresh engine A with ``history_dir``, then on a fresh engine B
   seeded from it: rows against the committed answers, ``history_seeds``
   at least 1, no retry, no halving, every K2 build that is no replay
   equal to plain, both engines' cold ms and host reads side by side);
   the profiler (each captured program's ``temp_bytes`` its pool growth,
   its peak at least its arguments and outputs, the rollup's peak the
   largest, ``system.runtime.programs`` agreeing, EXPLAIN ANALYZE's device
   section); over HTTP with ``flight_dir``, Q-A's timeline one connected
   tree, the tier's counters on ``/v1/metrics``, the flight journal from
   created to completed, ``/v1/history``, ``/v1/cache``, ``/v1/slo``.

7b. surface: the statement surface over the same staged ``tpch.sf1``
   tables, one engine: SHOW CATALOGS/SCHEMAS/TABLES/COLUMNS against the
   expected lists; CREATE TABLE AS of 11 lineitem columns into
   ``memory.default.li1`` (6,001,215 rows), TPC-H Q1 and Q6 over it
   against the committed answers, and a GROUP BY over it that must launch
   K1, each launch equal to its plain version on the same tensors, and
   whose rows must equal numpy sums over the staged source columns;
   INSERT and DELETE of the 1998
   rows, ROLLBACK of an INSERT and of a DROP, a committed INSERT, each
   followed by a count and a sum (cold and warm) checked against the
   source; PREPARE/EXECUTE of Q6 (its five literals as parameters)
   against its answer; ROLLUP, GROUPING SETS and CUBE over lineitem ⋈
   orders with a FILTER count and ``max(o_clerk)``, held against one plain
   GROUP BY a grouping set and a numpy ``max(o_clerk)``, their joins
   launching K2 with every build equal to plain; UNNEST of
   ``array[1, 2, 3]`` over orders (4.5M rows, with the host ms its runs
   spend in the tpch connector's split reads) and ``array_agg`` against
   counts; EXPLAIN and EXPLAIN ANALYZE of Q3. A line a step: cold and
   warm ms, peak device memory and K1/K2 launches per run, rows/s for
   CTAS, the joins and UNNEST.

7c. files: the ingest tier and the file formats on the same engine
   (``BASELINE.json`` configs 4 and 5). Catalogs ``pq=parquet:<dir>``,
   ``orc=orc:<dir>`` and ``ttp=file:<dir>`` in a temporary directory
   (removed at the end) through ``register_catalog_spec``. CREATE TABLE AS
   of every column of the eight ``tpch.sf1`` tables into ``pq.sf1``, and
   of lineitem, orders and customer of ``tpch.tiny`` into ``orc.tiny``
   and ``ttp.tiny`` (their scale cut from sf1 for time; seconds, bytes on
   disk, rows/s a table; each row count checked); the 22 queries, spec
   text under session catalog ``pq``, and Q1/Q3/Q6 over ``orc`` and
   ``ttp``, distributed with the scans materialized (so the table cache
   serves warm runs), once cold and twice warm, held against the
   committed answers of their scale, each run's ingest stats on its line
   (``decode_ms``, ``splits_decoded``, ``h2d_bytes``, ``h2d_transfers``,
   ``coalesced_columns``, table-cache hits and misses; a warm run that
   copies a byte fails); every K2 build of their cold runs is held
   against plain as it runs. Q-E: ``select k, sum(v), count(*)`` over 2^25 rows written as 8
   Parquet row groups (seed 7, as ``bench.py``), cold and 3 warm, its
   rate against phase ``sql``'s Q-A, then cold under each setting of
   (``ingest_prefetch``, ``coalesced_h2d``) with the table cache off,
   rows against numpy sums every time. Config 4: the same GROUP BY over
   10^9 rows of ``synthetic.default.events`` made chunk by chunk on the
   card, against a closed form (0 bytes copied). DELETE on
   ``ttp.tiny.orders``, which must call ``replace_data`` and nothing else,
   against the source's count.

7d. mesh (SF1 part): the 22 queries over the same staged ``tpch.sf1``
   tables on a mesh of 4 shards on the card, once cold and once warm,
   against the committed answers, each line with its exchange counters
   (exchanges, shuffled and padded rows and bytes, padding ratio, hot keys,
   salted rows, overflow retries), times, peak, the graph pools'
   bytes and its streamed fragments (steps, parts a step, which must be
   one a shard, and the rows a part holds); the phase's line gives the
   warm sum beside the one measured before one chunk a shard; then the skew acceptance shape of ``tests/test_skew.py``
   (Zipf(1.2) join keys over 2,000,000 rows, the join partitioned, on the
   reference's 8 shards) with
   skew handling on and off and through the interpreter: equal rows; on,
   hot keys and no overflow retry; off, a retry and at least twice the
   padding ratio. The phase's K2 count is the 22 queries' runs; the skew
   runs' launches have a line of their own, and the interpreter's run is
   counted nowhere. Every K2 build of the queries' cold runs and of the
   skew shape's two mesh runs (one a shard) is then held against its
   plain version.

7e. cluster: a coordinator and two worker processes on the card
   (``MultiProcessQueryRunner(device="cuda")``, each process holding a
   quarter of the card; every process started as ``chip_smoke.py
   --cluster-process``, which holds every K2 build of the process against
   its plain version and records it): TPC-H Q1, Q3, Q5, Q6, Q9, Q10 and Q18
   at ``tpch.sf1``, cold and once warm, and the 22 queries at ``tpch.tiny``
   once (the 22 at SF1 took 275.5 s, past the phase's 180) in
   ``execution_mode=cluster``, rows against the committed answers, each
   line with its cold and warm ms,
   the in-process warm ms of phase ``tpch22``, its tasks and their
   execution paths, the pages and bytes shipped over HTTP, the workers'
   K1 and K2 launches and its host-to-device copies; the chaos scenarios
   of ``scripts/chaos_smoke.py`` on Q1 (30% task crashes under TASK retry,
   a ten-times-slow worker under speculation), rows against the clean
   run's; a scaled CTAS of four lineitem columns written from both
   workers; the cluster memory manager's kill of a query reported over
   the limit, whose worker task must read CANCELED and free its
   reservation within 15 s (``tasks_canceled_after_s``), and a small
   query after it; a drain and a restart (Q1 at
   tiny); last a node death under spooling. The phase's K2 count is the workers' launches
   over the 22 queries' runs; it must be above 0 and every checked build
   equal to plain. ``--only cluster`` runs it alone.

7f. spmd: a coordinator and two workers on the card in one SPMD group
   (``MultiProcessQueryRunner(spmd=True)``, a 0.24 share and a 64 MiB
   exchange arena each, started through ``--cluster-process``). At boot
   each process checks the peer-copy collectives (CUDA IPC arenas, gloo
   barriers) and a hash repartition against the one-process mesh, with
   an all to all and an all gather past the arena (rounds). TPC-H Q1, Q3,
   Q5 and Q10 at SF1 cold and once warm against the committed answers:
   each must run SPMD (no worker task; every process's run in the
   query's ``exchangeStats.spmd``), Q3, Q5 and Q10 must launch K2 in
   every process, and the exchange counters must equal a one-process
   three-shard mesh's run on the card (made in phase ``mesh``'s time,
   over its staged tables); each line gives every process's K2 launches,
   the bytes and ms its transport moved, and phase ``cluster``'s and the
   in-process times. Then two overlapping queries, a window query that
   falls back to tasks, and after a worker is killed a query that falls
   back, each against its reference rows. Every K2 build of every
   process is held against plain. ``--only spmd`` runs it alone.

8. tpcds: all 64 TPC-DS queries of the port's corpus, spec text, over
   ``tpcds.sf1`` from the port's tpcds connector: the 24 tables generated
   and staged on the card (rows, bytes, generation and staging seconds
   per table), then each query once cold and twice warm through the same
   runner in distributed mode with ``join_strategy=auto``, its rows and
   column types held against ``tpcds_sf1_answers.json`` exactly; then
   Q64 and Q95 over ``tpcds.sf10`` (``BASELINE.json`` config 3), once cold
   and once warm, against ``tpcds_sf10_answers.json`` the same way; Q64's
   warm run must replay every program it stored, with no capture and no
   program run without its graph. Each query's line adds its
   table-cache hits and misses per run and its graph pool counts; the table cache runs at its
   default budget and must evict nothing at SF1. Every K2 build of these
   queries' cold runs is held against its plain version as it runs, the slowest is
   profiled, and the query with the largest peak and Q95 at SF10 (warm,
   then with its capacities forgotten) are attributed.

9. verify: the port's query verifier (``trino_tpu_torch.verifier.main``)
   in this process: the interpreter (``local``) against the program path
   (``distributed``), both on the card, over phase surface's CREATE TABLE
   AS of ``tpch.sf1.lineitem``, the K1 GROUP BY over it and the 22 TPC-H
   queries, phase cluster's seven at SF1 and the others at tiny
   (:func:`verify_corpus`); a coordinator of the port booted in
   this process under the port's lockdep against ``distributed`` over the
   22 at ``tpch.tiny`` (the lockdep's report must be empty); a statement
   on a missing table (main must return 1). A line a query with each
   side's ms, K1 and K2 launches and allocator peak; the test side must
   launch K1 on the GROUP BY and K2 on every join query that launches it
   in phase tpch22, every launch held against its plain version.
   ``--only verify`` runs it alone.

Every query line of phases 5, 7 and 8 gives its streamed join fragments
(chunks and builds) and the streams that fell back to materialized;
TPC-H Q3/5/7/10/17/19 and TPC-DS Q21/37/82 must stream one.

Phases 4, 5, 6, 7 and 8 each end with one warm run of each query (of the
three slowest in phase 7, the slowest in phase 8) under ``torch.profiler``
(phase ``profile``);
phases 5, 6 and 7 then time the layers of one more warm run of each join
query, of Q-T1 and Q-T6, and of phase 7's three slowest, on the host
clock (phase ``spans``).
The line before the last is a JSON
object with one entry per kernel of the path; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.

``python3 chip_smoke.py --only tpch22,programs,server,surface,files,tpcds,spill,mesh,cluster,spmd,verify``
runs the device phase and the named phases alone (``tpch22``,
``programs``, ``server``, ``surface`` and ``files`` stage the SF1 tables
first, ``spill``
generates the SF10 tables first, ``mesh`` does both, ``mesh_sf1``
runs phase mesh's SF1 part alone, ``cluster``'s
workers and ``verify``'s engines generate their own splits, ``spmd``
stages SF1 for its one-process mesh first), for work on
one of them; it prints no result lines.

After every phase a ``pool`` line gives the graph pools' bytes of the
phase's engine, which must be at or under their budget (an eighth of the
card). The script finds its package beside itself however it is
launched (another working directory, ``PYTHONSAFEPATH=1``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from decimal import Decimal
from typing import Optional

import numpy as np

# the package beside the script, however it is launched (another working
# directory, PYTHONSAFEPATH=1); child processes get it as PYTHONPATH
ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
CHILD_ENV = {**os.environ, "PYTHONPATH": os.pathsep.join(
    p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}

ROWS = 1 << 25           # the bench.py headline's table size
KEYS = 4096              # k in [0, 4096)
VBITS = 20               # v in [0, 2^20)
WARM = 3                 # warm runs a query in phases sql, join and tpch
SF = 10                  # TPC-H scale factor of the join phase
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
L2_BYTES = 50e6          # H100 L2 cache


T_START = time.perf_counter()


def reset_peak() -> None:
    """Start a span of work whose allocator peak :func:`read_peak` gives
    (``obs/profiler.py``: a profiling window's reset inside the span does
    not lower it)."""
    from trino_tpu_torch.obs.profiler import reset_allocator_peak

    reset_allocator_peak()


def read_peak() -> int:
    from trino_tpu_torch.obs.profiler import allocator_peak

    return allocator_peak()


def log(phase: str, **kv) -> None:
    """One JSON line; ``t_s`` is the script's seconds so far."""
    print(json.dumps({"phase": phase, **kv,
                      "t_s": round(time.perf_counter() - T_START, 1)}), flush=True)


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
        capture_output=True, text=True, check=True, timeout=60, env=CHILD_ENV,
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
    """The join-build kernel vs its plain version in four plans of fixed
    table size over the SF10 tables; returns them by name. Plan (a) is the
    rows of Q-J2's build and plan (d) the keys of Q-J1's second build, in
    tables larger than the executor sizes from the live rows (it holds its
    own builds against the plain version in phase ``join``); plan (a)'s
    times are the ones the kernels line reports."""
    import torch

    from trino_tpu_torch.columnar import bucket_capacity
    from trino_tpu_torch.ops import dense_join as DJ
    from trino_tpu_torch.ops import join as J

    c, o = tables["customer"], tables["orders"]
    n_ord = len(o["o_orderkey"])
    # 4x the orders rows, at a load factor of at most 0.25
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
        reset_peak()
        held = torch.cuda.memory_allocated()
        lens = DJ.build_table_cuda(base, use, cap, window)[2].tolist()
        torch.cuda.synchronize()
        build_peak = read_peak() - held
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


BENCH_GROUPBY: dict = {}  # the headline table and its oracles, made once a run


def bench_groupby(catalogs) -> dict:
    """The headline table ``memory.default.bench_groupby`` (2^25 rows of
    k, v, w from seed 7) created in ``catalogs``, and Q-A and Q-B with
    their exact numpy oracles (``{name: (sql, rows)}``). The columns and
    the oracles are made once a run (phases ``sql`` and ``server``)."""
    import numpy as np

    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import batch_from_numpy
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema

    if not BENCH_GROUPBY:
        rng = np.random.default_rng(7)
        k = rng.integers(0, KEYS, ROWS)
        v = rng.integers(0, 1 << VBITS, ROWS)
        w = rng.integers(-(1 << 40), 1 << 40, ROWS)
        uk, (sv,), cnt = _oracle(k, [v], np.ones(ROWS, bool))
        want_a = sorted(zip(uk.tolist(), sv.tolist(), cnt.tolist()))
        sel = v < 524288
        uk, (sw, sv2), cnt = _oracle(k, [w, v], sel)
        want_b = sorted(
            zip(uk.tolist(), sw.tolist(), (sv2.astype(np.float64) / cnt).tolist(),
                cnt.tolist())
        )
        BENCH_GROUPBY["columns"] = [k, v, w]
        BENCH_GROUPBY["queries"] = {
            "Q-A": ("select k, sum(v), count(*) from memory.default.bench_groupby "
                    "group by k", want_a),
            "Q-B": ("select k, sum(w), avg(v), count(*) from "
                    "memory.default.bench_groupby where v < 524288 group by k",
                    want_b),
        }
    mem = catalogs.get("memory")
    mem.create_table(
        "default", "bench_groupby",
        TableSchema("bench_groupby", tuple(
            ColumnSchema(c, T.BIGINT) for c in ("k", "v", "w")
        )),
    )
    mem.insert("default", "bench_groupby",
               batch_from_numpy([T.BIGINT] * 3, BENCH_GROUPBY["columns"]))
    return BENCH_GROUPBY["queries"]


def phase_sql():
    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch.testing import LocalQueryRunner

    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    runner.session.set("stream_scan_threshold_rows", 1 << 20)
    queries = bench_groupby(runner.catalogs)
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
        SQL_RATE[name] = report[name]["rows_per_s"]
    launches = dict(_kernels.LAUNCHES)
    log("sql", launches=launches)
    phase_profile(runner, {q: sql for q, (sql, _) in queries.items()})
    check_pool(runner.engine, "sql")
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


def stream_fields(res) -> dict:
    """What a run's fragments streamed: per streamed join fragment its
    chunk count and its join builds (one K2 launch a dense site), and the
    streams that met a shape the step does not take (``FusedUnsupported``)
    and ran materialized. ``accounted_peak_bytes`` is the query memory
    context's peak: the bytes of the batches the interpreter held, node by
    node (``memory.py``). It is not the allocator's peak: temporaries
    inside an operator, the allocator's cache and the cached tables are
    not in it, and the fragment executor's traced nodes are not accounted
    at all (as in the reference), so a distributed run shows 0."""
    stats = res.exchange_stats or {}
    return {
        "fragment_modes": {str(f): m for f, m in (res.fragment_modes or {}).items()},
        "join_streams": stats.get("join_streams", []),
        "stream_fallbacks": stats.get("stream_fallbacks", 0),
        "accounted_peak_bytes": res.peak_memory_bytes,
    }


def phase_join(tables, oracle):
    """Q-J1..3 at SF10 through the port in distributed mode, against the
    numpy oracle, then every K2 build of one more run of each held against
    its plain version; returns the launch counts of this path's run, the
    largest K2 error and the runner, whose memory tables phase ``spill``
    reuses."""
    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch.testing import LocalQueryRunner

    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    load_tpch(runner, tables)
    n_line = len(tables["lineitem"]["l_orderkey"])
    # the main path's run: every count starts at 0 here and is read after
    _kernels.reset_counts()
    last_run = {}
    for name, sql in JOIN_QUERIES.items():
        times, per_run = [], []
        reset_peak()
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
            peak_device_bytes=read_peak(),
            matches_oracle=True,
            **stream_fields(res),
        )
        if stats.get("stream_fallbacks"):
            log("join", query=name, stream_fallbacks=stats["stream_fallbacks"])
        last_run[name] = per_run[-1]
    launches = dict(_kernels.LAUNCHES)
    log("join", launches=launches)
    # K2 against its plain version at the shapes this path gives it, the
    # streamed builds included (these launches come after the counts were
    # read, and are not counted)
    builds = k2_against_plain(runner, JOIN_QUERIES)
    checked = {}
    for b in builds:
        checked[b["query"]] = checked.get(b["query"], 0) + 1
    k2_err = max(max(b["max_abs_err"], b["unplaced_err"]) for b in builds)
    log("join", k2_vs_plain_builds=builds, k2_max_abs_err=k2_err)
    if checked != {q: n for q, n in last_run.items() if n}:
        raise AssertionError(f"join: K2 builds checked {checked} != launches {last_run}")
    if k2_err:
        raise AssertionError(f"join: K2 != plain on a query's build (max |err| {k2_err})")
    phase_profile(runner, JOIN_QUERIES)
    phase_spans(runner, JOIN_QUERIES)
    log("join", table_cache=runner.engine.table_cache.snapshot())
    return launches, k2_err, runner


# the reference's spill defaults (trino_tpu/config.py), which phase spill
# runs under
SPILL_DEFAULTS = {"spill_enabled": True, "spill_threshold_rows": 1 << 23,
                  "spill_partitions": 8}


def phase_spill(runner, oracle, smi: str) -> dict:
    """Q-J1..3 over phase ``join``'s SF10 memory tables (``runner`` holds
    them) through the port's interpreter (``execution_mode=local``) under
    the reference's spill defaults, once each, against the
    numpy oracle. Q-J1's and Q-J2's joins see about 75M input rows, past
    the threshold of 2^23, and must run partitioned; Q-J3's EXISTS is a
    semi join, which the reference never spills, and must not. Per run:
    the spilled operators by kind, partitions, host partitioning seconds,
    the allocator's peak and the accounted peak, K2 launches (the
    interpreter joins through the sort tier, as the reference's does).
    Returns the kernel launches of this path's run."""
    import torch

    from trino_tpu_torch import _kernels

    session = runner.session
    for k, v in SPILL_DEFAULTS.items():
        if session.get(k) != v:
            raise AssertionError(f"spill: {k}={session.get(k)!r}, the reference's is {v!r}")
    session.set("execution_mode", "local")
    # the path's run: every count starts at 0 here and is read after
    _kernels.reset_counts()
    try:
        for name, sql in JOIN_QUERIES.items():
            runs = []
            # one run: the interpreter keeps no program, so a repeat is
            # the same work (and took ~18 s a script)
            for label in ("cold",):
                before = _kernels.LAUNCHES["dense_join_build"]
                torch.cuda.synchronize()
                reset_peak()
                t0 = time.perf_counter()
                res = runner.engine.execute_statement(sql, session)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                rows = res.rows if name == "Q-J1" else sorted(res.rows)
                if rows != oracle[name]:
                    raise AssertionError(f"spill: {name} ({label}) rows differ from the oracle")
                sp = res.spill_stats or {}
                runs.append({
                    "run": label, "ms": ms,
                    "spilled_operators": sp.get("operators", {}),
                    "partitions": sp.get("partitions", 0),
                    "host_partition_s": sp.get("host_partition_s", 0.0),
                    "peak_device_bytes": read_peak(),
                    # the interpreter's held batches, node by node: no
                    # operator temporaries, no allocator cache (see
                    # stream_fields)
                    "accounted_peak_bytes": res.peak_memory_bytes,
                    "k2_launches": _kernels.LAUNCHES["dense_join_build"] - before,
                })
            joins = [r["spilled_operators"].get("join", 0) for r in runs]
            if name != "Q-J3" and not all(joins):
                raise AssertionError(f"spill: {name}'s join did not spill")
            if name == "Q-J3" and any(joins):
                raise AssertionError("spill: Q-J3's semi join spilled; the reference's never does")
            log("spill", card=smi, query=name, rows=len(res.rows), matches_oracle=True,
                runs=runs)
    finally:
        session.set("execution_mode", "distributed")
    launches = dict(_kernels.LAUNCHES)
    log("spill", card=smi, launches=launches)
    return launches


def timed_spans(runner, queries, spans) -> dict:
    """One more run of each query after every stored program was evicted
    (``ProgramPool.evict_lru``): the eager warm-up at the query's settled
    capacities that precedes each capture, the only run in which the
    functions a graph replays are called. The functions ``spans`` names
    (``(owner, attribute, label)``) are timed on the host clock, each
    call ending in a synchronise; returns per query its wall ms, the ms
    of each label, ``capture_ms`` (the captures that follow the warm-ups)
    and ``rest_ms``, the wall time outside them all."""
    import torch

    originals = [getattr(owner, attr) for owner, attr, _ in spans]
    spent: dict[str, float] = {}

    def timed(fn, label):
        def run(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kwargs)  # a capture runs nothing to time
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spent[label] = spent.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
        return run

    out = {}
    try:
        for (owner, attr, label), fn in zip(spans, originals):
            setattr(owner, attr, timed(fn, label))
        for name, sql in queries.items():
            spent.clear()
            runner.engine.program_pool.evict_lru()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = runner.engine.execute_statement(sql, runner.session)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            out[name] = {"path": "warm-up", "wall_ms": wall_ms,
                         **{label: spent.get(label, 0.0) for _, _, label in spans},
                         "capture_ms": res.compile_ms}
            out[name]["rest_ms"] = wall_ms - sum(spent.values()) - res.compile_ms
    finally:
        for (owner, attr, _), fn in zip(spans, originals):
            setattr(owner, attr, fn)
    return out


def phase_spans(runner, queries) -> None:
    """Where a warm join query's wall time goes: the table scans (split
    concatenation and host-to-device copies, or table-cache hits), the
    dynamic filters, the join builds (``join_build_ms``: hashing, sorting
    or slot bases, less the K2 builds inside them), the K2 builds, the
    probes (``probe_ms``: the probe, the exactness pass and the payload
    gathers) and the grouped aggregations."""
    from trino_tpu_torch import dynfilter
    from trino_tpu_torch.exec import fragments, local
    from trino_tpu_torch.ops import dense_join as DJ
    from trino_tpu_torch.parallel import distributed

    spans = [(local.LocalExecutor, "_exec_tablescan", "scan_ms"),
             (dynfilter, "fragment_dynamic_filters", "dynamic_filter_ms"),
             (distributed, "build_join", "join_build_ms"),
             (distributed, "probe_build", "probe_ms"),
             (DJ, "build_table", "k2_build_ms"),
             (local, "group_aggregate", "group_by_ms"),
             (fragments, "group_aggregate", "group_by_ms")]
    for name, out in timed_spans(runner, queries, spans).items():
        # the K2 builds run inside the join builds: counted once, in k2
        out["join_build_ms"] -= out["k2_build_ms"]
        out["rest_ms"] += out["k2_build_ms"]
        log("spans", query=name, **out)


def phase_profile(runner, queries, **extra) -> None:
    """Where a warm query's time goes: one more warm run of each query
    under torch.profiler, device time by kernel name against the host
    wall time (the device's idle share is 1 - busy / wall). ``extra``
    goes into every line."""
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
            "profile", **extra, query=name,
            events="device" if on_device else "host",
            wall_ms=wall_ms, device_busy_ms=busy_ms,
            device_idle_share=1 - busy_ms / wall_ms if wall_ms else None,
            top=[{"ms": ms, "calls": c, "name": k} for ms, c, k in kernels[:8]],
        )


# columns of TPC-H Q1 (the Q6 columns are a subset): staged once
Q1_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
              "l_discount", "l_tax", "l_shipdate")
QD_ROWS = 1 << 25        # Q-D's memory table: the first 2^25 lineitem rows
Q_D = ("select l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice), "
       "count(*) from memory.default.lineitem_d group by 1, 2")


def _day(y: int, m: int, d: int) -> int:
    import datetime

    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _half_up(num: int, den: int) -> int:
    """num / den rounded half away from zero (Trino's DECIMAL rounding)."""
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return q if num >= 0 else -q


def tpch_q1_q6_oracle(cols: dict, flags: list, statuses: list) -> dict:
    """Rows of TPC-H Q1 and Q6 over the generated lineitem arrays, in exact
    integer arithmetic: DECIMAL(12,2) columns are int64 cents, products
    stay below 2^40 a row, and every sum is taken over chunks of 2^22 rows
    (each chunk sum far below 2^63) added as Python ints."""
    from decimal import Decimal

    ship = cols["l_shipdate"]
    price, disc, tax, qty = (cols[c] for c in (
        "l_extendedprice", "l_discount", "l_tax", "l_quantity"))
    step = 1 << 22

    def total(x, mask) -> int:
        return sum(int(x[i:i + step][mask[i:i + step]].sum(dtype=np.int64))
                   for i in range(0, len(x), step))

    keep = ship <= _day(1998, 12, 1) - 90
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    q1 = []
    for f in range(len(flags)):
        for st in range(len(statuses)):
            m = keep & (cols["l_returnflag"] == f) & (cols["l_linestatus"] == st)
            n = int(m.sum())
            if not n:
                continue
            s_qty, s_price, s_disc = total(qty, m), total(price, m), total(disc, m)
            q1.append((
                flags[f], statuses[st],
                Decimal(s_qty) / 100, Decimal(s_price) / 100,
                Decimal(total(disc_price, m)) / 10**4,
                Decimal(total(charge, m)) / 10**6,
                Decimal(_half_up(s_qty, n)) / 100,
                Decimal(_half_up(s_price, n)) / 100,
                Decimal(_half_up(s_disc, n)) / 100,
                n,
            ))
    q1.sort(key=lambda r: (r[0], r[1]))
    m6 = ((ship >= _day(1994, 1, 1)) & (ship < _day(1995, 1, 1))
          & (disc >= 5) & (disc <= 7) & (qty < 2400))
    q6 = [(Decimal(total(price * disc, m6)) / 10**4,)]
    return {"Q-T1": q1, "Q-T6": q6}


def qd_oracle(cols: dict, flags: list, statuses: list) -> list:
    """Rows of Q-D over the first QD_ROWS lineitem rows, exact."""
    from decimal import Decimal

    out = []
    f_col, s_col = cols["l_returnflag"][:QD_ROWS], cols["l_linestatus"][:QD_ROWS]
    for f in range(len(flags)):
        for st in range(len(statuses)):
            m = (f_col == f) & (s_col == st)
            n = int(m.sum())
            if n:
                out.append((
                    flags[f], statuses[st],
                    Decimal(int(cols["l_quantity"][:QD_ROWS][m].sum())) / 100,
                    Decimal(int(cols["l_extendedprice"][:QD_ROWS][m].sum())) / 100,
                    n,
                ))
    return sorted(out)


def phase_tpch(smi: str) -> int:
    """TPC-H Q1 and Q6 at SF10 from the port's tpch connector, and Q-D
    (a narrow-DECIMAL GROUP BY over a 2^25-row memory table of the same
    rows) through ``LocalQueryRunner(device="cuda")`` in distributed mode,
    once cold and 3 times warm, against exact integer oracles; returns
    the dense group-by launches of this path's run (Q-D's)."""
    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch import types as T
    from trino_tpu_torch.benchmarks.tpch import queries
    from trino_tpu_torch.columnar import Batch, Column
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
    from trino_tpu_torch.exec.streaming import slab_stage_rows
    from trino_tpu_torch.ops import dense_groupby as DG
    from trino_tpu_torch.testing import LocalQueryRunner

    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    tpch = runner.catalogs.get("tpch")
    schema = f"sf{SF}"
    cap = slab_stage_rows(runner.session)
    t0 = time.perf_counter()
    slab, n_line = tpch.device_slab(
        schema, "lineitem", Q1_COLUMNS, cap,
        int(runner.session.get("stream_device_cache_bytes")), device="cuda",
    )
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    slab_bytes = sum(c.data.numel() * c.data.element_size() for c in slab.columns)
    log("tpch", card=smi, schema=schema, lineitem_rows=n_line,
        slab_rows=slab.capacity, slab_bytes=slab_bytes, generate_and_stage_s=gen_s,
        disk_cache=tpch.disk_cache_stats())
    # the oracle reads the same generated arrays back from the card
    t0 = time.perf_counter()
    cols = {name: c.data[:n_line].cpu().numpy()
            for name, c in zip(Q1_COLUMNS, slab.columns)}
    flags = slab.columns[0].dictionary.values
    statuses = slab.columns[1].dictionary.values
    oracle = tpch_q1_q6_oracle(cols, flags, statuses)
    # Q-D: the first 2^25 rows as a memory table (VARCHAR codes with the
    # connector's dictionaries, DECIMAL(12,2) cents)
    dec = T.decimal(12, 2)
    qd_cols = ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice")
    qd_types = (T.VARCHAR, T.VARCHAR, dec, dec)
    mem = runner.catalogs.get("memory")
    mem.create_table("default", "lineitem_d", TableSchema("lineitem_d", tuple(
        ColumnSchema(c, t) for c, t in zip(qd_cols, qd_types))))
    mem.insert("default", "lineitem_d", Batch([
        Column(t, torch.from_numpy(cols[c][:QD_ROWS].copy()), None,
               slab.columns[Q1_COLUMNS.index(c)].dictionary)
        for c, t in zip(qd_cols, qd_types)
    ], QD_ROWS))
    oracle["Q-D"] = qd_oracle(cols, flags, statuses)
    del cols, slab
    log("tpch", card=smi, oracle_s=time.perf_counter() - t0)
    runs = {
        "Q-T1": (queries(f"tpch.{schema}")[1], n_line),
        "Q-T6": (queries(f"tpch.{schema}")[6], n_line),
        "Q-D": (Q_D, QD_ROWS),
    }
    plans = []
    real_dense = DG.dense_groupby_device

    def logged_dense(plan, *args, **kwargs):
        plans.append(plan)
        return real_dense(plan, *args, **kwargs)

    DG.dense_groupby_device = logged_dense
    # the main path's run: every count starts at 0 here and is read after
    _kernels.reset_counts()
    try:
        for name, (sql, scanned) in runs.items():
            times, per_run = [], []
            reset_peak()
            for _ in range(1 + WARM):
                before = _kernels.LAUNCHES["dense_groupby"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = runner.engine.execute_statement(sql, runner.session)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                per_run.append(_kernels.LAUNCHES["dense_groupby"] - before)
                rows = res.rows if name != "Q-D" else sorted(res.rows)
                if rows != oracle[name]:
                    raise AssertionError(f"{name}: rows differ from the exact oracle")
            modes = {str(f): m for f, m in (res.fragment_modes or {}).items()}
            if "streamed" not in modes.values():
                raise AssertionError(f"{name}: no fragment streamed")
            if name == "Q-D":
                if per_run != [1] * (1 + WARM):
                    raise AssertionError(f"Q-D: K1 launches per run {per_run}, not 1")
                if not all(p.pair128 == (True, True) for p in plans):
                    raise AssertionError(f"Q-D: not a pair128 plan: {plans[0]}")
            warm = statistics.median(times[1:])
            stats = res.exchange_stats or {}
            log(
                "tpch", card=smi, query=name, rows=len(res.rows),
                cold_ms=times[0], warm_median_ms=warm, warm_ms=times[1:],
                rows_per_s=scanned / (warm / 1e3), k1_launches_per_run=per_run,
                fragment_modes=modes,
                overflow_retries=stats.get("overflow_retries"),
                peak_device_bytes=read_peak(),
                matches_oracle=True,
            )
    finally:
        DG.dense_groupby_device = real_dense
    launches = dict(_kernels.LAUNCHES)
    log("tpch", card=smi, launches=launches,
        qd_plan={"G": plans[0].G,
                 "cols": [[c.nonneg, c.bits] for c in plans[0].cols],
                 "pair128": list(plans[0].pair128)})
    phase_profile(runner, {q: sql for q, (sql, _) in runs.items()}, card=smi)
    tpch_spans(runner, {q: runs[q][0] for q in ("Q-T1", "Q-T6")}, smi)
    check_pool(runner.engine, "tpch")
    return launches["dense_groupby"]


def tpch_spans(runner, queries, smi: str) -> None:
    """Where a warm Q-T1/Q-T6 goes, on the host clock, each span ending in
    a synchronise: each chunk's filter and projections (inside them, the
    128-bit products), its aggregation step (inside it, the grouping sorts
    and the 32-bit limb sums), and the finish. ``rest_ms`` is planning,
    the slab lookup, the final fragments and the rows' conversion."""
    from trino_tpu_torch.compiler import ExprCompiler
    from trino_tpu_torch.exec.streaming import StreamingAggregator
    from trino_tpu_torch.ops import decimal128, keypack

    outer = [(StreamingAggregator, "_chunk_prep", "filter_project_ms"),
             (StreamingAggregator, "_step", "aggregate_ms"),
             (StreamingAggregator, "_finish", "finish_ms")]
    inner = [(ExprCompiler, "_arith_wide", "wide_arith_ms"),
             (keypack, "grouping_sort", "sort_ms"),
             (decimal128, "narrow_limb_sums", "limb_sums_ms"),
             (decimal128, "wide_limb_sums", "limb_sums_ms")]
    for name, out in timed_spans(runner, queries, outer + inner).items():
        # the inner spans run inside the outer ones: counted once
        out["rest_ms"] += sum(out[label] for label in {lb for *_, lb in inner})
        log("spans", card=smi, query=name, **out)


TPCH22_SCHEMA = "sf1"     # the all-22 phase's scale factor
TPCH22_WARM = 2
TPCH22_PEAKS = (5, 6)     # queries whose peak device memory is attributed
# queries with a join fragment that streams on the lineitem probe spine
TPCH22_STREAMED = (3, 5, 7, 10, 17, 19)
TPCH22_WARM_TOTAL: dict = {}  # phase tpch22's in-process warm sum, for phase server
TPCH22_WARM_MS: dict = {}  # phase tpch22's in-process warm ms a query, for phase cluster


def peak_attribution(runner, sql: str, top: int = 8, with_joins: bool = False) -> dict:
    """Where one more run of ``sql`` peaks in device memory, after every
    stored program was evicted (the eager warm-up at the settled
    capacities before each capture, whose allocations are the
    operators', and the capture into the graph pool): each
    fragment's own peak (the peak counter reset as it starts), and the
    largest allocations alive at the query's peak, each with the
    innermost frame of the port that made it, from the caching
    allocator's history (``torch.cuda.memory._record_memory_history``),
    replayed event by event. Memory allocated before the run (cached
    tables, staged columns) is the ``baseline``. ``with_joins`` adds each
    traced join of the peak fragment: its probe and build rows and
    capacities and its output rows and capacity (host reads, so only in
    this extra run)."""
    import torch

    from trino_tpu_torch.exec.fragments import FragmentedExecutor

    from trino_tpu_torch.exec.fragments import _FragmentTracer

    real = FragmentedExecutor._run_fragment
    real_join = _FragmentTracer._exec_join
    frag_peaks, joins = {}, []

    def run(self, frag, results, names_holder):
        torch.cuda.synchronize()
        reset_peak()
        out = real(self, frag, results, names_holder)
        torch.cuda.synchronize()
        frag_peaks[frag.id] = read_peak()
        return out

    def join(self, node):
        out = real_join(self, node)
        if torch.cuda.is_current_stream_capturing():
            return out  # a capture records, reads nothing: its warm-up was read
        left, right = self._exec(node.left), self._exec(node.right)
        joins.append({
            "fragment": self.fragment_id, "site": self._site("join", node),
            "type": node.join_type,
            "strategy": self.caps.join_strategies.get(self._site("densejoin", node), "sort"),
            "probe_rows": left.batch.count_rows(), "probe_capacity": left.batch.capacity,
            "build_rows": right.batch.count_rows(), "build_capacity": right.batch.capacity,
            "output_rows": out.batch.count_rows(), "output_capacity": out.batch.capacity,
        })
        return out

    runner.engine.program_pool.evict_lru()
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python", max_entries=2_000_000
    )
    FragmentedExecutor._run_fragment = run
    if with_joins:
        _FragmentTracer._exec_join = join
    try:
        runner.engine.execute_statement(sql, runner.session)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        FragmentedExecutor._run_fragment = real
        _FragmentTracer._exec_join = real_join
        torch.cuda.memory._record_memory_history(enabled=None)
    events = snap["device_traces"][torch.cuda.current_device()]

    def replay(stop=None):
        alive, total, best, best_i = {}, 0, 0, -1
        for i, e in enumerate(events):
            if e["action"] == "alloc":
                alive[e["addr"]] = e
                total += e["size"]
            elif e["action"] == "free_completed" and e["addr"] in alive:
                total -= alive.pop(e["addr"])["size"]
            if total > best:
                best, best_i = total, i
            if i == stop:
                return alive
        return best, best_i

    peak_run, at = replay()
    alive = replay(stop=at) if at >= 0 else {}

    def site(e):
        for f in e.get("frames") or []:
            if "trino_tpu_torch" in f.get("filename", ""):
                name = f["filename"].split("trino_tpu_torch/")[-1]
                return f"{name}:{f['line']} {f['name']}"
        return "?"

    largest = sorted(alive.values(), key=lambda e: e["size"], reverse=True)[:top]
    by_site: dict[str, int] = {}
    for e in alive.values():
        by_site[site(e)] = by_site.get(site(e), 0) + e["size"]
    peak_fragment = max(frag_peaks, key=frag_peaks.get) if frag_peaks else None
    return {
        "baseline_bytes": baseline,
        "peak_bytes": baseline + peak_run,
        "fragment_peak_bytes": frag_peaks,
        "peak_fragment": peak_fragment,
        "peak_fragment_joins": [j for j in joins if j["fragment"] == peak_fragment],
        "largest_alive": [{"bytes": e["size"], "site": site(e)} for e in largest],
        "alive_bytes_by_site": dict(sorted(
            by_site.items(), key=lambda kv: kv[1], reverse=True)[:top]),
    }


# phase programs: one literal variant a query with hoisted literals (the
# substitution is applied to every occurrence), and Q6's batch
PROGRAM_VARIANTS = {
    1: ("interval '90' day", "interval '60' day"),
    3: ("date '1995-03-15'", "date '1995-03-22'"),
    4: ("date '1993-07-01'", "date '1993-10-01'"),
    5: ("date '1994-01-01'", "date '1995-01-01'"),
    6: ("l_quantity < 24", "l_quantity < 25"),
    8: ("date '1995-01-01' and date '1996-12-31'", "date '1995-03-01' and date '1996-10-31'"),
    10: ("date '1993-10-01'", "date '1994-01-01'"),
    11: ("* 0.0001", "* 0.0002"),
    12: ("date '1994-01-01'", "date '1995-01-01'"),
    14: ("date '1995-09-01'", "date '1995-10-01'"),
    15: ("date '1996-01-01'", "date '1996-04-01'"),
    17: ("0.2 * avg", "0.3 * avg"),
    19: ("between 1 and 5", "between 1 and 6"),
    20: ("date '1994-01-01'", "date '1995-01-01'"),
}
PROGRAM_BATCH = 8                   # Q6 variants in one batch
PROGRAM_IDLE_QUERIES = (9, 10)  # one query materialized, one streamed


def program_variant(q: int, sql: str):
    """The literal variant of query ``q`` (None when it has none)."""
    if q not in PROGRAM_VARIANTS:
        return None
    old, new = PROGRAM_VARIANTS[q]
    if old not in sql:
        raise AssertionError(f"Q{q}: {old!r} is not in the query text")
    return sql.replace(old, new)


def pool_counts(eng, before: dict | None = None) -> dict:
    """The graph pool's captures and evicted programs (since ``before``,
    an earlier result of this function), its reserved bytes and the
    programs stored."""
    pool = eng.program_pool
    now = {"captures": pool.captures, "evicted_programs": pool.evicted}
    if before is not None:
        now = {k: v - before[k] for k, v in now.items()}
        now["pool_reserved_bytes"] = pool.reserved_bytes()
        now["stored_programs"] = len(pool._lru)
        now["stored_program_bytes"] = pool.held_bytes()
    return now


@contextlib.contextmanager
def k2_checked(builds: list, query: list):
    """Within the block every K2 build (``build_table_cuda``) is held
    against ``build_table_plain`` on the same inputs (slot bases, live
    rows, capacity, window): one record a build appended to ``builds``,
    with ``query[0]``, the table's largest difference and the unplaced
    counts' difference. A capture's builds are recorded, not run, and are
    not checked (its eager warm-up's were)."""
    import torch

    from trino_tpu_torch.ops import dense_join as DJ

    real = DJ.build_table_cuda

    def checked(slot_base, use, capacity, window):
        out = real(slot_base, use, capacity, window)
        if torch.cuda.is_current_stream_capturing():
            return out
        ptable, punplaced = DJ.build_table_plain(slot_base, use, capacity, window)
        builds.append({
            "query": query[0], "rows": int(slot_base.shape[0]),
            "live": int(use.sum()), "capacity": capacity, "window": window,
            "unplaced": int(out[1]),
            "max_abs_err": int((out[0].to(torch.int64)
                                - ptable.to(torch.int64)).abs().max()),
            "unplaced_err": abs(int(out[1]) - int(punplaced)),
        })
        return out

    DJ.build_table_cuda = checked
    try:
        yield builds
    finally:
        DJ.build_table_cuda = real


def k2_against_plain(runner, texts: dict) -> list:
    """One more run of each of ``texts`` after every stored program was
    evicted (the eager warm-up at the query's settled capacities that
    precedes each capture: the builds a replay repeats), with every K2
    build held against ``build_table_plain`` on the same inputs (slot
    bases, live rows, capacity, window): the table and the unplaced count
    must be equal. The captures' builds are recorded, not run, and are
    not checked. Returns one record a build, with the query that made
    it."""
    builds, query = [], [None]
    for name, sql in texts.items():
        # a warm run first: the query's program-cache entry may have left
        # the engine's LRU since the phase's runs, and a cold run's
        # capacity ladder builds more tables than a warm run launches
        runner.engine.execute_statement(sql, runner.session)
        query[0] = name
        pool = runner.engine.program_pool
        pool.evict_lru()
        before = (pool.captures, pool.evicted, pool.dropped, len(builds))
        with k2_checked(builds, query):
            res = runner.engine.execute_statement(sql, runner.session)
        st = res.exchange_stats or {}
        log("k2check", query=name, builds=len(builds) - before[3],
            trace_count=res.trace_count, captures=pool.captures - before[0],
            evicted_programs=pool.evicted - before[1], dropped_graphs=pool.dropped - before[2],
            **{k: st.get(k) for k in ("overflow_retries", "program_evictions",
                                       "compile_halvings", "fused_fallbacks",
                                       "program_fallbacks", "fusedFragments")})
    return builds


def tpch_sf1_runner(smi: str):
    """A ``LocalQueryRunner(device="cuda")`` in distributed mode whose tpch
    connector has the eight ``tpch.sf1`` tables generated (comments from
    the text pool the port's native loader builds) and staged on the
    card, with a line of seconds and staged bytes per table."""
    import torch

    from trino_tpu_torch import native
    from trino_tpu_torch.connectors import dbgen
    from trino_tpu_torch.connectors.tpch import _SCHEMAS, TpchConnector
    from trino_tpu_torch.exec.streaming import slab_stage_rows
    from trino_tpu_torch.testing import LocalQueryRunner

    t0 = time.perf_counter()
    native.load()
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dbgen.text_pool()
    log("tpch22", card=smi, native_build_s=native_s,
        text_pool_s=time.perf_counter() - t0)
    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    tpch = TpchConnector()
    runner.catalogs.register("tpch", tpch)
    cap = slab_stage_rows(runner.session)
    max_bytes = int(runner.session.get("stream_device_cache_bytes"))
    staged = {}
    t_all = time.perf_counter()
    for table, cols in _SCHEMAS.items():
        t0 = time.perf_counter()
        slab, rows = tpch.device_slab(
            TPCH22_SCHEMA, table, [c for c, _ in cols], cap, max_bytes,
            device="cuda",
        )
        torch.cuda.synchronize()
        staged[table] = {
            "rows": rows,
            "staged_bytes": sum(
                c.data.numel() * c.data.element_size() for c in slab.columns
            ),
            "generate_and_stage_s": time.perf_counter() - t0,
        }
    log("tpch22", card=smi, schema=TPCH22_SCHEMA, tables=staged,
        generate_and_stage_s=time.perf_counter() - t_all,
        disk_cache=tpch.disk_cache_stats())
    return runner


def phase_tpch22(smi: str, runner) -> tuple[dict, int]:
    """All 22 TPC-H queries, spec text, at SF1 from the port's tpch
    connector through ``runner`` (:func:`tpch_sf1_runner`), each query
    once cold and twice warm, its rows and column types held against the
    reference's answers (``tpch_sf1_answers.json``) exactly, in ORDER BY
    order (rows whose ORDER BY keys tie as a multiset). Every K2 build of
    the cold runs (the eager warm-ups and their capacity ladders) is held
    against its plain version as it runs (:func:`k2_checked`; the cold
    times include that). Returns the kernel launches of this path's run
    and the largest K2 error over those builds."""
    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch.benchmarks import tpch as B

    answers = B.load_answers()
    if answers["schema"] != f"tpch.{TPCH22_SCHEMA}":
        raise AssertionError(f"answers are for {answers['schema']}")
    texts = B.queries(f"tpch.{TPCH22_SCHEMA}")
    failures, warm_ms, peaks, builds, cold_launches = [], {}, {}, [], {}
    pool_before = pool_counts(runner.engine)
    # the main path's run: every count starts at 0 here and is read after
    _kernels.reset_counts()
    for q in range(1, 23):
        want = answers["queries"][str(q)]
        times, k1, k2, traces = [], [], [], []
        reset_peak()
        for run in range(1 + TPCH22_WARM):
            before = dict(_kernels.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (k2_checked(builds, [f"Q{q}"]) if run == 0 else contextlib.nullcontext()):
                res = runner.engine.execute_statement(texts[q], runner.session)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            k1.append(_kernels.LAUNCHES["dense_groupby"] - before["dense_groupby"])
            k2.append(_kernels.LAUNCHES["dense_join_build"] - before["dense_join_build"])
            traces.append(res.trace_count)
            types = [t.name for t in res.column_types]
            bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"],
                                   want["order_by"])
            if bad is None and types != want["types"]:
                bad = f"column types {types} != {want['types']}"
            if bad is not None:
                failures.append(f"Q{q}: {bad}")
                break
        warm_ms[q] = statistics.median(times[1:]) if len(times) > 1 else times[0]
        cold_launches[f"Q{q}"] = k2[0]
        peaks[q] = read_peak()
        stats = res.exchange_stats or {}
        log(
            "tpch22", card=smi, query=f"Q{q}", rows=len(res.rows),
            matches_reference=bad is None, cold_ms=times[0],
            warm_median_ms=warm_ms[q], warm_ms=times[1:],
            k1_launches_per_run=k1, k2_launches_per_run=k2, trace_count_per_run=traces,
            joinStrategy=stats.get("joinStrategy"),
            overflow_retries=stats.get("overflow_retries"),
            peak_device_bytes=read_peak(),
            **stream_fields(res),
        )
        if q in TPCH22_STREAMED and not stats.get("join_streams"):
            failures.append(f"Q{q}: no join fragment streamed")
    launches = dict(_kernels.LAUNCHES)
    TPCH22_WARM_TOTAL["ms"] = sum(warm_ms.values())
    TPCH22_WARM_MS.update(warm_ms)
    log("tpch22", card=smi, launches=launches,
        warm_total_ms=sum(warm_ms.values()), max_peak_device_bytes=max(peaks.values()),
        **pool_counts(runner.engine, pool_before))
    if failures:
        raise AssertionError("rows differ from the reference: " + "; ".join(failures))
    # every K2 build of the cold runs against its plain version, at the
    # shapes this path gave it
    k2_err = check_cold_builds("tpch22", smi, builds, cold_launches)
    slowest = sorted(warm_ms, key=warm_ms.get, reverse=True)[:3]
    three = {f"Q{q}": texts[q] for q in slowest}
    phase_profile(runner, three, card=smi)
    phase_spans(runner, three)
    for q in TPCH22_PEAKS:
        log("peak", card=smi, query=f"Q{q}",
            **peak_attribution(runner, texts[q]))
    return launches, k2_err


def phase_programs(smi: str, runner) -> tuple[dict, int]:
    """Phase ``programs``: the 22 TPC-H queries at SF1 (phase tpch22's
    runner and staged tables) through the program cache, with pipeline
    fusion on. Per query its program-cache entry is dropped, then a cold
    run (its programs warmed up eagerly and captured as CUDA graphs,
    every K2 build of the warm-ups held against ``build_table_plain``)
    and a warm hit, both held against the committed answers; the warm
    hit must trace nothing and hit at least once, and runs whole under
    ``programs.checked_syncs`` (``torch.cuda.set_sync_debug_mode
    ("error")``: every synchronization raises but the counted host reads
    of ``programs.allow_sync``: the programs' words, dynamic-filter
    lookups, the result's read, and the fragments that are no program,
    which ``host_synced_fragments`` counts). Each query's literal variant
    runs through the cache under the same check, right after its query;
    once the phase's launches are read, each variant runs again with
    ``program_cache=false`` (uncached, launches logged apart) and must
    equal the cached rows bit for bit; a batch of 8 literal variants of Q6 against the 8 run one after
    the other; and the device's idle share of a warm replay of each of
    :data:`PROGRAM_IDLE_QUERIES` beside the same query with
    ``pipeline_fusion`` and ``program_cache`` off. Returns the kernel launches of its cold and
    warm runs and the largest K2 error of the warm-ups' builds."""
    import threading

    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.exec.programs import checked_syncs
    from trino_tpu_torch.ops import dense_join as DJ
    from trino_tpu_torch.testing import LocalQueryRunner

    t_phase = time.perf_counter()
    eng = runner.engine
    answers = B.load_answers()
    texts = B.queries(f"tpch.{TPCH22_SCHEMA}")
    failures = []
    # the K2 builds of the cold runs' warm-ups (not of their captures)
    real, builds, current = DJ.build_table_cuda, [], [None]

    def checked(slot_base, use, capacity, window):
        out = real(slot_base, use, capacity, window)
        if torch.cuda.is_current_stream_capturing():
            return out
        ptable, punplaced = DJ.build_table_plain(slot_base, use, capacity, window)
        builds.append({
            "query": current[0], "rows": int(slot_base.shape[0]),
            "max_abs_err": int((out[0].to(torch.int64) - ptable.to(torch.int64)).abs().max()),
            "unplaced_err": abs(int(out[1]) - int(punplaced)),
        })
        return out

    def held(q, res):
        want = answers["queries"][str(q)]
        bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"], want["order_by"])
        if bad is None and [t.name for t in res.column_types] != want["types"]:
            bad = "column types differ"
        return bad

    # a literal variant runs the text with the cache off too (baked)
    baked = LocalQueryRunner(session=Session(), engine=eng)
    for k, v in runner.session.properties.items():
        baked.session.properties[k] = v
    baked.session.set("program_cache", False)
    pool_before = pool_counts(eng)
    _kernels.reset_counts()
    warm_ms, variants = {}, {}
    for q in range(1, 23):
        eng.drop_query_cache(eng.fingerprint(texts[q], runner.session)[0])
        current[0] = f"Q{q}"
        DJ.build_table_cuda = checked
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cold = eng.execute_statement(texts[q], runner.session)
            torch.cuda.synchronize()
            cold_ms = (time.perf_counter() - t0) * 1e3
        finally:
            DJ.build_table_cuda = real
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with checked_syncs("cuda"):
                warm = eng.execute_statement(texts[q], runner.session)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        warm_ms[q] = min(times)
        ex = warm.exchange_stats or {}
        for what, res in (("cold", cold), ("warm", warm)):
            bad = held(q, res)
            if bad is not None:
                failures.append(f"Q{q} {what}: {bad}")
        if warm.trace_count != 0 or warm.program_cache_hits < 1:
            failures.append(f"Q{q} warm: trace_count {warm.trace_count}, "
                            f"hits {warm.program_cache_hits}")
        log("programs", card=smi, query=f"Q{q}", cold_ms=cold_ms,
            capture_ms=cold.compile_ms, programs=cold.trace_count,
            warm_ms=warm_ms[q], warm_runs_ms=times, warm_trace_count=warm.trace_count,
            warm_hits=warm.program_cache_hits,
            host_reads_per_warm_run=ex.get("host_reads"),
            host_synced_fragments=ex.get("host_synced_fragments", 0),
            fused_fragments=ex.get("fusedFragments", 0),
            fused_fallbacks=ex.get("fused_fallbacks", 0),
            dispatch_round_trips=ex.get("dispatchRoundTrips"),
            modes=sorted(set((warm.fragment_modes or {}).values())),
            pool_bytes=ex.get("program_pool_bytes"),
            cold_mismatch=held(q, cold), warm_mismatch=held(q, warm))
        if q in PROGRAM_VARIANTS:
            # the variant through the query's entry while it is hot,
            # checked as the warm runs are
            sql = program_variant(q, texts[q])
            with checked_syncs("cuda"):
                hit = eng.execute_statement(sql, runner.session)
            variants[q] = (sql, hit)
            if hit.trace_count != 0:
                failures.append(f"Q{q} variant: trace_count {hit.trace_count}")
    launches = dict(_kernels.LAUNCHES)
    k2_err = max([max(b["max_abs_err"], b["unplaced_err"]) for b in builds] or [0])
    log("programs", card=smi, launches=launches, **pool_counts(eng, pool_before),
        k2_warmup_builds=len(builds), k2_max_abs_err=k2_err,
        warm_total_ms=sum(warm_ms.values()))
    if k2_err:
        failures.append(f"K2 != plain on a warm-up's build (max |err| {k2_err})")
    # each variant baked, uncached, after the counts were read: these
    # runs are the yardstick, not the program path
    before = dict(_kernels.LAUNCHES)
    for q, (sql, hit) in variants.items():
        off = eng.execute_statement(sql, baked.session)
        same = hit.rows == off.rows
        if not same:
            failures.append(f"Q{q} variant: cached rows != uncached rows")
        log("programs", card=smi, variant=f"Q{q}", equal_to_uncached=same,
            rows=len(hit.rows), trace_count=hit.trace_count,
            hits=hit.program_cache_hits)
    log("programs", card=smi, uncached_variant_launches={
        k: v - before.get(k, 0) for k, v in _kernels.LAUNCHES.items()})
    # a batch of 8 literal variants of Q6 against the 8 run in sequence
    # (Q6 below the streaming threshold: one program, which the batch replays)
    sqls = [texts[6].replace("l_quantity < 24", f"l_quantity < {20 + i}")
            for i in range(PROGRAM_BATCH)]
    one = Session()
    one.properties.update(runner.session.properties)
    one.set("stream_scan_threshold_rows", 1 << 24)
    seq = [eng.execute_statement(sql, one).rows for sql in sqls]
    sessions = []
    for _ in sqls:
        sess = Session()
        sess.properties.update(one.properties)
        sess.set("batch_window_ms", 5000)
        sess.set("batch_max_size", PROGRAM_BATCH)
        sessions.append(sess)
    out, errors = [None] * len(sqls), []

    def member(i):
        try:
            out[i] = eng.execute_statement(sqls[i], sessions[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    before = dict(eng.batch_collector.dispatches)
    threads = [threading.Thread(target=member, args=(i,)) for i in range(len(sqls))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    batch_ms = (time.perf_counter() - t0) * 1e3
    sizes = {k: v - before.get(k, 0) for k, v in eng.batch_collector.dispatches.items()
             if v != before.get(k, 0)}
    equal = not errors and [r.rows for r in out] == seq
    log("programs", card=smi, batch=len(sqls), equal_to_sequential=equal,
        batched=all(r is not None and r.batch_stats is not None for r in out),
        dispatch_sizes=sizes, batch_ms=batch_ms, errors=errors,
        batch_stats=[r.batch_stats for r in out if r is not None][:1])
    if not equal:
        failures.append("Q6 batch != sequential runs")
    # idle share of a warm replay, beside the unfused uncached run
    phase_profile(runner, {f"Q{q}": texts[q] for q in PROGRAM_IDLE_QUERIES},
                  card=smi, path="programs")
    eager = LocalQueryRunner(session=Session(), engine=eng)
    for k, v in runner.session.properties.items():
        eager.session.properties[k] = v
    eager.session.set("pipeline_fusion", False)
    eager.session.set("program_cache", False)
    phase_profile(eager, {f"Q{q}": texts[q] for q in PROGRAM_IDLE_QUERIES},
                  card=smi, path="eager")
    log("programs", card=smi, phase_s=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("phase programs: " + "; ".join(failures))
    return launches, k2_err


SERVER_WARM = 3           # warm runs of Q-A and Q-B over HTTP
SERVER_CLIENTS = 8        # concurrent clients, one Q6 literal variant each
# a third of orders (500,000 rows, ~120 pages of the 1 MiB budget): the
# pager's bound shows as on all of it, and the script keeps within 900 s
SERVER_EXTRACT = ("select o_orderkey, o_custkey, o_totalprice, o_orderdate "
                  "from tpch.sf1.orders where o_orderkey <= 2000000")
# its order-free checksum in-process (:func:`order_free_checksum`)
SERVER_EXTRACT_CHECKSUM = ("select count(*), sum(o_orderkey), sum(o_custkey), "
                           "sum(o_totalprice), "
                           "sum(date_diff('day', date '1970-01-01', o_orderdate)) "
                           "from tpch.sf1.orders where o_orderkey <= 2000000")
# a partitioned join on the mesh: both sides hash-repartitioned, then the
# aggregate's exchange
SERVER_MESH_SQL = ("select c_mktsegment, count(*), sum(o_totalprice) from tpch.sf1.orders "
                   "join tpch.sf1.customer on o_custkey = c_custkey "
                   "group by c_mktsegment order by c_mktsegment")


def http_json(uri: str, method: str = "GET", body: Optional[bytes] = None):
    """One request, with the internal credential where the process has a
    cluster's shared secret (phase ``cluster``)."""
    import urllib.request

    from trino_tpu_torch.server import auth

    req = urllib.request.Request(uri, data=body, method=method, headers=auth.headers())
    with urllib.request.urlopen(req, timeout=60) as r:
        raw = r.read().decode()
    try:
        return json.loads(raw)
    except ValueError:
        return raw


@contextlib.contextmanager
def replays_counted(counts: dict, *key):
    """Within the block, the K2 launches that CUDA graph replays count
    (``_kernels.count_replay``) are added up in ``counts[key]``."""
    from trino_tpu_torch import _kernels

    real = _kernels.count_replay

    def counted(launches):
        counts[key] = counts.get(key, 0) + launches.get("dense_join_build", 0)
        return real(launches)

    _kernels.count_replay = counted
    try:
        yield counts
    finally:
        _kernels.count_replay = real


def order_free_checksum(rows) -> list:
    """Rows of (key, key, DECIMAL, DATE text): the count, the sums of the
    first three columns and the sum of the dates' days since 1970-01-01,
    as :data:`SERVER_EXTRACT_CHECKSUM` computes them in SQL."""
    import datetime

    epoch = datetime.date(1970, 1, 1).toordinal()
    out = [len(rows), 0, 0, Decimal(0), 0]
    for a, b, c, d in rows:
        out[1] += a
        out[2] += b
        out[3] += c
        out[4] += datetime.date.fromisoformat(d).toordinal() - epoch
    return [str(x) for x in out]


def phase_server(smi: str, runner) -> tuple[dict, int, int]:
    """Phase ``server``: the port's coordinator server
    (``trino_tpu_torch.server.http.TrinoTpuServer``) over ``runner``'s
    engine (phase tpch22's staged ``tpch.sf1`` tables), on
    ``127.0.0.1:0``, queried over HTTP by the port's client, DB-API and
    statement protocol. Steps, a ``server`` line each:

    1. Q-A and Q-B over the 2^25-row ``memory.default.bench_groupby``
       through ``client.Connection`` (distributed, streamed from 2^20
       rows), once cold (each K1 launch held against plain) and 3 times
       warm: K1 launches every run, rows equal the numpy oracle;
    2. the 22 TPC-H queries through ``dbapi``, replaying the programs
       that phases tpch22 and programs stored: once (every K2 build that
       is no replay held against plain, :func:`k2_checked`) and once
       warm, decoded rows and column types against the committed
       answers;
    3. 8 clients at once, one Q6 literal variant each (batched), each
       query's ``batchStats`` from ``/v1/query/{id}``;
    4. ``SERVER_EXTRACT`` (500,000 rows) under the default 1 MiB page
       budget: pages, rows/s, the pager's peak buffered bytes within 3x
       the budget;
    5. a partitioned join on a mesh of 4 shards, ``/v1/query/{id}``
       carrying ``exchangeStats`` with at least 2 exchanges;
    6. ``/v1/metrics`` (the query counters) and ``/v1/status`` (the card's
       memory).
    Kernel counts start at 0 before step 1 and are read after step 6.
    Then, uncounted, in-process on the same engine: Q-A and Q-B once each
    and the 22 queries once (the protocol's cost beside each warm HTTP
    time), the Q6 variants and the mesh query (the rows the HTTP steps
    must equal) and the extraction's checksum in SQL; and a graceful drain
    with 4 clients in flight that must all get the Q6 variants' rows.
    Returns the launches, the largest K1 and K2 errors."""
    import threading

    import torch

    from trino_tpu_torch import _kernels, dbapi
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.client import ClientSession, Connection, StatementClient
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.ops import dense_groupby as DG
    from trino_tpu_torch.parallel.mesh import make_mesh
    from trino_tpu_torch.server.http import TrinoTpuServer

    t_phase = time.perf_counter()
    eng = runner.engine
    failures = []
    queries = bench_groupby(eng.catalogs)
    props = dict(runner.session.properties)
    qa_props = {**props, "stream_scan_threshold_rows": 1 << 20}
    q6_props = {**props, "stream_scan_threshold_rows": 1 << 24}
    batch_props = {**q6_props, "batch_window_ms": 5000, "batch_max_size": SERVER_CLIENTS}
    answers = B.load_answers()
    texts = B.queries(f"tpch.{TPCH22_SCHEMA}")
    q6s = [texts[6].replace("l_quantity < 24", f"l_quantity < {20 + i}")
           for i in range(SERVER_CLIENTS)]

    def session(catalog, schema, p):
        return ClientSession(catalog=catalog, schema=schema, properties=dict(p))

    t0 = time.perf_counter()
    server = TrinoTpuServer(engine=eng).start()
    base = server.base_uri
    log("server", card=smi, step="start", uri=base, start_s=time.perf_counter() - t0,
        page_budget_bytes=server.server_config.result_page_max_bytes)
    http_ms, builds, cold_launches, k1_errs = {}, [], {}, []
    real_dense = DG.dense_groupby_device

    def checked_dense(plan, bins, vals):
        lt = real_dense(plan, bins, vals)
        k1_errs.append(int((lt - DG.dense_groupby_plain(plan, bins, vals)).abs().max()))
        return lt

    from trino_tpu_torch.obs.metrics import get_registry

    finished_key = 'trino_tpu_queries_total{state="FINISHED"}'
    finished_before = get_registry().snapshot()["counters"].get(finished_key, 0)
    http_statements = 0
    try:
        # the main path's run over HTTP: every count starts at 0 here
        _kernels.reset_counts()
        # 1. the headline GROUP BY
        conn = Connection(base, session("memory", "default", qa_props))
        for name, (sql, want) in queries.items():
            times, k1 = [], []
            for run in range(1 + SERVER_WARM):
                before = _kernels.LAUNCHES["dense_groupby"]
                DG.dense_groupby_device = checked_dense if run == 0 else real_dense
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rows, _ = conn.execute(sql)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    http_statements += 1
                finally:
                    DG.dense_groupby_device = real_dense
                k1.append(_kernels.LAUNCHES["dense_groupby"] - before)
                if k1[-1] < 1:
                    failures.append(f"{name} over HTTP run {run}: no K1 launch")
                if sorted(rows) != want:
                    failures.append(f"{name} over HTTP run {run}: rows differ from the oracle")
            http_ms[name] = times
            log("server", card=smi, step="groupby", query=name, rows=len(rows),
                cold_ms=times[0], warm_median_ms=statistics.median(times[1:]),
                warm_ms=times[1:], k1_launches_per_run=k1,
                rows_per_s=ROWS / (statistics.median(times[1:]) / 1e3))
        k1_err = max(k1_errs, default=0)
        if k1_err or not k1_errs:
            failures.append(f"K1 against plain over HTTP: {k1_errs}")
        # 2. the 22 TPC-H queries through dbapi, replaying the programs
        # that phases tpch22 and programs stored (their builds were held
        # against plain at capture); the eager builds are held here
        tpch_ms, tpch_k2, replayed = {}, {}, {}
        with dbapi.connect(base_uri=base, catalog="tpch", schema=TPCH22_SCHEMA,
                           session_properties=props) as dconn:
            cur = dconn.cursor()
            for q in range(1, 23):
                want = answers["queries"][str(q)]
                times, k2 = [], []
                for run in range(2):
                    before = _kernels.LAUNCHES["dense_join_build"]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with (k2_checked(builds, [f"Q{q}"]) if run == 0
                          else contextlib.nullcontext()), replays_counted(replayed, q, run):
                        cur.execute(texts[q])
                        rows = cur.fetchall()
                    http_statements += 1
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    k2.append(_kernels.LAUNCHES["dense_join_build"] - before)
                    types = [d[1] for d in cur.description]
                    bad = B.first_mismatch(B.canonical_rows(rows), want["rows"],
                                           want["order_by"])
                    if bad is None and types != want["types"]:
                        bad = f"column types {types} != {want['types']}"
                    if bad is not None:
                        failures.append(f"Q{q} over dbapi run {run}: {bad}")
                # the first run's K2 launches that were not replays
                cold_launches[f"Q{q}"] = k2[0] - replayed.get((q, 0), 0)
                tpch_ms[q], tpch_k2[q] = times, k2
                log("server", card=smi, step="tpch22_dbapi", query=f"Q{q}", rows=len(rows),
                    matches_reference=bad is None, first_ms=times[0], warm_ms=times[1],
                    k2_launches_per_run=k2,
                    k2_replayed_per_run=[replayed.get((q, r), 0) for r in range(2)])
        log("server", card=smi, step="tpch22_dbapi",
            first_total_ms=sum(t[0] for t in tpch_ms.values()),
            warm_total_ms=sum(t[1] for t in tpch_ms.values()),
            tpch22_inprocess_warm_total_ms=TPCH22_WARM_TOTAL.get("ms"))
        # 3. concurrent clients: Q6 literal variants, batched
        Connection(base, session("tpch", TPCH22_SCHEMA, q6_props)).execute(q6s[0])
        out, errors = [None] * len(q6s), []

        def client(i):
            try:
                c = StatementClient(base, q6s[i], session("tpch", TPCH22_SCHEMA, batch_props))
                out[i] = (list(c.rows()), c.query_id)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(q6s))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        wall_ms = (time.perf_counter() - t0) * 1e3
        batch_stats = [http_json(f"{base}/v1/query/{o[1]}")["batchStats"] if o else None
                       for o in out]
        if errors or None in out:
            failures.append(f"concurrent clients: {errors}")
        log("server", card=smi, step="concurrent", clients=len(q6s), wall_ms=wall_ms,
            batch_stats=batch_stats, errors=errors)
        # 4. paged extraction under the default page budget
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = StatementClient(base, SERVER_EXTRACT, session("tpch", TPCH22_SCHEMA, props))
        extracted = list(c.rows())
        extract_s = time.perf_counter() - t0
        pager = server.query_manager.get(c.query_id)._pager
        budget = server.server_config.result_page_max_bytes
        log("server", card=smi, step="extract", rows=len(extracted), seconds=extract_s,
            rows_per_s=len(extracted) / extract_s, pages=pager.pages_produced,
            peak_buffered_bytes=pager.peak_buffered_bytes, page_budget_bytes=budget)
        if pager.peak_buffered_bytes > 3 * budget:
            failures.append(f"extraction buffered {pager.peak_buffered_bytes} bytes, "
                            f"past 3x the page budget {budget}")
        # 5. a partitioned join on the mesh of 4 shards
        eng.mesh = make_mesh(MESH_SHARDS, eng.device)
        try:
            before = _kernels.LAUNCHES["dense_join_build"]
            c = StatementClient(base, SERVER_MESH_SQL, session(
                "tpch", TPCH22_SCHEMA, {**props, "join_distribution_type": "PARTITIONED"}))
            t0 = time.perf_counter()
            with k2_checked(builds, ["mesh"]):
                mesh_rows = list(c.rows())
            mesh_ms = (time.perf_counter() - t0) * 1e3
            cold_launches["mesh"] = _kernels.LAUNCHES["dense_join_build"] - before
        finally:
            eng.mesh = None
        ex = http_json(f"{base}/v1/query/{c.query_id}")["exchangeStats"] or {}
        log("server", card=smi, step="mesh", shards=MESH_SHARDS, rows=len(mesh_rows),
            ms=mesh_ms, k2_launches=cold_launches["mesh"],
            **{k: ex.get(k) for k in MESH_EXCHANGE_KEYS})
        if (ex.get("exchanges") or 0) < 2:
            failures.append(f"mesh query: exchangeStats {ex}")
        # 6. endpoints
        text = http_json(f"{base}/v1/metrics")
        snap = http_json(f"{base}/v1/metrics?format=json")
        # the Q6 warm-up, the concurrent clients, the extraction, the mesh query
        http_statements += len(q6s) + 3
        finished = snap["counters"].get(finished_key, 0) - finished_before
        status = http_json(f"{base}/v1/status")
        card_bytes = torch.cuda.get_device_properties(0).total_memory
        log("server", card=smi, step="endpoints", queries_finished=finished,
            http_statements=http_statements,
            metrics_text_lines=len(text.splitlines()),
            batched_dispatches={k: v for k, v in snap["counters"].items()
                                if k.startswith("trino_tpu_batched_dispatches_total")},
            status_memory=status["memoryInfo"], card_total_memory=card_bytes,
            query_counts=status["queryCounts"])
        if "# TYPE trino_tpu_queries_total counter" not in text or finished < http_statements:
            failures.append(f"/v1/metrics: {finished} finished queries counted, "
                            f"{http_statements} sent")
        if status["memoryInfo"]["totalNodeMemory"] != eng.memory_pool.capacity:
            failures.append(f"/v1/status memory {status['memoryInfo']}")
        launches = dict(_kernels.LAUNCHES)
        log("server", card=smi, launches=launches)
        if launches["dense_join_build"] < 1:
            failures.append("the HTTP path launched no join-build kernel")
        k2_err = check_cold_builds("server", smi, builds, cold_launches)

        # in-process on the same engine, uncounted: the protocol's cost
        # and the rows the HTTP steps must equal
        # (the HTTP runs left each query warm)
        for name, (sql, _) in queries.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.execute_statement(sql, Session(properties=dict(qa_props)))
            torch.cuda.synchronize()
            local_w = (time.perf_counter() - t0) * 1e3
            http_w = statistics.median(http_ms[name][1:])
            log("server", card=smi, step="protocol_cost", query=name,
                http_warm_median_ms=http_w, inprocess_warm_ms=local_w,
                protocol_ms=http_w - local_w)
        local_total = 0.0
        for q in range(1, 23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.execute_statement(texts[q], Session(properties=dict(props)))
            torch.cuda.synchronize()
            local_total += (time.perf_counter() - t0) * 1e3
        http_total = sum(t[1] for t in tpch_ms.values())
        log("server", card=smi, step="tpch22_protocol_cost", http_warm_total_ms=http_total,
            inprocess_warm_total_ms=local_total, protocol_ms=http_total - local_total,
            protocol_ms_per_query=(http_total - local_total) / 22)
        q6_local = [B.canonical_rows(
            eng.execute_statement(sql, Session(properties=dict(q6_props))).rows)
            for sql in q6s]
        for i, local in enumerate(q6_local):
            if out[i] is not None and B.canonical_rows(out[i][0]) != local:
                failures.append(f"client {i}: rows differ from in-process")
        local = eng.execute_statement(SERVER_EXTRACT_CHECKSUM, Session(properties=dict(props)))
        got, want = order_free_checksum(extracted), [str(v) for v in local.rows[0]]
        log("server", card=smi, step="extract_checksum", http=got, inprocess=want)
        if got != want:
            failures.append(f"extraction checksum {got} != in-process {want}")
        local = eng.execute_statement(SERVER_MESH_SQL, Session(properties=dict(props))).rows
        if B.canonical_rows(mesh_rows) != B.canonical_rows(local):
            failures.append("mesh query over HTTP != in-process on one shard")

        # graceful drain: 4 clients in flight, none dropped
        drained, refused, errors = {}, [], []

        def drain_client(i):
            try:
                rows, _ = Connection(base, session("tpch", TPCH22_SCHEMA, q6_props)).execute(
                    q6s[i])
                drained[i] = rows
            except Exception as e:  # noqa: BLE001 — reported below
                if getattr(e, "code", None) == 503:
                    refused.append(i)
                else:
                    errors.append(repr(e))

        n_before = len(server.query_manager.queries())
        threads = [threading.Thread(target=drain_client, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 30
        while (len(server.query_manager.queries()) < n_before + 4
               and time.monotonic() < deadline):
            time.sleep(0.005)
        http_json(f"{base}/v1/info/state", "PUT", b'"SHUTTING_DOWN"')
        for th in threads:
            th.join(120)
        deadline = time.monotonic() + 60
        while server.state != "STOPPED" and time.monotonic() < deadline:
            time.sleep(0.05)
        ok = (not errors and not refused and len(drained) == 4
              and all(B.canonical_rows(drained[i]) == q6_local[i] for i in drained))
        log("server", card=smi, step="drain", admitted=len(drained), refused=refused,
            errors=errors, state=server.state, all_rows_equal=ok)
        if not ok or server.state != "STOPPED":
            failures.append(f"drain: {len(drained)} of 4 served, refused {refused}, "
                            f"errors {errors}, state {server.state}")
    finally:
        DG.dense_groupby_device = real_dense
        eng.mesh = None
        if server.state != "STOPPED":
            server.stop()
        eng.catalogs.get("memory").drop_table("default", "bench_groupby")
    log("server", card=smi, phase_s=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("phase server: " + "; ".join(failures))
    return launches, k1_err, k2_err


OBS_HISTORY_QUERIES = (3, 5, 7)  # TPC-H SF1 queries with K2 sites and cheap cold runs
OBS_DELTA_ROWS = 4096            # rows of the part phase obs appends to bench_groupby
OBS_SPAN_KINDS = ("fragment_execute", "fused_execute")
OBS_COUNTERS = ("trino_tpu_program_compile_ms", "trino_tpu_device_pull_ms",
                "trino_tpu_history_seeds_total", "trino_tpu_program_peak_hbm_bytes",
                "trino_tpu_ingest_decode_ms", "trino_tpu_table_cache_hits_total",
                "trino_tpu_table_cache_misses_total", "trino_tpu_result_cache_hits",
                "trino_tpu_result_cache_maintained", "trino_tpu_fused_programs_total")
# counted only when what they count happens (a halving, a disk-cache read)
OBS_RARE_COUNTERS = ("trino_tpu_compile_halvings_total",
                     "trino_tpu_ingest_disk_cache_hits_total",
                     "trino_tpu_ingest_disk_cache_misses_total")


def check_device_stats(what: str, ds, programs: dict, failures: list) -> int:
    """The profiler's ``deviceStats`` of one query against the captured
    programs they describe (``{label: Program}``): each program's
    ``temp_bytes`` is its pool growth (``capture_bytes``), its peak at
    least its arguments and outputs, and the rollup's peak the largest
    program's. Returns how many programs carried allocator stats."""
    progs = (ds or {}).get("programs") or {}
    seen = 0
    for label, st in progs.items():
        if "temp_bytes" not in st:
            continue
        seen += 1
        prog = programs.get(label)
        if prog is None or st["temp_bytes"] != prog.capture_bytes:
            failures.append(f"{what} {label}: temp_bytes {st['temp_bytes']} is not the "
                            f"capture's {getattr(prog, 'capture_bytes', None)}")
        if st["peak_hbm_bytes"] < st["argument_bytes"] + st["output_bytes"]:
            failures.append(f"{what} {label}: peak {st['peak_hbm_bytes']} below its "
                            f"arguments and outputs")
    peaks = [st["peak_hbm_bytes"] for st in progs.values() if "peak_hbm_bytes" in st]
    if peaks and ds.get("peak_hbm_bytes") != max(peaks):
        failures.append(f"{what}: rollup peak {ds.get('peak_hbm_bytes')} is not the "
                        f"largest program's {max(peaks)}")
    return seen


def entry_programs(engine, fingerprint: str) -> dict:
    """The stored programs, by label, of ``fingerprint``'s program-cache
    entry at the catalogs' current data versions (the key
    ``Engine._query_cache_entry`` uses)."""
    from trino_tpu_torch.exec.programs import Program

    versions = tuple((name, getattr(engine.catalogs.get(name), "_version", 0))
                     for name in sorted(engine.catalogs.names()))
    with engine._query_cache_lock:
        entry = engine._query_cache.get(
            (fingerprint, versions, engine.access_control.generation))
    programs = list((entry or {}).get("programs", {}).values())
    return {p.label: p for p in programs if isinstance(p, Program)}


def phase_obs(smi: str, runner) -> tuple[dict, int, int]:
    """Phase ``obs``: observability and the repeat tiers over ``runner``'s
    engine (phase tpch22's staged ``tpch.sf1`` tables). Kernel counts start
    at 0 here and are read at its end; every K1 launch is held against
    plain on the same tensors, every K2 build that is no replay too.

    a. the result cache (``result_cache=true``) on Q-A over the 2^25-row
       ``memory.default.bench_groupby``: a cold run (K1), a pure hit (no
       K1 launch, host rows), an INSERT of one more part of
       ``OBS_DELTA_ROWS`` rows and Q-A maintained from that part alone,
       equal to the grown table's oracle and to a ``result_cache=false``
       run, then a DELETE of that part and Q-A invalidated: K1 again, the
       first oracle;
    b. history: engine A, fresh on the same catalogs (the staged slabs
       shared), with ``history_dir`` in a temp dir, runs
       ``OBS_HISTORY_QUERIES`` cold; engine B, fresh again, repeats them:
       rows equal the committed answers, ``history_seeds`` >= 1, no
       overflow retry and no halving; both engines' cold ms and host reads
       on one line a query;
    c. the profiler: Q-A's and engine B's first query's ``deviceStats``
       against their captured programs (:func:`check_device_stats`),
       ``system.runtime.programs`` against the rollup, EXPLAIN ANALYZE's
       device section;
    d. over HTTP, on a server with ``flight_dir``: Q-A's timeline one
       connected tree under one ``query`` root with the engine's and the
       fragments' spans, ``/v1/metrics`` with the tier's counters, the
       flight journal replaying created → completed, and ``/v1/history``,
       ``/v1/cache``, ``/v1/slo`` answering 200.
    Returns the launches and the largest K1 and K2 differences."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch import types as T
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.client import ClientSession, Connection
    from trino_tpu_torch.columnar import batch_from_numpy
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.connectors.api import CatalogManager, ColumnSchema, TableSchema
    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.ops import dense_groupby as DG
    from trino_tpu_torch.server.http import TrinoTpuServer

    t_phase = time.perf_counter()
    eng = runner.engine
    failures: list = []
    sql_a, want_a = bench_groupby(eng.catalogs)["Q-A"]
    props = {**runner.session.properties, "stream_scan_threshold_rows": 1 << 20}
    k1_errs, builds = [], []
    real_dense = DG.dense_groupby_device

    def checked_dense(plan, bins, vals):
        lt = real_dense(plan, bins, vals)
        k1_errs.append(int((lt - DG.dense_groupby_plain(plan, bins, vals)).abs().max()))
        return lt

    def run(engine, sql, **extra):
        sess = Session(catalog="memory", schema="default",
                       properties={**props, **extra})
        before = _kernels.LAUNCHES["dense_groupby"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.execute_statement(sql, sess)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3, _kernels.LAUNCHES["dense_groupby"] - before

    root = tempfile.mkdtemp(prefix="tt_obs_")
    DG.dense_groupby_device = checked_dense
    try:
        _kernels.reset_counts()
        # a. the result cache
        hits0 = eng.result_cache.snapshot()["hits"]
        cold, cold_ms, cold_k1 = run(eng, sql_a, result_cache=True)
        # (c. the profiler, on the programs this cold run captured)
        fp_a, _ = eng.fingerprint(sql_a, Session(catalog="memory", schema="default",
                                                 properties=dict(props)))
        qa_progs = check_device_stats("Q-A", cold.device_stats, entry_programs(eng, fp_a),
                                      failures)
        hit, hit_ms, hit_k1 = run(eng, sql_a, result_cache=True)
        rc = hit.result_cache_stats or {}
        ok = (cold_k1 >= 1 and hit_k1 == 0 and rc.get("resultCacheHit") == 1
              and eng.result_cache.snapshot()["hits"] - hits0 == 1
              and sorted(cold.rows) == want_a == sorted(hit.rows))
        log("obs", card=smi, step="result_cache_hit", cold_ms=cold_ms, hit_ms=hit_ms,
            cold_k1=cold_k1, hit_k1=hit_k1, result_cache_stats=rc,
            hit_device_stats=hit.device_stats, all_ok=ok)
        if not ok:
            failures.append(f"result cache hit: K1 {cold_k1}/{hit_k1}, stats {rc}")
        # one more part: v >= 2^20 marks its rows, which the DELETE removes
        rng = np.random.default_rng(13)
        dk = rng.integers(0, KEYS, OBS_DELTA_ROWS)
        dv = (1 << VBITS) + rng.integers(0, 1 << VBITS, OBS_DELTA_ROWS)
        dw = rng.integers(-(1 << 40), 1 << 40, OBS_DELTA_ROWS)
        mem = eng.catalogs.get("memory")
        mem.create_table("default", "obs_delta", TableSchema("obs_delta", tuple(
            ColumnSchema(c, T.BIGINT) for c in ("k", "v", "w"))))
        mem.insert("default", "obs_delta", batch_from_numpy([T.BIGINT] * 3, [dk, dv, dw]))
        ins, ins_ms, _ = run(eng, "insert into memory.default.bench_groupby "
                                  "select k, v, w from memory.default.obs_delta")
        grown = {k: [s, c] for k, s, c in want_a}
        for k, v in zip(dk.tolist(), dv.tolist()):
            ent = grown.setdefault(k, [0, 0])
            ent[0] += v
            ent[1] += 1
        want_grown = sorted((k, s, c) for k, (s, c) in grown.items())
        maint, maint_ms, maint_k1 = run(eng, sql_a, result_cache=True)
        plain, plain_ms, _ = run(eng, sql_a, result_cache=False)
        rc = maint.result_cache_stats or {}
        ok = (rc.get("incrementalMaintenance") == 1 and ins.update_count == OBS_DELTA_ROWS
              and sorted(maint.rows) == want_grown == sorted(plain.rows))
        log("obs", card=smi, step="maintenance", insert_ms=ins_ms, maintained_ms=maint_ms,
            maintained_k1=maint_k1, uncached_ms=plain_ms, result_cache_stats=rc,
            maintained_ingest=maint.ingest_stats, all_ok=ok)
        if not ok:
            failures.append(f"maintenance: stats {rc}, rows equal "
                            f"{sorted(maint.rows) == want_grown}/{sorted(plain.rows) == want_grown}")
        dele, del_ms, _ = run(eng, "delete from memory.default.bench_groupby "
                                   f"where v >= {1 << VBITS}")
        inval, inval_ms, inval_k1 = run(eng, sql_a, result_cache=True)
        ok = (dele.update_count == OBS_DELTA_ROWS and inval.result_cache_stats is None
              and inval_k1 >= 1 and sorted(inval.rows) == want_a)
        log("obs", card=smi, step="invalidation", delete_ms=del_ms, ms=inval_ms,
            k1=inval_k1, cache=eng.result_cache.snapshot()["invalidations"], all_ok=ok)
        if not ok:
            failures.append(f"invalidation: K1 {inval_k1}, stats {inval.result_cache_stats}")

        # b. history on two fresh engines over the same catalogs
        texts = B.queries(f"tpch.{TPCH22_SCHEMA}")
        answers = B.load_answers()
        hist_props = {**runner.session.properties, "history_dir": os.path.join(root, "history")}
        per_engine, k2_stats = {}, {}
        for label in ("A", "B"):
            catalogs = CatalogManager()
            for name in eng.catalogs.names():
                if name != "system":
                    catalogs.register(name, eng.catalogs.get(name))
            fresh = Engine(catalogs=catalogs, device="cuda")
            for q in OBS_HISTORY_QUERIES:
                sess = Session(catalog="tpch", schema=TPCH22_SCHEMA, properties=dict(hist_props))
                k2_before = _kernels.LAUNCHES["dense_join_build"]
                with k2_checked(builds, [f"{label}:Q{q}"]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = fresh.execute_statement(texts[q], sess)
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                want = answers["queries"][str(q)]
                bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"], want["order_by"])
                ex = res.exchange_stats or {}
                per_engine[(label, q)] = {
                    "cold_ms": ms, "host_reads": ex.get("host_reads", 0),
                    "history_seeds": ex.get("history_seeds", 0),
                    "history_hits": ex.get("history_hits", 0),
                    "overflow_retries": ex.get("overflow_retries", 0),
                    "compile_halvings": ex.get("compile_halvings", 0),
                    "k2": _kernels.LAUNCHES["dense_join_build"] - k2_before,
                    "joinStrategy": ex.get("joinStrategy"), "matches_answers": bad is None,
                }
                if bad is not None:
                    failures.append(f"history engine {label} Q{q}: {bad}")
                if label == "B" and q == OBS_HISTORY_QUERIES[0]:
                    fp, _ = fresh.fingerprint(texts[q], sess)
                    k2_stats = {"ds": res.device_stats, "programs": entry_programs(fresh, fp),
                                "rows": [r for r in fresh.runtime_programs()
                                         if r["fingerprint"] == fp]}
            del fresh, catalogs
            gc.collect()
            torch.cuda.empty_cache()
        for q in OBS_HISTORY_QUERIES:
            a, b = per_engine[("A", q)], per_engine[("B", q)]
            log("obs", card=smi, step="history", query=f"Q{q}", engine_a=a, engine_b=b)
            if (b["history_seeds"] < 1 or b["overflow_retries"] or b["compile_halvings"]
                    or b["history_hits"] != 1 or not b["k2"]):
                failures.append(f"history Q{q}: engine B {b}")
        k2_err = max((max(r["max_abs_err"], r["unplaced_err"]) for r in builds), default=0)
        if builds and k2_err:
            failures.append(f"history: K2 builds differ from plain ({k2_err})")

        # c. the profiler
        k2_progs = check_device_stats(f"Q{OBS_HISTORY_QUERIES[0]}", k2_stats.get("ds"),
                                      k2_stats.get("programs", {}), failures)
        if not k2_progs:
            failures.append("profiler: the K2 query's programs carry no allocator stats")
        sys_peaks = {r["program"]: r["peak_hbm_bytes"] for r in k2_stats.get("rows", [])}
        ds_peaks = {label: st.get("peak_hbm_bytes") for label, st in
                    ((k2_stats.get("ds") or {}).get("programs") or {}).items()
                    if "temp_bytes" in st}
        if any(sys_peaks.get(label) != peak for label, peak in ds_peaks.items()):
            failures.append(f"system.runtime.programs {sys_peaks} against the rollup {ds_peaks}")
        explain = eng.execute_statement("explain analyze " + sql_a, Session(
            catalog="memory", schema="default", properties=dict(props)))
        text = "\n".join(r[0] for r in explain.rows)
        if "Device programs (CUDA caching allocator)" not in text:
            failures.append("EXPLAIN ANALYZE has no device section")
        log("obs", card=smi, step="profiler", qa_device_stats=cold.device_stats,
            qa_programs_with_stats=qa_progs, k2_device_stats=k2_stats.get("ds"),
            k2_programs_with_stats=k2_progs, system_programs_peaks=sys_peaks)

        # d. over HTTP
        server = TrinoTpuServer(engine=eng).start()
        base = server.base_uri
        try:
            flight_dir = os.path.join(root, "flight")
            conn = Connection(base, ClientSession(catalog="memory", schema="default",
                                                  properties={**props, "flight_dir": flight_dir}))
            rows, _ = conn.execute(sql_a)
            if sorted(rows) != want_a:
                failures.append("Q-A over HTTP: rows differ from the oracle")
            qid = next(q.query_id for q in server.query_manager.queries() if q.sql == sql_a)
            spans = http_json(f"{base}/v1/query/{qid}/timeline")["spans"]
            by_id = {s["spanId"]: s for s in spans}
            roots = [s for s in spans if s["parentId"] is None]

            def reaches_root(s):
                seen = set()
                while s["parentId"] is not None and s["spanId"] not in seen:
                    seen.add(s["spanId"])
                    s = by_id.get(s["parentId"], {"parentId": None, "spanId": None, "name": ""})
                return s.get("name") == "query"

            names = sorted({s["name"] for s in spans})
            connected = (len(roots) == 1 and roots[0]["name"] == "query"
                         and all(reaches_root(s) for s in spans)
                         and "execute" in names and any(k in names for k in OBS_SPAN_KINDS))
            metrics = http_json(f"{base}/v1/metrics?format=json")
            flat = set(metrics.get("counters", {})) | set(metrics.get("histograms", {})) \
                | set(metrics.get("gauges", {}))
            present = {c: any(k.split("{")[0] == c for k in flat) for c in OBS_COUNTERS}
            rare = {c: any(k.split("{")[0] == c for k in flat) for c in OBS_RARE_COUNTERS}
            deadline = time.monotonic() + 10
            events = []
            while time.monotonic() < deadline:
                events = [e["event"] for e in
                          http_json(f"{base}/v1/query/{qid}/flight")["events"]]
                if "completed" in events:
                    break
                time.sleep(0.05)
            statuses = {}
            for path in ("/v1/history", "/v1/cache", "/v1/slo"):
                try:
                    http_json(f"{base}{path}")
                    statuses[path] = 200
                except Exception as e:  # noqa: BLE001 — reported below
                    statuses[path] = getattr(e, "code", repr(e))
            log("obs", card=smi, step="http", spans=len(spans), span_names=names,
                connected=connected, counters=present, rare_counters=rare, flight=events,
                routes=statuses)
            if not connected:
                failures.append(f"timeline of Q-A not one connected tree: {names}")
            if not all(present.values()):
                failures.append(f"/v1/metrics lacks {[c for c, p in present.items() if not p]}")
            if not events or events[0] != "created" or events[-1] != "completed":
                failures.append(f"flight journal of Q-A: {events}")
            if any(v != 200 for v in statuses.values()):
                failures.append(f"routes: {statuses}")
        finally:
            server.stop()
        launches = dict(_kernels.LAUNCHES)
    finally:
        DG.dense_groupby_device = real_dense
        eng.catalogs.get("memory").drop_table("default", "bench_groupby")
        eng.catalogs.get("memory").drop_table("default", "obs_delta")
        shutil.rmtree(root, ignore_errors=True)
    k1_err = max(k1_errs, default=0)
    if k1_err or not k1_errs:
        failures.append(f"K1 against plain: {k1_errs}")
    log("obs", card=smi, launches=launches, k1_checked=len(k1_errs), k1_max_abs_err=k1_err,
        k2_checked=len(builds), k2_max_abs_err=k2_err,
        phase_s=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("phase obs: " + "; ".join(failures))
    return launches, k1_err, k2_err


SURFACE_LI1_COLUMNS = ("l_orderkey, l_partkey, l_suppkey, l_linenumber, l_quantity,"
                       " l_extendedprice, l_discount, l_tax, l_returnflag,"
                       " l_linestatus, l_shipdate")
SURFACE_LATE = "l_shipdate >= date '1998-01-01'"
SURFACE_JOIN = ("from tpch.sf1.lineitem join tpch.sf1.orders"
                " on l_orderkey = o_orderkey")
# the grouping of step 6 and its grouping sets, each answered by a plain
# GROUP BY for the oracle
SURFACE_GROUPINGS = {
    "rollup": ("rollup(o_orderpriority, l_returnflag)",
               [("o_orderpriority", "l_returnflag"), ("o_orderpriority",), ()]),
    "grouping_sets": ("grouping sets ((o_orderpriority, l_returnflag),"
                      " (l_returnflag), ())",
                      [("o_orderpriority", "l_returnflag"), ("l_returnflag",), ()]),
    "cube": ("cube(o_orderpriority, l_returnflag)",
             [("o_orderpriority", "l_returnflag"), ("o_orderpriority",),
              ("l_returnflag",), ()]),
}


@contextlib.contextmanager
def host_time_in(owner, attr: str):
    """Host-clock ms of each call to ``owner.attr`` while the block runs
    (a list, filled as the calls return)."""
    real, spent = getattr(owner, attr), []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            spent.append((time.perf_counter() - t0) * 1e3)

    setattr(owner, attr, timed)
    try:
        yield spent
    finally:
        setattr(owner, attr, real)


def surface_step(runner, step: str, sql: str, smi: str, warm: int = 1,
                 rows_in: int | None = None, **extra):
    """One statement of phase ``surface``, cold and then ``warm`` times
    (host clock ending in ``torch.cuda.synchronize()``), with its peak
    device memory and K1/K2 launches per run, and rows/s over ``rows_in``
    input rows; a line a step. Returns the last run's result."""
    import torch

    from trino_tpu_torch import _kernels

    times, k1, k2, peaks, rows, cache = [], [], [], [], [], []
    for _ in range(1 + warm):
        before = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        reset_peak()
        t0 = time.perf_counter()
        res = runner.engine.execute_statement(sql, runner.session)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        peaks.append(read_peak())
        k1.append(_kernels.LAUNCHES["dense_groupby"] - before["dense_groupby"])
        k2.append(_kernels.LAUNCHES["dense_join_build"] - before["dense_join_build"])
        rows.append(res.rows)
        ing = res.ingest_stats or {}
        cache.append([ing.get("table_cache_hits", 0), ing.get("table_cache_misses", 0)])
    fields = dict(
        card=smi, step=step, rows=len(res.rows), update_count=res.update_count,
        cold_ms=times[0], warm_ms=times[1:], k1_launches_per_run=k1,
        k2_launches_per_run=k2, peak_device_bytes_per_run=peaks,
        table_cache_hits_misses_per_run=cache,
        fragment_modes=res.fragment_modes,
        overflow_retries=(res.exchange_stats or {}).get("overflow_retries"), **extra,
    )
    if rows_in is not None:
        fields["rows_per_s_cold"] = rows_in / (times[0] / 1e3)
        if warm:
            fields["rows_per_s_warm"] = rows_in / (min(times[1:]) / 1e3)
    log("surface", **fields)
    res.k1 = sum(k1)
    res.k2 = sum(k2)
    res.runs_rows = rows  # every run's rows: warm repeats are checked too
    return res


def surface_host_columns(runner, table: str, cols: list) -> list:
    """Host copies of columns of ``tpch.sf1`` ``table`` as the tpch
    connector staged them: (numpy values of the live rows, dictionary)
    a column."""
    from trino_tpu_torch.exec.streaming import slab_stage_rows

    slab, n = runner.catalogs.get("tpch").device_slab(
        "sf1", table, cols, slab_stage_rows(runner.session),
        int(runner.session.get("stream_device_cache_bytes")), device="cuda",
    )
    return [(c.data[:n].cpu().numpy(), c.dictionary) for c in slab.columns]


def surface_linenumber_oracle(runner) -> list:
    """``l_linenumber, sum(l_quantity), count(*)`` over ``tpch.sf1.lineitem``
    in numpy over the host copies of the staged columns (exact: the
    quantities' unscaled integers summed in int64)."""
    (line, _), (qty, _) = surface_host_columns(
        runner, "lineitem", ["l_linenumber", "l_quantity"])
    keys, at = np.unique(line, return_inverse=True)
    sums = np.zeros(len(keys), dtype=np.int64)
    np.add.at(sums, at, qty.astype(np.int64))
    counts = np.bincount(at, minlength=len(keys))
    return [(int(k), Decimal(int(s)).scaleb(-2), int(c))
            for k, s, c in zip(keys, sums, counts)]


def surface_clerk_oracle(runner, sets) -> dict:
    """max(o_clerk) of each group of each grouping set over lineitem ⋈
    orders, in numpy over the host copies of the staged columns: key
    (priority or None, flag or None) -> clerk."""
    (okey, _), (prio, pdict), (clerk, cdict) = surface_host_columns(
        runner, "orders", ["o_orderkey", "o_orderpriority", "o_clerk"])
    (lkey, _), (flag, fdict) = surface_host_columns(
        runner, "lineitem", ["l_orderkey", "l_returnflag"])
    order = np.argsort(okey)
    at = order[np.searchsorted(okey[order], lkey)]
    assert (okey[at] == lkey).all()
    ranks = np.asarray(cdict.ranks())[clerk[at]]
    by_rank = np.argsort(np.asarray(cdict.ranks()))
    p, f = prio[at].astype(np.int64), flag.astype(np.int64)
    out = {}
    for keys in sets:
        use_p, use_f = "o_orderpriority" in keys, "l_returnflag" in keys
        gid = np.broadcast_to((p if use_p else 0) * 64 + (f if use_f else 0),
                              ranks.shape)
        best = np.full(64 * 64, -1, dtype=np.int64)
        np.maximum.at(best, gid, ranks)
        for g in np.flatnonzero(best >= 0):
            key = (pdict.values[g // 64] if use_p else None,
                   fdict.values[g % 64] if use_f else None)
            out[key] = cdict.values[by_rank[best[g]]]
    return out


def phase_surface(smi: str, runner) -> dict:
    """The statement surface at TPC-H SF1 on the card, through ``runner``
    (its tpch connector holds the staged ``tpch.sf1`` tables): SHOW;
    CREATE TABLE AS of lineitem into ``memory.default.li1`` with TPC-H Q1
    and Q6 over it against the committed SF1 answers; K1 over the table
    made by SQL; INSERT, DELETE and transactions (ROLLBACK of an INSERT
    and of a DROP, a committed INSERT), each checked against the source;
    PREPARE/EXECUTE of Q6; ROLLUP, GROUPING SETS and CUBE over lineitem ⋈
    orders with a FILTER count and ``max(o_clerk)`` (K2 held against its
    plain version) against plain GROUP BYs and a numpy oracle; UNNEST and
    ``array_agg`` over orders; EXPLAIN and EXPLAIN ANALYZE of Q3. Every
    failed check raises. Returns the kernel launches of the phase and the
    largest K1 and K2 differences from their plain versions."""
    from trino_tpu_torch import _kernels
    from trino_tpu_torch.benchmarks import tpch as B

    answers = B.load_answers()
    texts = B.queries("tpch.sf1")

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"surface: {what}")

    def rows_of(sql):
        return runner.engine.execute_statement(sql, runner.session).rows

    def against(q: int, res, what: str) -> None:
        want = answers["queries"][str(q)]
        bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"], want["order_by"])
        check(bad is None, f"{what} differs from Q{q}'s answer: {bad}")

    runner.engine.execute_statement("drop table if exists memory.default.li1",
                                    runner.session)
    t_phase = time.perf_counter()
    # the main path's run: every count starts at 0 here and is read after;
    # the K2 launches made to hold builds against plain are taken out
    pool_before = pool_counts(runner.engine)
    _kernels.reset_counts()
    compare = {k: 0 for k in _kernels.LAUNCHES}
    # 1. SHOW
    res = surface_step(runner, "show_catalogs", "show catalogs", smi)
    check(res.rows == [("blackhole",), ("memory",), ("system",), ("tpcds",), ("tpch",)],
          f"catalogs {res.rows}")
    res = surface_step(runner, "show_schemas", "show schemas from tpch", smi)
    check([r[0] for r in res.rows] == ["tiny", "sf1", "sf10", "sf100"], f"schemas {res.rows}")
    res = surface_step(runner, "show_tables", "show tables from tpch.sf1", smi)
    check([r[0] for r in res.rows] == ["customer", "lineitem", "nation", "orders",
                                       "part", "partsupp", "region", "supplier"],
          f"tables {res.rows}")
    res = surface_step(runner, "show_columns", "show columns from tpch.sf1.lineitem", smi)
    check(len(res.rows) == 16 and res.rows[0][:2] == ("l_orderkey", "bigint")
          and res.rows[4][:2] == ("l_quantity", "decimal(12,2)"), f"columns {res.rows}")
    # 2. CREATE TABLE AS (cold, then dropped and made again: warm)
    ctas = f"create table memory.default.li1 as select {SURFACE_LI1_COLUMNS} from tpch.sf1.lineitem"
    for run in ("cold", "warm"):
        if run == "warm":
            runner.engine.execute_statement("drop table memory.default.li1", runner.session)
        res = surface_step(runner, f"ctas_{run}", ctas, smi, warm=0, rows_in=6001215)
        check(res.update_count == 6001215, f"CTAS wrote {res.update_count} rows")
    for q in (1, 6):
        res = surface_step(runner, f"q{q}_over_li1",
                           texts[q].replace("tpch.sf1.lineitem", "memory.default.li1"), smi)
        against(q, res, f"Q{q} over memory.default.li1")
    # 3. K1 over the table made by SQL: each launch held against the plain
    # version on the same tensors, the rows against numpy sums over the
    # staged source columns
    from trino_tpu_torch.ops import dense_groupby as DG

    real_dense, k1_errs = DG.dense_groupby_device, []

    def checked_dense(plan, bins, vals):
        lt = real_dense(plan, bins, vals)
        k1_errs.append(int((lt - DG.dense_groupby_plain(plan, bins, vals)).abs().max()))
        return lt

    DG.dense_groupby_device = checked_dense
    try:
        res = surface_step(runner, "k1_over_li1", "select l_linenumber, sum(l_quantity),"
                           " count(*) from memory.default.li1 group by l_linenumber", smi)
    finally:
        DG.dense_groupby_device = real_dense
    k1_err = max(k1_errs, default=0)
    log("surface", card=smi, step="k1_vs_plain", launches=len(k1_errs), k1_max_abs_err=k1_err)
    check(res.k1 >= 1, "the GROUP BY over memory.default.li1 launched no K1")
    check(len(k1_errs) == res.k1 and not k1_err, f"K1 differs from plain: {k1_errs}")
    want = surface_linenumber_oracle(runner)
    for rows in res.runs_rows:
        check(sorted(rows) == want, f"the GROUP BY over li1: {sorted(rows)} != {want}")
    # 4. writes and transactions, each checked against the source
    count_sql = "select count(*), sum(l_quantity) from memory.default.li1"
    (base,) = rows_of("select count(*), sum(l_quantity) from tpch.sf1.lineitem")
    (late,) = rows_of(f"select count(*), sum(l_quantity) from tpch.sf1.lineitem where {SURFACE_LATE}")
    insert = (f"insert into memory.default.li1 select {SURFACE_LI1_COLUMNS}"
              f" from tpch.sf1.lineitem where {SURFACE_LATE}")

    def expect(step, n, total):
        # the cold run right after a write and its warm repeat: neither may
        # read a stale table-cache entry or device slab
        res = surface_step(runner, step, count_sql, smi)
        for rows in res.runs_rows:
            check(rows == [(n, total)], f"{step}: {rows} != {[(n, total)]}")

    expect("count_base", base[0], base[1])
    res = surface_step(runner, "insert", insert, smi, warm=0)
    check(res.update_count == late[0], f"INSERT wrote {res.update_count}")
    expect("count_after_insert", base[0] + late[0], base[1] + late[1])
    res = surface_step(runner, "delete", f"delete from memory.default.li1 where {SURFACE_LATE}",
                       smi, warm=0)
    check(res.update_count == 2 * late[0], f"DELETE removed {res.update_count}")
    expect("count_after_delete", base[0] - late[0], base[1] - late[1])
    for stmt in ("start transaction", insert, "rollback"):
        surface_step(runner, "txn_insert_rollback", stmt, smi, warm=0)
    expect("count_after_rollback", base[0] - late[0], base[1] - late[1])
    for stmt in ("start transaction", "drop table memory.default.li1"):
        surface_step(runner, "txn_drop_rollback", stmt, smi, warm=0)
    check(runner.catalogs.get("memory").get_table("default", "li1") is None,
          "DROP in the transaction left the table")
    surface_step(runner, "txn_drop_rollback", "rollback", smi, warm=0)
    expect("count_after_drop_rollback", base[0] - late[0], base[1] - late[1])
    for stmt in ("start transaction", insert, "commit"):
        surface_step(runner, "txn_insert_commit", stmt, smi, warm=0)
    expect("count_after_commit", base[0], base[1])
    # 5. PREPARE / EXECUTE of Q6 with its five literals as parameters
    surface_step(runner, "prepare", (
        "prepare q6 from select sum(l_extendedprice * l_discount) as revenue"
        " from tpch.sf1.lineitem where l_shipdate >= ?"
        " and l_shipdate < ? + interval '1' year"
        " and l_discount between ? and ? and l_quantity < ?"), smi, warm=0)
    res = surface_step(runner, "execute", "execute q6 using date '1994-01-01',"
                       " date '1994-01-01', 0.05, 0.07, 24", smi)
    against(6, res, "EXECUTE q6")
    surface_step(runner, "deallocate", "deallocate prepare q6", smi, warm=0)
    check("q6" not in runner.session.prepared, "DEALLOCATE kept q6")
    # 6. grouping sets with a FILTER count and a VARCHAR max over a join
    from trino_tpu_torch.ops import dense_join as DJ

    aggs = ("count(*), sum(l_quantity), count(*) filter (where l_discount > 0.05),"
            " max(o_clerk)")
    builds_before, k2_err = 0, 0
    for name, (grouping, sets) in SURFACE_GROUPINGS.items():
        sql = f"select o_orderpriority, l_returnflag, {aggs} {SURFACE_JOIN} group by {grouping}"
        res = surface_step(runner, f"{name}_join", sql, smi, rows_in=6001215)
        check(res.k2 >= 1, f"{name}: the join launched no K2")
        want = {}
        for keys in sets:
            cols = ", ".join(keys)
            plain = (f"select {cols + ', ' if cols else ''}count(*), sum(l_quantity),"
                     f" sum(case when l_discount > 0.05 then 1 else 0 end) {SURFACE_JOIN}"
                     + (f" group by {cols}" if cols else ""))
            for row in rows_of(plain):
                vals = dict(zip(keys, row))
                key = (vals.get("o_orderpriority"), vals.get("l_returnflag"))
                want[key] = tuple(row[len(keys):])
        clerks = surface_clerk_oracle(runner, sets)
        got = {(r[0], r[1]): tuple(r[2:5]) for r in res.rows}
        check(len(res.rows) == len(want) and got == want,
              f"{name}: counts and sums differ from the plain GROUP BYs")
        check({(r[0], r[1]): r[5] for r in res.rows} == clerks,
              f"{name}: max(o_clerk) differs from the numpy oracle")
        before = dict(_kernels.LAUNCHES)
        builds = k2_against_plain(runner, {name: sql})
        for k in compare:
            compare[k] += _kernels.LAUNCHES[k] - before[k]
        err = max(max(b["max_abs_err"], b["unplaced_err"]) for b in builds)
        log("surface", card=smi, step=f"{name}_k2_vs_plain", builds=len(builds),
            k2_max_abs_err=err)
        check(builds and not err, f"{name}: a K2 build differs from plain")
        builds_before += len(builds)
        k2_err = max(k2_err, err)
    # 7. UNNEST and ARRAY at scale; the host time its runs spend in the
    # tpch connector's split reads (generation) is its own line
    from trino_tpu_torch.connectors.tpch import TpchConnector

    (total,) = rows_of("select sum(o_totalprice) from tpch.sf1.orders")
    with host_time_in(TpchConnector, "read_split") as read_ms:
        res = surface_step(
            runner, "unnest",
            "select x, count(*), sum(o_totalprice) from tpch.sf1.orders"
            " cross join unnest(array[1, 2, 3]) t(x) group by x", smi, rows_in=4500000,
        )
    log("surface", card=smi, step="unnest_read_split", calls=len(read_ms),
        ms=sum(read_ms))
    check(sorted(res.rows) == [(x, 1500000, total[0]) for x in (1, 2, 3)],
          f"UNNEST rows {res.rows}")
    res = surface_step(runner, "array_agg",
                       "select o_orderstatus, cardinality(array_agg(o_orderkey))"
                       " from tpch.sf1.orders group by 1", smi, rows_in=1500000)
    check(sorted(res.rows) == sorted(rows_of(
        "select o_orderstatus, count(*) from tpch.sf1.orders group by 1")),
          f"array_agg cardinalities {res.rows}")
    # 8. EXPLAIN and EXPLAIN ANALYZE of Q3
    res = surface_step(runner, "explain", f"explain {texts[3]}", smi)
    log("surface", card=smi, step="explain_text", plan=[r[0] for r in res.rows])
    res = surface_step(runner, "explain_analyze", f"explain analyze {texts[3]}", smi)
    lines = [r[0] for r in res.rows]
    log("surface", card=smi, step="explain_analyze_text", plan=lines)
    n_q3 = len(answers["queries"]["3"]["rows"])
    check(f"output rows: {n_q3}" in lines, f"EXPLAIN ANALYZE does not count {n_q3} rows")
    launches = {k: _kernels.LAUNCHES[k] - compare[k] for k in compare}
    log("surface", card=smi, launches=launches, k2_builds_checked=builds_before,
        seconds=time.perf_counter() - t_phase, **pool_counts(runner.engine, pool_before))
    check(launches["dense_groupby"] >= 1 and launches["dense_join_build"] >= 1,
          f"launches {launches}")
    runner.engine.execute_statement("drop table memory.default.li1", runner.session)
    return launches, k1_err, k2_err


FILES_SCHEMA = "sf1"      # the files phase's TPC-H scale factor
FILES_WARM = 2
FILES_TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
                "orders", "lineitem")
FILES_SIDE_TABLES = ("lineitem", "orders", "customer")  # into orc and ttp
FILES_SIDE_QUERIES = (1, 3, 6)
# the ORC and pages-file catalogs' scale: cut from sf1 for the script's
# time (their SF1 writes and cold queries took 95-130 s)
FILES_SIDE_SCHEMA = "tiny"
# materialized scans keep the table cache in play (bench.py:350): a warm
# run copies nothing
FILES_STREAM_THRESHOLD = 1 << 26
QE_INSERTS = 8           # Q-E's table: 8 inserts of ROWS / 8 rows, 8 row groups
SYNTH_ROWS = 10 ** 9     # BASELINE.json config 4
SYNTH_K_MUL = 2654435761
SYNTH_V_MUL, SYNTH_V_ADD, SYNTH_V_MOD = 1103515245, 12345, 1 << 20
QE_SQL = "select k, sum(v), count(*) from pq.default.bench_groupby group by k"
SYNTH_SQL = "select k, sum(v), count(*) from synthetic.default.events group by k"
INGEST_KEYS = ("decode_ms", "splits_decoded", "splits_decoded_numpy", "h2d_bytes",
               "h2d_transfers", "h2d_ms", "coalesced_columns", "device_chunks",
               "table_cache_hits", "table_cache_misses")
SQL_RATE: dict = {}      # phase sql's Q-A rows/s, for Q-E's ratio


def ingest_fields(res) -> dict:
    """The ingest stats of one run (``StatementResult.ingest_stats``)."""
    ing = res.ingest_stats or {}
    return {k: ing.get(k, 0) for k in INGEST_KEYS}


def synth_gen(xp, idx):
    """The synthetic events generator (tests/test_synthetic.py)."""
    return {"k": (idx * SYNTH_K_MUL) % KEYS,
            "v": (idx * SYNTH_V_MUL + SYNTH_V_ADD) % SYNTH_V_MOD}


def synth_oracle(rows: int) -> list:
    """Exact (k, sum(v), count) of the generator over ``rows`` rows with no
    pass over them: k depends on idx mod 4096 and v on idx mod 2^20, so one
    2^20-row period is summed, scaled by the whole periods, and the
    remainder's rows are added."""
    period = SYNTH_V_MOD
    idx = np.arange(period, dtype=np.int64)
    g = synth_gen(np, idx)
    full, rem = divmod(rows, period)
    vs = np.zeros(KEYS, dtype=np.int64)
    np.add.at(vs, g["k"], g["v"])
    cs = np.bincount(g["k"], minlength=KEYS).astype(np.int64)
    sums = full * vs
    counts = full * cs
    np.add.at(sums, g["k"][:rem], g["v"][:rem])
    counts += np.bincount(g["k"][:rem], minlength=KEYS)
    return sorted((k, int(sums[k]), int(counts[k])) for k in range(KEYS) if counts[k])


def phase_files(smi: str, runner, schema: str = FILES_SCHEMA, answers=None,
                side_schema: str = FILES_SIDE_SCHEMA, side_answers=None,
                qe_rows: int = ROWS, synth_rows: int = SYNTH_ROWS) -> tuple[dict, int]:
    """The ingest tier and the file formats at TPC-H ``schema`` on the card,
    on the engine of ``runner`` (its tpch connector holds the staged
    tables): the eight tables written to Parquet by SQL, three tables of
    ``side_schema`` to ORC and pages files; the 22 queries over Parquet
    (cold, then warm with no host-to-device byte), Q1/Q3/Q6 over ORC and
    pages files, each held against the committed answers of its scale, K2 launching with every build equal to
    plain; Q-E over 8 Parquet row groups under the four ingest settings;
    BASELINE config 4's 10^9-row synthetic GROUP BY from chunks made on
    the card; DELETE on a pages-file table through ``replace_data``. Every
    failed check raises. Returns the kernel launches of the phase and the
    largest K2 difference from plain."""
    import os
    import shutil
    import tempfile

    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch import types as T
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.columnar import batch_from_numpy
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.connectors.api import (
        ColumnSchema,
        TableSchema,
        register_catalog_spec,
    )
    from trino_tpu_torch.connectors.synthetic import SyntheticConnector

    answers = answers or B.load_answers()
    if side_answers is None:
        side_answers = answers if side_schema == schema else B.load_answers(
            os.path.join(os.path.dirname(B.ANSWERS_SF1), f"tpch_{side_schema}_answers.json"))
    engine = runner.engine
    token = "__files__"
    texts = {q: t.replace(f"{token}.", "") for q, t in B.queries(token).items()}

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"files: {what}")

    def session(catalog: str, sch: str, **props) -> Session:
        s = Session(catalog=catalog, schema=sch)
        s.set("execution_mode", "distributed")
        s.set("join_strategy", "auto")
        for k, v in props.items():
            s.set(k, v)
        return s

    def timed(sql: str, sess: Session):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.execute_statement(sql, sess)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def against(q: int, res, catalog: str) -> Optional[str]:
        want = (answers if catalog == "pq" else side_answers)["queries"][str(q)]
        bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"], want["order_by"])
        types = [t.name for t in res.column_types]
        if bad is None and types != want["types"]:
            bad = f"column types {types} != {want['types']}"
        return bad

    root = tempfile.mkdtemp(prefix="tt_files_")
    t_phase = time.perf_counter()
    try:
        dirs = {c: os.path.join(root, c) for c in ("pq", "orc", "ttp")}
        for name, kind in (("pq", "parquet"), ("orc", "orc"), ("ttp", "file")):
            register_catalog_spec(engine.catalogs, f"{name}={kind}:{dirs[name]}")
        src = session("tpch", schema)

        def disk_bytes(catalog: str, sch: str, table: str) -> int:
            d = os.path.join(dirs[catalog], sch, table)
            return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))

        # 1. writes: CTAS of every column, cold
        for catalog, tables in (("pq", FILES_TABLES), ("orc", FILES_SIDE_TABLES),
                                ("ttp", FILES_SIDE_TABLES)):
            sch = schema if catalog == "pq" else side_schema
            for table in tables:
                want = engine.execute_statement(
                    f"select count(*) from tpch.{sch}.{table}", src).rows[0][0]
                tpch = engine.catalogs.get("tpch")
                staged_before = tpch.staged_splits
                disk_before = tpch.disk_cache_stats()
                reset_peak()
                # where a write's time goes: the tpch connector's split
                # reads (generation, or its host cache) and the target
                # connector's insert (encode and write the file)
                with host_time_in(type(engine.catalogs.get("tpch")), "read_split") as gen_ms, \
                        host_time_in(type(engine.catalogs.get(catalog)), "insert") as put_ms:
                    res, ms = timed(f"create table {catalog}.{sch}.{table} as "
                                    f"select * from tpch.{sch}.{table}", src)
                check(res.update_count == want,
                      f"{catalog}.{table} wrote {res.update_count} rows, not {want}")
                log("files", card=smi, step="write", table=f"{catalog}.{sch}.{table}",
                    rows=want, seconds=ms / 1e3,
                    bytes_on_disk=disk_bytes(catalog, sch, table),
                    rows_per_s=want / (ms / 1e3), tpch_read_split_ms=sum(gen_ms),
                    insert_ms=sum(put_ms),
                    splits_from_staged_columns=tpch.staged_splits - staged_before,
                    disk_cache_before=disk_before, disk_cache=tpch.disk_cache_stats(),
                    peak_device_bytes=read_peak())

        # 2. the 22 queries over Parquet, 3. Q1/Q3/Q6 over ORC and pages
        # files: the main path's run, every count 0 here and read after
        runs = [("pq", q) for q in range(1, 23)]
        runs += [(c, q) for c in ("orc", "ttp") for q in FILES_SIDE_QUERIES]
        sessions = {c: session(c, schema if c == "pq" else side_schema,
                               stream_scan_threshold_rows=FILES_STREAM_THRESHOLD)
                    for c in ("pq", "orc", "ttp")}
        pool_before = pool_counts(engine)
        _kernels.reset_counts()
        failures, k2_runs, warm_medians, max_peak = [], {}, [], 0
        builds, cold_launches = [], {}
        for catalog, q in runs:
            times, k2, ingest, peaks = [], [], [], []
            for run in range(1 + FILES_WARM):
                before = _kernels.LAUNCHES["dense_join_build"]
                reset_peak()
                # a cold run's K2 builds are held against plain as they run
                with (k2_checked(builds, [f"{catalog}:Q{q}"]) if run == 0
                      else contextlib.nullcontext()):
                    res, ms = timed(texts[q], sessions[catalog])
                times.append(ms)
                peaks.append(read_peak())
                k2.append(_kernels.LAUNCHES["dense_join_build"] - before)
                ingest.append(ingest_fields(res))
                bad = against(q, res, catalog)
                if bad is not None:
                    failures.append(f"{catalog} Q{q}: {bad}")
                    break
            k2_runs[(catalog, q)] = k2[-1]
            cold_launches[f"{catalog}:Q{q}"] = k2[0]
            if len(times) > 1:
                warm_medians.append(statistics.median(times[1:]))
            max_peak = max([max_peak] + peaks)
            warm_h2d = [i["h2d_bytes"] for i in ingest[1:]]
            if any(warm_h2d):
                failures.append(f"{catalog} Q{q}: warm runs copied {warm_h2d} bytes")
            log("files", card=smi, step="query", catalog=catalog, query=f"Q{q}",
                rows=len(res.rows), matches_reference=bad is None,
                cold_ms=times[0], warm_ms=times[1:],
                warm_median_ms=statistics.median(times[1:]) if len(times) > 1 else None,
                k2_launches_per_run=k2, ingest_per_run=ingest,
                peak_device_bytes_per_run=peaks,
                joinStrategy=(res.exchange_stats or {}).get("joinStrategy"))
        launches = dict(_kernels.LAUNCHES)
        log("files", card=smi, launches=launches, warm_total_ms=sum(warm_medians),
            max_peak_device_bytes=max_peak, **pool_counts(engine, pool_before))
        if failures:
            raise AssertionError("files: " + "; ".join(failures))
        check(launches["dense_join_build"] > 0, "no K2 launch over the file catalogs")
        # every K2 build of the cold runs against its plain version, at the
        # shapes this path gave it
        k2_err = check_cold_builds("files", smi, builds, cold_launches)
        check(("orc", 3) in k2_runs and k2_runs[("orc", 3)] > 0
              and k2_runs[("ttp", 3)] > 0, "Q3 over orc/ttp launched no K2")

        # 4. Q-E: the headline GROUP BY over 8 Parquet row groups
        rng = np.random.default_rng(7)
        k = rng.integers(0, KEYS, qe_rows).astype(np.int64)
        v = rng.integers(0, 1 << VBITS, qe_rows).astype(np.int64)
        pq = engine.catalogs.get("pq")
        pq.create_table("default", "bench_groupby", TableSchema(
            "bench_groupby", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))))
        t0 = time.perf_counter()
        step = qe_rows // QE_INSERTS
        for i in range(QE_INSERTS):
            pq.insert("default", "bench_groupby", batch_from_numpy(
                [T.BIGINT, T.BIGINT], [k[i * step:(i + 1) * step], v[i * step:(i + 1) * step]]))
        write_s = time.perf_counter() - t0
        counts = np.bincount(k, minlength=KEYS)
        vsum = np.zeros(KEYS, dtype=np.int64)
        np.add.at(vsum, k, v)
        want_e = sorted((int(i), int(vsum[i]), int(counts[i]))
                        for i in range(KEYS) if counts[i])
        qe = session("pq", "default", stream_scan_threshold_rows=FILES_STREAM_THRESHOLD)
        times, ingest = [], []
        reset_peak()
        for _ in range(1 + WARM):
            res, ms = timed(QE_SQL, qe)
            times.append(ms)
            ingest.append(ingest_fields(res))
            check(sorted(res.rows) == want_e, "Q-E rows differ from the numpy sums")
        check(ingest[0]["splits_decoded"] == QE_INSERTS, f"Q-E read {ingest[0]} splits")
        check(not any(i["h2d_bytes"] for i in ingest[1:]), "Q-E warm runs copied bytes")
        warm = statistics.median(times[1:])
        qa = SQL_RATE.get("Q-A")
        log("files", card=smi, step="Q-E", rows=qe_rows, row_groups=QE_INSERTS,
            write_s=write_s, bytes_on_disk=disk_bytes("pq", "default", "bench_groupby"),
            cold_ms=times[0], warm_ms=times[1:], warm_median_ms=warm,
            cold_rows_per_s=qe_rows / (times[0] / 1e3), warm_rows_per_s=qe_rows / (warm / 1e3),
            ratio_to_qa_warm=None if qa is None else (qe_rows / (warm / 1e3)) / qa,
            ingest_per_run=ingest, peak_device_bytes=read_peak())
        settings = {}
        for prefetch in (True, False):
            for coalesced in (True, False):
                s = session("pq", "default", stream_scan_threshold_rows=FILES_STREAM_THRESHOLD,
                            table_cache=False, ingest_prefetch=prefetch,
                            coalesced_h2d=coalesced)
                reset_peak()
                res, ms = timed(QE_SQL, s)
                check(sorted(res.rows) == want_e,
                      f"Q-E rows differ (prefetch={prefetch}, coalesced={coalesced})")
                settings[f"prefetch={prefetch},coalesced={coalesced}"] = {
                    "cold_ms": ms, **ingest_fields(res),
                    "peak_device_bytes": read_peak()}
        log("files", card=smi, step="Q-E_settings", settings=settings)
        on_card = engine.device.type == "cuda"  # a CPU rehearsal copies nothing
        check(all(v["h2d_transfers"] == on_card for n, v in settings.items()
                  if "coalesced=True" in n), "a coalesced cold scan took more than one copy")

        # 5. BASELINE config 4: rows generated on the card
        synth = SyntheticConnector()
        synth.add_table("default", "events", TableSchema(
            "events", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))),
            synth_rows, synth_gen)
        engine.catalogs.register("synthetic", synth)
        t0 = time.perf_counter()
        want_s = synth_oracle(synth_rows)
        oracle_s = time.perf_counter() - t0
        ss = session("synthetic", "default")
        times, ingest = [], []
        reset_peak()
        for _ in range(2):
            res, ms = timed(SYNTH_SQL, ss)
            times.append(ms)
            ingest.append(ingest_fields(res))
            check(sorted(res.rows) == want_s, "synthetic rows differ from the closed form")
            check(ingest[-1]["h2d_bytes"] == 0 and ingest[-1]["device_chunks"] > 0,
                  f"synthetic chunks were not made on the card: {ingest[-1]}")
        log("files", card=smi, step="synthetic", rows=synth_rows, oracle_s=oracle_s,
            cold_s=times[0] / 1e3, warm_s=times[1] / 1e3,
            warm_rows_per_s=synth_rows / (times[1] / 1e3),
            chunks=ingest[-1]["device_chunks"], h2d_bytes=ingest[-1]["h2d_bytes"],
            fragment_modes={str(f): m for f, m in (res.fragment_modes or {}).items()},
            peak_device_bytes=read_peak())

        # 6. DELETE on a durable table swaps its data through replace_data
        ttp = engine.catalogs.get("ttp")
        calls = []
        for name in ("replace_data", "truncate", "insert"):
            real = getattr(ttp, name)
            setattr(ttp, name, (lambda real, name: lambda *a, **kw: (
                calls.append(name), real(*a, **kw))[1])(real, name))
        cut = "o_orderdate < date '1993-01-01'"
        kept = engine.execute_statement(
            f"select count(*) from tpch.{side_schema}.orders where not ({cut})", src).rows[0][0]
        before = engine.execute_statement(
            f"select count(*) from ttp.{side_schema}.orders", src).rows[0][0]
        reset_peak()
        res, ms = timed(f"delete from ttp.{side_schema}.orders where {cut}", src)
        after, ms_count = timed(f"select count(*) from ttp.{side_schema}.orders", src)
        for name in ("replace_data", "truncate", "insert"):
            delattr(ttp, name)
        check(calls == ["replace_data"], f"DELETE called {calls}")
        check(after.rows[0][0] == kept and res.update_count == before - kept,
              f"DELETE kept {after.rows[0][0]} rows, not {kept}")
        log("files", card=smi, step="delete", table=f"ttp.{side_schema}.orders",
            deleted=res.update_count, kept=kept, ms=ms, count_ms=ms_count,
            connector_calls=calls, peak_device_bytes=read_peak())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("files", card=smi, phase_s=time.perf_counter() - t_phase)
    return launches, k2_err


def run_against_answers(runner, texts: dict, answers: dict, warm: int,
                        phase: str, smi: str, streamed=(), replayed=(),
                        builds: Optional[list] = None, cold_launches: Optional[dict] = None,
                        tag: str = ""):
    """Each query of ``texts`` once cold and ``warm`` times warm, its rows
    and column types held against ``answers`` (one line a query: times,
    kernel launches, overflow retries and table-cache hits and misses
    per run, join strategies, fragment modes, peak device memory of each
    run and of the query, the streamed join fragments). A query of
    ``streamed`` that streams no join fragment is a failure, and so is a
    warm run of a query of ``replayed`` that captures a program or runs
    one without its graph. With ``builds`` given, every K2 build of a cold
    run is held against its plain version as it runs (:func:`k2_checked`,
    its query named ``Q<n><tag>``; the cold times include that), and the
    cold run's K2 launches go into ``cold_launches``
    (:func:`check_cold_builds`). Returns warm medians, K2 launches of the
    last run, peaks and failures, by query."""
    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch.benchmarks import tpch as B

    failures, warm_ms, k2_runs, peaks = [], {}, {}, {}
    pool = runner.engine.program_pool
    for q, sql in texts.items():
        want = answers["queries"][str(q)]
        times, k1, k2, cache, retries, run_peaks, traces = [], [], [], [], [], [], []
        graphs = []
        for run in range(1 + warm):
            before = dict(_kernels.LAUNCHES)
            counts = (pool.captures, pool.eager_hits, pool.recaptures, pool.dropped)
            torch.cuda.synchronize()
            reset_peak()
            t0 = time.perf_counter()
            with (k2_checked(builds, [f"Q{q}{tag}"]) if builds is not None and run == 0
                  else contextlib.nullcontext()):
                res = runner.engine.execute_statement(sql, runner.session)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            run_peaks.append(read_peak())
            k1.append(_kernels.LAUNCHES["dense_groupby"] - before["dense_groupby"])
            k2.append(_kernels.LAUNCHES["dense_join_build"] - before["dense_join_build"])
            ing = res.ingest_stats or {}
            cache.append([ing.get("table_cache_hits", 0),
                          ing.get("table_cache_misses", 0)])
            retries.append((res.exchange_stats or {}).get("overflow_retries"))
            traces.append(res.trace_count)
            # captures, hits run without a graph, captures again, graphs dropped
            graphs.append([a - b for a, b in zip(
                (pool.captures, pool.eager_hits, pool.recaptures, pool.dropped), counts)])
            types = [t.name for t in res.column_types]
            bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"],
                                   want["order_by"])
            if bad is None and types != want["types"]:
                bad = f"column types {types} != {want['types']}"
            if bad is not None:
                failures.append(f"Q{q}: {bad}")
                break
        warm_ms[q] = statistics.median(times[1:]) if len(times) > 1 else times[0]
        k2_runs[q] = k2[-1]
        if cold_launches is not None:
            cold_launches[f"Q{q}{tag}"] = k2[0]
        peaks[q] = max(run_peaks)
        stats = res.exchange_stats or {}
        log(
            phase, card=smi, query=f"Q{q}", rows=len(res.rows),
            matches_reference=bad is None, cold_ms=times[0],
            warm_median_ms=warm_ms[q], warm_ms=times[1:],
            k1_launches_per_run=k1, k2_launches_per_run=k2,
            overflow_retries_per_run=retries, trace_count_per_run=traces,
            captures_eager_hits_recaptures_dropped_per_run=graphs,
            pool_reserved_bytes=pool.reserved_bytes(),
            table_cache_hits_misses_per_run=cache,
            joinStrategy=stats.get("joinStrategy"),
            peak_device_bytes=peaks[q], peak_device_bytes_per_run=run_peaks,
            **stream_fields(res),
        )
        if q in streamed and not stats.get("join_streams"):
            failures.append(f"Q{q}: no join fragment streamed")
        if q in replayed and any(g[0] or g[1] for g in graphs[1:]):
            failures.append(f"Q{q}: a warm run captured or ran a program without its "
                            f"graph (captures, eager hits, recaptures, drops: {graphs[1:]})")
    return warm_ms, k2_runs, peaks, failures


TPCDS_SCHEMA = "sf1"      # the TPC-DS phase's scale factor
TPCDS_WARM = 2
TPCDS_SF10_QUERIES = (64, 95)  # BASELINE.json config 3, at tpcds.sf10
TPCDS_SF10_WARM = 1
# queries with a join fragment that streams on the inventory probe spine
TPCDS_STREAMED = (21, 37, 82)


def phase_tpcds(smi: str) -> tuple[dict, int]:
    """All 64 TPC-DS queries of the port's corpus, spec text, at SF1 from
    the port's tpcds connector through ``LocalQueryRunner(device="cuda")``
    in distributed mode with ``join_strategy=auto``: the 24 tables
    generated with all their columns (into the connector's host cache)
    and staged on the card once (rows, bytes, generation and staging
    seconds per table), then each query
    once cold and twice warm, its rows and column types held against the
    reference's answers (``tpcds_sf1_answers.json``) exactly, in ORDER BY
    order (rows whose ORDER BY keys tie as a multiset). No DOUBLE column
    needs a tolerance: each is one division of exact integer sums or
    counts. Every K2 build of the queries that launch it is then held
    against its plain version. Returns the kernel launches of this path's
    run and the largest K2 error over those builds."""
    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch.benchmarks import tpcds as DS
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.columnar import concat_batches
    from trino_tpu_torch.engine import table_cache_budget
    from trino_tpu_torch.testing import LocalQueryRunner

    answers = B.load_answers(DS.ANSWERS_SF1)
    if answers["schema"] != f"tpcds.{TPCDS_SCHEMA}":
        raise AssertionError(f"answers are for {answers['schema']}")
    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    runner.session.set("join_strategy", "auto")
    # the device table cache keeps its default budget: a quarter of the
    # card's memory (engine.table_cache_budget)
    tpcds = runner.catalogs.get("tpcds")
    staged = {}
    t_all = time.perf_counter()
    for table in tpcds.list_tables(TPCDS_SCHEMA):
        cols = tpcds.get_table(TPCDS_SCHEMA, table).column_names()
        t0 = time.perf_counter()
        parts = [tpcds.read_split(TPCDS_SCHEMA, table, cols, sp)
                 for sp in tpcds.get_splits(TPCDS_SCHEMA, table, 64)]
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch = concat_batches(parts).to("cuda")
        torch.cuda.synchronize()
        staged[table] = {
            "rows": batch.num_rows,
            "columns": len(cols),
            "staged_bytes": sum(
                c.data.numel() * c.data.element_size()
                + (0 if c.valid is None else c.valid.numel())
                for c in batch.columns
            ),
            "generate_s": gen_s,
            "stage_s": time.perf_counter() - t0,
        }
        del batch, parts
    log("tpcds", card=smi, schema=TPCDS_SCHEMA, tables=staged,
        rows=sum(t["rows"] for t in staged.values()),
        staged_bytes=sum(t["staged_bytes"] for t in staged.values()),
        generate_and_stage_s=time.perf_counter() - t_all,
        disk_cache=tpcds.disk_cache_stats())
    torch.cuda.empty_cache()
    texts = DS.queries(f"tpcds.{TPCDS_SCHEMA}")
    pool_before = pool_counts(runner.engine)
    builds, cold_launches = [], {}
    # the main path's run: every count starts at 0 here and is read after
    _kernels.reset_counts()
    warm_ms, _, peaks, failures = run_against_answers(
        runner, texts, answers, TPCDS_WARM, "tpcds", smi, TPCDS_STREAMED,
        builds=builds, cold_launches=cold_launches,
    )
    sf1_cache = runner.engine.table_cache.snapshot()
    log("tpcds", card=smi, schema=TPCDS_SCHEMA, table_cache=sf1_cache,
        table_cache_budget_bytes=table_cache_budget(
            runner.session, runner.engine.memory_pool, runner.engine.device))
    if sf1_cache["evictions"]:
        failures.append(f"the table cache evicted {sf1_cache['evictions']} times at SF1")
    # BASELINE.json config 3: Q64 and Q95 at SF10, the same checks
    answers10 = B.load_answers(DS.ANSWERS_SF10)
    texts10 = DS.queries(answers10["schema"])
    texts10 = {q: texts10[q] for q in TPCDS_SF10_QUERIES}
    # Q64's warm run replays its stored programs, every graph kept under
    # the pool's budget
    _, _, _, failures10 = run_against_answers(
        runner, texts10, answers10, TPCDS_SF10_WARM, "tpcds_sf10", smi, replayed=(64,),
        builds=builds, cold_launches=cold_launches, tag="@sf10",
    )
    failures += failures10
    launches = dict(_kernels.LAUNCHES)
    log("tpcds", card=smi, launches=launches,
        warm_total_ms=sum(warm_ms.values()), table_cache=runner.engine.table_cache.snapshot(),
        **pool_counts(runner.engine, pool_before))
    if failures:
        raise AssertionError("rows differ from the reference: " + "; ".join(failures))
    if launches["dense_join_build"] < 1:
        raise AssertionError("the TPC-DS queries launched no join-build kernel")
    # every K2 build of the cold runs against its plain version, at the
    # shapes this path gave it
    k2_err = check_cold_builds("tpcds", smi, builds, cold_launches)
    slowest = sorted(warm_ms, key=warm_ms.get, reverse=True)[:1]
    phase_profile(runner, {f"Q{q}": texts[q] for q in slowest}, card=smi)
    top = max(peaks, key=peaks.get)
    log("peak", card=smi, query=f"Q{top}", **peak_attribution(runner, texts[top]))
    log("peak", card=smi, query="Q95@sf10",
        **peak_attribution(runner, texts10[95], top=12, with_joins=True))
    # and its cold run (its cold peak is its query peak): the same run with
    # the capacities it grew forgotten, the cached tables kept
    runner.engine.drop_query_cache(fingerprint_of(runner, texts10[95]))
    log("peak", card=smi, query="Q95@sf10-cold",
        **peak_attribution(runner, texts10[95], top=12, with_joins=True))
    check_pool(runner.engine, "tpcds")
    return launches, k2_err


def fingerprint_of(runner, sql: str) -> str:
    return runner.engine.fingerprint(sql, runner.session)[0]


MESH_SHARDS = 4           # shards of phase mesh's mesh, all on the one card
MESH_WARM = 1             # its second warm pass (~2 s) was cut for phase server
MESH_SKEW_ROWS = 2_000_000  # tests/test_skew.py::TestSkewedJoin2M
# the 22 queries' warm sum on 4 shards before one streamed chunk a shard
# (H100 80GB HBM3 at 700.00 W), printed beside this run's
MESH_WARM_BEFORE = 1967.98
# the skew shape's shards: the reference's acceptance mesh. On 4 shards
# the hot destination takes ~2.3x a fair share, which the cold bucket
# (2x) and the spill tier absorb, so skew off would not overflow
MESH_SKEW_SHARDS = 8
MESH_EXCHANGE_KEYS = ("exchanges", "shuffle_rows", "padded_shuffle_rows", "shuffle_bytes",
                      "padding_ratio", "hot_keys", "salted_rows", "overflow_retries")


def check_pool(engine, phase: str) -> None:
    """The engine's graph pools at or under their budget (one line)."""
    pool = engine.program_pool
    reserved = pool.reserved_bytes() or 0
    log("pool", after=phase, pool_reserved_bytes=reserved, budget_bytes=pool.budget_bytes,
        captures=pool.captures, recaptures=pool.recaptures, evicted_programs=pool.evicted,
        dropped_graphs=pool.dropped, eager_hits=pool.eager_hits,
        stored_programs=len(pool._lru))
    if pool.budget_bytes is not None and reserved > pool.budget_bytes:
        raise AssertionError(f"{phase}: the program pools hold {reserved} bytes, "
                             f"past their budget of {pool.budget_bytes}")


def mesh_runner(engine, shards: int = MESH_SHARDS):
    """A ``DistributedQueryRunner`` of ``shards`` shards on the card over
    ``engine`` (its catalogs and staged tables); the caller sets
    ``engine.mesh`` back to None after."""
    from trino_tpu_torch.testing import DistributedQueryRunner

    return DistributedQueryRunner(n_devices=shards, device="cuda", engine=engine)


def mesh_fields(res) -> dict:
    st = res.exchange_stats or {}
    return {k: st.get(k) for k in MESH_EXCHANGE_KEYS}


def check_cold_builds(phase: str, smi: str, builds: list, cold_launches: dict) -> int:
    """The K2 builds of the queries' cold runs (``k2_checked``: the eager
    warm-ups before each capture and their overflow ladders; a replay in a
    cold run repeats a checked warm-up's builds) each equal plain; a query
    whose cold run launched K2 must have had its builds checked. Returns
    the largest error."""
    per = {}
    for b in builds:
        per[b["query"]] = per.get(b["query"], 0) + 1
    k2_err = max([max(b["max_abs_err"], b["unplaced_err"]) for b in builds] or [0])
    log(phase, card=smi, k2_checked_builds=per, k2_cold_launches=cold_launches,
        k2_max_abs_err=k2_err, overflowing_builds=sum(b["unplaced"] > 0 for b in builds),
        largest_build_rows=max([b["rows"] for b in builds] or [0]))
    bad = [q for q, n in cold_launches.items() if n and not 0 < per.get(q, 0) <= n]
    if bad:
        raise AssertionError(f"{phase}: K2 builds checked {per} against cold launches "
                             f"{cold_launches} (queries {bad})")
    if k2_err:
        raise AssertionError(f"{phase}: K2 != plain on a build (max |err| {k2_err})")
    return k2_err


def phase_mesh_join(runner, oracle, smi: str) -> tuple[dict, int]:
    """Phase ``mesh``, its SF10 part: Q-J1 and Q-J2 over phase ``join``'s
    memory tables (``runner``'s engine) on a mesh of
    :data:`MESH_SHARDS` shards with ``join_distribution_type=PARTITIONED``
    (both sides hash-repartitioned between the shards, one K2 build a
    shard), once cold and once warm, against the numpy oracle; each run
    with its exchange counters, time and peak. Every K2 build of the cold
    runs is held against its plain version as it runs. Returns the
    launches of this path's run and the largest K2 error."""
    import torch

    from trino_tpu_torch import _kernels

    mesh = mesh_runner(runner.engine)
    mesh.session.set("join_distribution_type", "PARTITIONED")
    texts = {n: JOIN_QUERIES[n] for n in ("Q-J1", "Q-J2")}
    try:
        _kernels.reset_counts()
        builds, cold_launches = [], {}
        for name, sql in texts.items():
            runs = []
            for label in ("cold", "warm"):
                before = _kernels.LAUNCHES["dense_join_build"]
                torch.cuda.synchronize()
                reset_peak()
                t0 = time.perf_counter()
                with (k2_checked(builds, [name]) if label == "cold"
                      else contextlib.nullcontext()):
                    res = mesh.engine.execute_statement(sql, mesh.session)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                rows = res.rows if name == "Q-J1" else sorted(res.rows)
                if rows != oracle[name]:
                    raise AssertionError(f"mesh: {name} ({label}) rows differ from the oracle")
                runs.append({"run": label, "ms": ms,
                             "k2_launches": _kernels.LAUNCHES["dense_join_build"] - before,
                             "peak_device_bytes": read_peak(),
                             **mesh_fields(res)})
            if not res.exchange_stats.get("exchanges"):
                raise AssertionError(f"mesh: {name} ran no exchange")
            cold_launches[name] = runs[0]["k2_launches"]
            log("mesh", card=smi, shards=MESH_SHARDS, query=name, rows=len(res.rows),
                matches_oracle=True, runs=runs,
                joinStrategy=(res.exchange_stats or {}).get("joinStrategy"))
        launches = dict(_kernels.LAUNCHES)
        log("mesh", card=smi, part="sf10", launches=launches)
        k2_err = check_cold_builds("mesh", smi, builds, cold_launches)
        check_pool(runner.engine, "mesh-sf10")
    finally:
        runner.engine.mesh = None
    return launches, k2_err


def seed_skew_tables(catalogs, n_rows: int, seed: int) -> None:
    """``tests/test_skew.py::_seed_tables`` in the port: Zipf(1.2) join
    keys truncated to 8 values (the top key ~43% of the rows) in
    ``memory.default.facts``, the 8 keys in ``memory.default.dims``."""
    import torch

    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch, Column
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema

    mem = catalogs.get("memory")
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.2, size=6 * n_rows)
    keys = raw[raw <= 8][:n_rows].astype(np.int64)
    vals = rng.integers(0, 1000, n_rows).astype(np.int64)
    mem.create_table("default", "facts", TableSchema(
        "facts", (ColumnSchema("k", T.BIGINT), ColumnSchema("v", T.BIGINT))))
    mem.insert("default", "facts", Batch(
        [Column(T.BIGINT, torch.from_numpy(keys)), Column(T.BIGINT, torch.from_numpy(vals))],
        n_rows))
    dk = np.arange(1, 9, dtype=np.int64)
    mem.create_table("default", "dims", TableSchema(
        "dims", (ColumnSchema("k", T.BIGINT), ColumnSchema("name", T.BIGINT))))
    mem.insert("default", "dims", Batch(
        [Column(T.BIGINT, torch.from_numpy(dk)), Column(T.BIGINT, torch.from_numpy(dk * 100))],
        8))


SKEW_JOIN_SQL = ("select sum(f.v * d.name) as chk, count(*) as c "
                 "from memory.default.facts f join memory.default.dims d on f.k = d.k")


def phase_mesh(smi: str, runner) -> tuple[dict, int]:
    """Phase ``mesh``, its SF1 part, over phase ``tpch22``'s engine and
    staged tables: the 22 TPC-H queries on a mesh of
    :data:`MESH_SHARDS` shards on the card, once cold and
    :data:`MESH_WARM` times warm, rows against the committed answers,
    each with its exchange counters, times, the allocator's peak and the
    graph pools' bytes; then the skew acceptance shape
    (``tests/test_skew.py::TestSkewedJoin2M``: Zipf(1.2) over 2,000,000
    rows, the join partitioned, on the reference's mesh of
    :data:`MESH_SKEW_SHARDS`) with skew handling on and off against the
    interpreter: equal rows, hot keys and no overflow retry on, at least
    one retry and twice the padding off. Every K2 build of the TPC-H
    queries' cold runs and of the skew shape's mesh runs is then held
    against its plain version. Returns the launches of the 22 queries'
    runs (the skew shape's have a line of their own) and the largest K2
    error."""
    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.config import Session

    answers = B.load_answers()
    texts = B.queries(f"tpch.{TPCH22_SCHEMA}")
    mesh = mesh_runner(runner.engine)
    pool = runner.engine.program_pool
    try:
        seed_skew_tables(runner.catalogs, MESH_SKEW_ROWS, seed=3)
        failures, warm_ms, cold_launches, peaks, builds = [], {}, {}, {}, []
        _kernels.reset_counts()
        for q in range(1, 23):
            want = answers["queries"][str(q)]
            times, k2 = [], []
            reset_peak()
            for run in range(1 + MESH_WARM):
                before = _kernels.LAUNCHES["dense_join_build"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (k2_checked(builds, [f"Q{q}"]) if run == 0
                      else contextlib.nullcontext()):
                    res = mesh.engine.execute_statement(texts[q], mesh.session)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                k2.append(_kernels.LAUNCHES["dense_join_build"] - before)
                bad = B.first_mismatch(B.canonical_rows(res.rows), want["rows"],
                                       want["order_by"])
                types = [t.name for t in res.column_types]
                if bad is None and types != want["types"]:
                    bad = f"column types {types} != {want['types']}"
                if bad is not None:
                    failures.append(f"Q{q}: {bad}")
                    break
            warm_ms[q] = statistics.median(times[1:]) if len(times) > 1 else times[0]
            cold_launches[f"Q{q}"] = k2[0]
            peaks[q] = read_peak()
            st = res.exchange_stats or {}
            streams = st.get("streams") or []
            if any(sm["parts"] != MESH_SHARDS for sm in streams):
                failures.append(f"Q{q}: a stream steps {streams}, not one part a shard")
            log("mesh", card=smi, shards=MESH_SHARDS, query=f"Q{q}", rows=len(res.rows),
                streams=streams,
                trace_count=res.trace_count, captures=pool.captures,
                dropped_graphs=pool.dropped, program_evictions=st.get("program_evictions"),
                matches_reference=bad is None, cold_ms=times[0], warm_median_ms=warm_ms[q],
                warm_ms=times[1:], k2_launches_per_run=k2, peak_device_bytes=peaks[q],
                pool_reserved_bytes=pool.reserved_bytes(), fragment_modes=res.fragment_modes,
                **mesh_fields(res))
        # the main path's count: the 22 queries on MESH_SHARDS shards alone
        launches = dict(_kernels.LAUNCHES)
        log("mesh", card=smi, part="sf1", launches=launches,
            warm_total_ms=sum(warm_ms.values()), warm_total_ms_before=MESH_WARM_BEFORE,
            max_peak_device_bytes=max(peaks.values()))
        skew, skew_launches = {}, {}
        skew_mesh = mesh_runner(runner.engine, MESH_SKEW_SHARDS)
        for label, props in (("on", {}), ("off", {"skew_handling": False}),
                             ("local", {"execution_mode": "local"})):
            s = Session(properties={"execution_mode": "distributed",
                                    "join_distribution_type": "PARTITIONED", **props})
            before = _kernels.LAUNCHES["dense_join_build"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the mesh runs' K2 builds are held against plain too; the
            # interpreter's run is the rows' reference, counted nowhere
            with (k2_checked(builds, [f"skew-{label}"]) if label != "local"
                  else contextlib.nullcontext()):
                res = skew_mesh.engine.execute_statement(SKEW_JOIN_SQL, s)
            torch.cuda.synchronize()
            skew[label] = res
            if label != "local":
                cold_launches[f"skew-{label}"] = skew_launches[label] = (
                    _kernels.LAUNCHES["dense_join_build"] - before)
            log("mesh", card=smi, part="skew", shards=MESH_SKEW_SHARDS, setting=label,
                rows=res.rows, trace_count=res.trace_count,
                ms=(time.perf_counter() - t0) * 1e3, **mesh_fields(res))
        log("mesh", card=smi, part="skew", shards=MESH_SKEW_SHARDS,
            k2_launches=skew_launches)
        # the engine's mesh back to the queries' (a runner sets its own)
        runner.engine.mesh = mesh.mesh
        on, off = skew["on"].exchange_stats, skew["off"].exchange_stats
        if not skew["on"].rows == skew["off"].rows == skew["local"].rows:
            failures.append("skew: rows differ between skew on, off and the interpreter")
        if on["hot_keys"] < 1 or on["overflow_retries"] != 0:
            failures.append(f"skew on: hot_keys {on['hot_keys']}, "
                            f"overflow_retries {on['overflow_retries']}")
        if off["overflow_retries"] < 1 or off["padding_ratio"] < 2 * on["padding_ratio"]:
            failures.append(f"skew off: overflow_retries {off['overflow_retries']}, "
                            f"padding_ratio {off['padding_ratio']} vs {on['padding_ratio']}")
        if failures:
            raise AssertionError("mesh: " + "; ".join(failures))
        k2_err = check_cold_builds("mesh", smi, builds, cold_launches)
        check_pool(runner.engine, "mesh")
    finally:
        runner.engine.mesh = None
    return launches, k2_err


# --- phase cluster ------------------------------------------------------------

CLUSTER_WORKERS = 2
# each process's share of the card: the coordinator and two workers, the
# memory scenario's coordinator and worker (CLUSTER_KILL_SHARE each), and
# this script's own quarter: 3 * 0.22 + 2 * 0.04 + 0.25 = 0.99
CLUSTER_SHARE = 0.22
CLUSTER_KILL_SHARE = 0.04
CLUSTER_MEMORY_LIMIT = 32 << 30
# the cluster memory scenario's own cluster, booted beside the main one:
# the worker's scan of orders (1,500,000 rows at SF1, 32 bytes a row)
# reserves its result past the limit for as long as it serializes its
# pages (1.5M distinct o_comment values: seconds, so the worker's 2 s
# announce reports it); a region count stays far below it
CLUSTER_KILL_LIMIT = 16 << 20
# the bound on the killed query's task to read CANCELED, and on the
# worker's reservations to fall back under the limit, after the kill
CLUSTER_KILL_CANCEL_S = 15
CLUSTER_KILL_SQL = ("select o_orderkey, o_custkey, o_totalprice, o_orderdate, o_comment"
                    " from tpch.{schema}.orders")
CLUSTER_SCHEMA = "sf1"
# the 22 queries at SF1 took 275.5 s of the phase's 180 on an H100 80GB
# HBM3 at 700 W, so the phase runs these seven at SF1 and the 22 at
# tpch.tiny
CLUSTER_SF1_QUERIES = (1, 3, 5, 6, 9, 10, 18)
# those of them whose workers build a join table: each run launches K2
CLUSTER_JOIN_QUERIES = (3, 5, 9, 10, 18)
# the chaos scenarios of scripts/chaos_smoke.py, on TPC-H Q1
CLUSTER_CHAOS = {
    "retry": {"retry_policy": "TASK", "task_retry_attempts": 8, "fault_injection_seed": 3,
              "fault_task_crash_p": 0.3, "retry_initial_delay_ms": 20,
              "retry_max_delay_ms": 200},
    "speculation": {"pipeline_fusion": False, "retry_policy": "TASK",
                    "fault_injection_seed": 3, "fault_slow_workers": "worker-1",
                    "fault_task_slow_factor": 10.0, "speculation": True,
                    "speculation_floor_ms": 100, "speculation_multiplier": 2.0,
                    "speculation_max_fraction": 1.0},
    "node_death": {"retry_policy": "TASK", "exchange_spooling": True,
                   "worker_execution": "per_fragment", "task_retry_attempts": 8,
                   "retry_initial_delay_ms": 20, "retry_max_delay_ms": 200,
                   "fault_worker_exit_site": "2.0", "fault_worker_exit_delay_ms": 300,
                   "fault_task_stall_ms": 1000},
}


def cluster_process(argv: list) -> int:
    """One process of phase ``cluster`` (``chip_smoke.py --cluster-process
    <server arguments>``): ``trino_tpu_torch.server.main`` with every K2
    build held against ``build_table_plain`` on the same inputs, one JSON
    line a build appended to ``$CHIP_SMOKE_K2_DIR/k2.<pid>.jsonl``, and
    the process's allocator peak and launch counts in
    ``proc.<pid>.json`` when the server stops."""
    import threading

    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch.ops import dense_join as DJ
    from trino_tpu_torch.server.main import main as server_main

    out = os.environ["CHIP_SMOKE_K2_DIR"]
    lock = threading.Lock()
    real = DJ.build_table_cuda

    def checked(slot_base, use, capacity, window):
        res = real(slot_base, use, capacity, window)
        if torch.cuda.is_current_stream_capturing():
            return res
        ptable, punplaced = DJ.build_table_plain(slot_base, use, capacity, window)
        rec = {"rows": int(slot_base.shape[0]), "live": int(use.sum()),
               "capacity": capacity, "window": window, "unplaced": int(res[1]),
               "max_abs_err": int((res[0].to(torch.int64)
                                   - ptable.to(torch.int64)).abs().max()),
               "unplaced_err": abs(int(res[1]) - int(punplaced))}
        with lock, open(os.path.join(out, f"k2.{os.getpid()}.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        return res

    DJ.build_table_cuda = checked
    if os.environ.get("CHIP_SMOKE_SPMD_CHECK"):
        # phase spmd: the peer-copy collectives checked as the group forms
        from trino_tpu_torch.parallel import spmd as SP

        join = SP.initialize_spmd

        def joined(*args, **kwargs):
            join(*args, **kwargs)
            spmd_selfcheck(out)

        SP.initialize_spmd = joined
    try:
        return server_main(argv)
    finally:
        with open(os.path.join(out, f"proc.{os.getpid()}.json"), "w") as f:
            json.dump({"argv": argv, "launches": dict(_kernels.LAUNCHES),
                       "peak_bytes": (torch.cuda.max_memory_allocated()
                                      if torch.cuda.is_available() else None)}, f)


def cluster_query_info(runner, sql: str) -> dict:
    """The coordinator's document of the newest query with text ``sql``."""
    qs = [q for q in http_json(f"{runner.coordinator_uri}/v1/query")
          if q.get("query", "").strip() == sql.strip()]
    q = max(qs, key=lambda x: x.get("createTime") or 0)
    return http_json(f"{runner.coordinator_uri}/v1/query/{q['queryId']}")


def cluster_fields(info: dict) -> dict:
    """What a cluster query's document says of its stages: tasks, their
    execution paths, the pages and bytes they shipped over HTTP, the
    workers' K2 launches and the device peak of their programs."""
    stages = (info.get("queryStats") or {}).get("stages") or []
    paths, launches, fused_errors = {}, {}, []
    pages = {"pages_out": 0, "page_bytes_out": 0, "serialize_ms": 0.0, "d2h_ms": 0.0}
    for st in stages:
        for k, v in (st.get("executionPaths") or {}).items():
            paths[k] = paths.get(k, 0) + v
        fused_errors += st.get("fusedErrors") or []
        for k, v in (st.get("kernelLaunches") or {}).items():
            launches[k] = launches.get(k, 0) + v
        for k in pages:
            pages[k] += (st.get("pages") or {}).get(k, 0)
    ds = info.get("deviceStats") or {}
    return {"tasks": sum(st.get("tasks", 0) for st in stages),
            "attempts": sum(st.get("attempts", 0) for st in stages),
            "execution_paths": paths, "fused_errors": fused_errors,
            "http_pages": pages["pages_out"],
            "http_page_bytes": pages["page_bytes_out"],
            "serialize_ms": round(pages["serialize_ms"], 3),
            "d2h_ms": round(pages["d2h_ms"], 3), "kernel_launches": launches,
            "program_peak_bytes": ds.get("peak_hbm_bytes"),
            "h2d_bytes": (info.get("ingestStats") or {}).get("h2d_bytes"),
            "h2d_transfers": (info.get("ingestStats") or {}).get("h2d_transfers")}


def cluster_query(runner, smi: str, schema: str, q: int, answers: dict,
                  launches: dict, failures: list, runs: int = 2) -> tuple[list, bool]:
    """TPC-H query ``q`` over ``tpch.<schema>`` on the cluster, cold then
    warm (``runs`` runs), rows against ``answers``; its line, and the
    workers' launches added to ``launches``. Returns the runs' ms and
    whether a run failed."""
    from trino_tpu_torch.benchmarks import tpch as B

    sql = B.queries(f"tpch.{schema}")[q]
    want = answers["queries"][str(q)]
    times, fields, failed, matches = [], None, False, True
    for run in range(runs):
        t0 = time.perf_counter()
        rows, _ = runner.execute(sql)
        times.append((time.perf_counter() - t0) * 1e3)
        bad = B.first_mismatch(B.canonical_rows(rows), want["rows"], want["order_by"])
        if bad is not None:
            failures.append(f"{schema} Q{q} run {run}: {bad}")
            failed, matches = True, False
        fields = cluster_fields(cluster_query_info(runner, sql))
        for k, v in fields["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
        # every task on the card's fused path: a task the interpreter ran
        # (a fused-path failure it hid) launches no hand kernel
        off_path = {k: v for k, v in fields["execution_paths"].items()
                    if k not in ("fused", "fused-pipeline")}
        if off_path or fields["fused_errors"]:
            failures.append(f"{schema} Q{q} run {run}: tasks off the fused path "
                            f"{off_path}, fused errors {fields['fused_errors']}")
            failed = True
        if q in CLUSTER_JOIN_QUERIES and schema == CLUSTER_SCHEMA \
                and not fields["kernel_launches"].get("dense_join_build"):
            failures.append(f"{schema} Q{q} run {run}: the workers launched no K2")
            failed = True
    if schema == CLUSTER_SCHEMA:
        CLUSTER_MS[q] = times
    log("cluster", card=smi, schema=schema, query=f"Q{q}", rows=len(rows),
        matches_reference=matches, cold_ms=times[0],
        warm_ms=times[1] if runs > 1 else None,
        inprocess_warm_ms=TPCH22_WARM_MS.get(q) if schema == CLUSTER_SCHEMA else None,
        **fields)
    return times, failed


def cluster_chaos(runner, smi: str, name: str, sql: str, clean: list,
                  failures: list) -> None:
    """One chaos scenario of :data:`CLUSTER_CHAOS` on ``sql``: its rows
    against the clean run's, its retry, hedge and recovery counters, and
    the workers' task states."""
    t0 = time.perf_counter()
    rows, _ = runner.execute(sql, session_properties=CLUSTER_CHAOS[name])
    info = cluster_query_info(runner, sql)
    rec = {k: info.get(k) for k in ("taskRetries", "speculativeAttempts", "speculativeWins",
                                     "recoveredTasks", "spooledBytes", "queryAttempts")}
    tasks = {}
    for uri in runner.worker_uris:
        try:
            for t in http_json(f"{uri}/v1/task"):
                if t["taskId"].startswith(info["queryId"]):
                    tasks[t["state"]] = tasks.get(t["state"], 0) + 1
        except OSError:
            pass  # the dead worker of the node-death scenario
    log("cluster", card=smi, scenario=name, ms=(time.perf_counter() - t0) * 1e3,
        rows_equal=rows == clean, task_states=tasks, **rec)
    if rows != clean:
        failures.append(f"{name}: rows differ from the clean run")
    if name == "retry" and rec["taskRetries"] < 1:
        failures.append("retry: no task was retried")
    if name == "speculation" and (rec["speculativeWins"] < 1
                                  or not tasks.get("CANCELED_SPECULATIVE")):
        failures.append(f"speculation: {rec}, task states {tasks}")
    if name == "node_death" and (rec["recoveredTasks"] < 1 or rec["spooledBytes"] <= 0):
        failures.append(f"node death: {rec}")


def cluster_memory_kill(smi: str, runner, schema: str, failures: list) -> None:
    """The cluster memory manager's kill, fed by the workers themselves,
    on ``runner``: a coordinator and one worker with
    ``--cluster-memory-limit-bytes``. A scan of orders whose task reserves
    its result in the worker's pool while it serializes its pages, the
    worker's announce loop reports the reservation, and the coordinator
    kills the query with CLUSTER_OUT_OF_MEMORY, which cancels its worker
    task: the task must read CANCELED and the worker's reservations fall
    back under the limit within :data:`CLUSTER_KILL_CANCEL_S` of the kill
    (``tasks_canceled_after_s``, ``released_after_s``). Then a small
    query passes on the same cluster."""
    import re
    import urllib.request

    from trino_tpu_torch.server import auth

    t0 = time.perf_counter()
    uri = runner.coordinator_uri
    limit = http_json(f"{uri}/v1/memory")["clusterMemoryLimitBytes"]
    req = urllib.request.Request(
        f"{uri}/v1/statement", method="POST",
        data=CLUSTER_KILL_SQL.format(schema=schema).encode(),
        headers={"X-Trino-User": "mem", "X-Trino-Session": "execution_mode=cluster",
                 **auth.headers()})
    with urllib.request.urlopen(req, timeout=60) as r:
        qid = json.loads(r.read().decode())["id"]
    deadline, state, err = time.time() + 120, None, {}
    while time.time() < deadline:
        info = http_json(f"{uri}/v1/query/{qid}")
        state = info["state"]
        if state in ("FAILED", "FINISHED", "CANCELED"):
            err = info.get("error") or {}
            break
        time.sleep(0.2)
    killed_s = time.perf_counter() - t0
    t_kill = time.perf_counter()

    def task_states() -> dict:
        states = {}
        for wuri in runner.worker_uris:
            for t in http_json(f"{wuri}/v1/task"):
                if t["taskId"].startswith(qid + "."):
                    states[t["state"]] = states.get(t["state"], 0) + 1
        return states

    # the kill cancels the query's worker task: a bounded check that it
    # reads CANCELED, and that the worker's next announce (every 2 s)
    # reports its reservation gone
    deadline, tasks, canceled_s = time.time() + CLUSTER_KILL_CANCEL_S, {}, None
    while time.time() < deadline:
        tasks = task_states()
        if tasks and "RUNNING" not in tasks:
            canceled_s = time.perf_counter() - t_kill
            break
        time.sleep(0.1)
    deadline, mem, released_s = time.time() + CLUSTER_KILL_CANCEL_S, {}, None
    while time.time() < deadline:
        mem = http_json(f"{uri}/v1/memory")
        if mem["clusterReservedBytes"] <= limit:
            released_s = time.perf_counter() - t_kill
            break
        time.sleep(0.2)
    small, _ = runner.execute(f"select count(*) from tpch.{schema}.region")
    mem = http_json(f"{uri}/v1/memory")
    msg = err.get("message") or ""
    reserved = re.search(r"this query reserved (\d+)", msg)
    log("cluster", card=smi, scenario="cluster_memory", report="the worker's announce",
        limit_bytes=limit, killed_state=state, error=err.get("errorName"),
        killed=qid in mem.get("killedQueries", []),
        reserved_bytes=int(reserved.group(1)) if reserved else None,
        killed_after_s=killed_s, task_states=tasks, tasks_canceled_after_s=canceled_s,
        released_after_s=released_s, small_query_rows=small,
        ms=(time.perf_counter() - t0) * 1e3)
    if state != "FAILED" or err.get("errorName") != "CLUSTER_OUT_OF_MEMORY" \
            or small != [(5,)]:
        failures.append(f"cluster memory: {state} {err}, small query {small}")
    if canceled_s is None or not tasks.get("CANCELED") or released_s is None:
        failures.append(f"cluster memory: the killed query's tasks {tasks} did not cancel, "
                        f"or its reservations stayed over the limit, "
                        f"{CLUSTER_KILL_CANCEL_S} s after the kill")


def close_booted(boot) -> None:
    """Close the runner that a background boot (a future) made; a boot
    that failed has stopped its own processes."""
    try:
        boot.result().close()
    except Exception:  # noqa: BLE001
        pass


def phase_cluster(smi: str) -> tuple[dict, int]:
    """Phase ``cluster``: a coordinator and :data:`CLUSTER_WORKERS` worker
    processes on the card (``MultiProcessQueryRunner(device="cuda")``,
    each process holding :data:`CLUSTER_SHARE` of the card), started
    through :func:`cluster_process` so every K2 build in a worker is held
    against its plain version. TPC-H in ``execution_mode=cluster``, rows
    against the committed answers: the queries of
    :data:`CLUSTER_SF1_QUERIES` at SF1 cold and once warm, the 22 at
    ``tpch.tiny`` once (the 22 at SF1 do not fit the phase's time); task
    crashes under TASK retry and a slow worker under speculation, rows
    against the clean run's; a scaled CTAS written from both workers; a
    drain and a restart; a node death with spooling; last, on a cluster
    of its own booted beside the main one, the cluster memory manager's
    kill of a query whose reservations pass the limit while a small one
    passes (:func:`cluster_memory_kill`).
    Returns the workers' launches over the TPC-H queries' runs and the
    largest K2 error."""
    import secrets
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.server import auth
    from trino_tpu_torch.testing import MultiProcessQueryRunner

    t_phase = time.perf_counter()
    answers = B.load_answers()
    texts = B.queries(f"tpch.{CLUSTER_SCHEMA}")
    work = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    k2_dir = os.path.join(work, "k2")
    os.makedirs(k2_dir)
    failures, launches = [], {"dense_groupby": 0, "dense_join_build": 0}
    # one internal credential for both clusters, set before either boots
    os.environ.setdefault(auth.ENV_VAR, secrets.token_hex(16))
    # the memory scenario's cluster boots beside the main one and idles
    # until the phase's end
    booter = ThreadPoolExecutor(1)
    kill_boot = booter.submit(
        MultiProcessQueryRunner, n_workers=1, device="cuda", card_share=CLUSTER_KILL_SHARE,
        cluster_memory_limit_bytes=CLUSTER_KILL_LIMIT,
        extra_env={"PYTHONPATH": CHILD_ENV["PYTHONPATH"]})
    booter.shutdown(wait=False)
    t0 = time.perf_counter()
    try:
        runner = MultiProcessQueryRunner(
            n_workers=CLUSTER_WORKERS, device="cuda", card_share=CLUSTER_SHARE,
            cluster_memory_limit_bytes=CLUSTER_MEMORY_LIMIT,
            catalogs=[f"shared=file:{os.path.join(work, 'shared')}"],
            command=[sys.executable, os.path.abspath(__file__), "--cluster-process"],
            extra_env={"CHIP_SMOKE_K2_DIR": k2_dir, "PYTHONPATH": CHILD_ENV["PYTHONPATH"]},
        )
    except BaseException:
        close_booted(kill_boot)
        raise
    log("cluster", card=smi, workers=CLUSTER_WORKERS, card_share=CLUSTER_SHARE,
        kill_cluster_share=CLUSTER_KILL_SHARE, boot_s=time.perf_counter() - t0,
        coordinator=runner.coordinator_uri)
    try:
        # 1. TPC-H queries, cold then warm: seven at SF1, the 22 at tiny
        log("cluster", card=smi, note="the 22 TPC-H queries at SF1 do not fit the "
            "phase's 180 s (275.5 s on an H100 80GB HBM3 at 700 W): Q1, Q3, Q5, Q6, "
            "Q9, Q10 and Q18 at SF1, the 22 at tpch.tiny")
        tiny_answers = B.load_answers(
            B.ANSWERS_SF1.replace("tpch_sf1_answers", "tpch_tiny_answers"))
        # the 22 at tiny run once: they hold the rows, the times are SF1's
        for schema, qs, ans, runs in ((CLUSTER_SCHEMA, CLUSTER_SF1_QUERIES, answers, 2),
                                      ("tiny", range(1, 23), tiny_answers, 1)):
            cold_sum = warm_sum = 0.0
            for q in qs:
                times, failed = cluster_query(runner, smi, schema, q, ans, launches,
                                              failures, runs)
                cold_sum += times[0]
                warm_sum += times[-1] if runs > 1 else 0.0
            log("cluster", card=smi, part="tpch", schema=schema, queries=len(qs),
                cold_total_ms=cold_sum, warm_total_ms=warm_sum if runs > 1 else None,
                inprocess_warm_total_ms=(
                    sum(TPCH22_WARM_MS.get(q, 0.0) for q in qs)
                    if schema == CLUSTER_SCHEMA and TPCH22_WARM_MS else None),
                worker_launches=launches, seconds=time.perf_counter() - t_phase)
        if launches.get("dense_join_build", 0) < 1:
            failures.append("the workers launched no K2 over the TPC-H queries")
        # 2. task crashes and a slow worker, rows against the clean run's
        q1 = texts[1]
        clean, _ = runner.execute(q1)
        for name in ("retry", "speculation"):
            cluster_chaos(runner, smi, name, q1, clean, failures)
        # 3. a scaled CTAS from both workers
        t0 = time.perf_counter()
        src = (f"select l_orderkey, l_partkey, l_quantity, l_extendedprice"
               f" from tpch.{CLUSTER_SCHEMA}.lineitem")
        runner.execute(f"create table shared.default.lineitem_copy as {src}",
                       session_properties={"scaled_writers": True,
                                           "writer_target_bytes": 64 << 20})
        check = ("select count(*), sum(l_orderkey), sum(l_partkey), sum(l_quantity),"
                 " sum(l_extendedprice) from {}")
        got, _ = runner.execute(check.format("shared.default.lineitem_copy"))
        want, _ = runner.execute(check.format(f"tpch.{CLUSTER_SCHEMA}.lineitem"))
        parts = [f for f in os.listdir(os.path.join(work, "shared", "default", "lineitem_copy"))
                 if f.endswith(".ttp")]
        log("cluster", card=smi, scenario="scaled_ctas", ms=(time.perf_counter() - t0) * 1e3,
            rows=got[0][0], rows_equal=got == want, part_files=len(parts))
        if got != want or len(parts) < 3:
            failures.append(f"scaled CTAS: {got} vs {want}, {len(parts)} parts")
        # 5. a graceful drain, then a restart (TPC-H Q1 at tiny), and last a
        # node death under spooling (the dead worker is not restarted)
        t0 = time.perf_counter()
        tiny_q1 = B.queries("tpch.tiny")[1]
        tiny_clean, _ = runner.execute(tiny_q1)
        runner.drain_worker(0)
        drained, _ = runner.execute(tiny_q1)
        runner.restart_worker(0)
        restarted, _ = runner.execute(tiny_q1)
        log("cluster", card=smi, scenario="drain_and_restart",
            ms=(time.perf_counter() - t0) * 1e3,
            rows_equal=drained == restarted == tiny_clean)
        if not drained == restarted == tiny_clean:
            failures.append("drain: rows differ from the clean run")
        cluster_chaos(runner, smi, "node_death", q1, clean, failures)
    except BaseException:
        close_booted(kill_boot)
        raise
    finally:
        runner.close()
    # 6. cluster memory, on the cluster of its own with a small limit
    try:
        cluster_memory_kill(smi, kill_boot.result(), CLUSTER_SCHEMA, failures)
    finally:
        close_booted(kill_boot)
    # every worker build against plain; each process's peak and launches
    builds, procs = [], []
    for name in sorted(os.listdir(k2_dir)):
        with open(os.path.join(k2_dir, name)) as f:
            if name.startswith("k2."):
                builds += [json.loads(line) for line in f if line.strip()]
            else:
                procs.append(json.load(f))
    k2_err = max([max(b["max_abs_err"], b["unplaced_err"]) for b in builds] or [0])
    log("cluster", card=smi, part="processes",
        processes=[{"role": p["argv"][p["argv"].index("--role") + 1],
                    "peak_bytes": p["peak_bytes"], "launches": p["launches"]} for p in procs],
        k2_checked_builds=len(builds), k2_max_abs_err=k2_err,
        largest_build_rows=max([b["rows"] for b in builds] or [0]),
        seconds=time.perf_counter() - t_phase)
    shutil.rmtree(work, ignore_errors=True)
    if not builds:
        failures.append("no worker K2 build was checked")
    if k2_err:
        failures.append(f"a worker's K2 build differs from plain (max |err| {k2_err})")
    if failures:
        raise AssertionError("cluster: " + "; ".join(failures))
    return launches, k2_err


SPMD_WORKERS = 2
# each process's share of the card (a coordinator and two workers), and
# this script's own quarter
SPMD_SHARE = 0.24
SPMD_SCHEMA = "sf1"
SPMD_QUERIES = (1, 3, 5, 10)
# those whose processes build a join table: each launches K2
SPMD_JOIN_QUERIES = (3, 5, 10)
# phase cluster's cold and warm ms a query, for phase spmd
CLUSTER_MS: dict = {}
# the one-process three-shard mesh's run of each SPMD query, on the card
SPMD_MESH3: dict = {}
SPMD_WINDOW_SQL = ("select o_orderstatus, rank() over (partition by o_orderstatus"
                   " order by o_totalprice desc) as rnk from tpch.tiny.orders"
                   " order by o_orderstatus, rnk limit 5")
SPMD_COUNT_SQL = "select count(*), sum(l_quantity) from tpch.sf1.lineitem"


def spmd_selfcheck(out_dir: str) -> None:
    """In each process of phase ``spmd``'s group, right after it joined:
    the collectives and a hash repartition through the peer-copy
    transport against the one-process mesh of as many shards on the
    card, on the same seeded inputs; an all to all and an all gather
    larger than the exchange arena go through it in rounds. One JSON file
    a process: each check's largest difference, its ms and the bytes it
    moved."""
    import torch

    from trino_tpu_torch.parallel import exchange as X
    from trino_tpu_torch.parallel import mesh as M
    from trino_tpu_torch.parallel import transport as TR

    tr = TR.current()
    mesh = M.make_mesh(device="cuda")
    one = M.make_mesh(mesh.world, "cuda")
    w, r = mesh.world, mesh.rank
    g = torch.Generator().manual_seed(17)
    checks = {}

    def check(name, fn_spmd, fn_one):
        moved0 = tr.stats["bytes_moved"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn_spmd()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = fn_one()
        err = 0 if got.shape == want.shape and bool((got == want).all()) else (
            float((got.double() - want.double()).abs().max()) if got.shape == want.shape
            else float("inf"))
        checks[name] = {"max_abs_err": err, "ms": ms,
                        "bytes_moved": tr.stats["bytes_moved"] - moved0}

    rows = tr.slot // 8 + 4097  # a block past one arena slot: two rounds
    blocks = torch.randint(-(1 << 40), 1 << 40, (w, w, rows), generator=g).cuda()
    check("all_to_all", lambda: M.all_to_all(blocks[r:r + 1], mesh),
          lambda: M.all_to_all(blocks)[r:r + 1])
    parts = torch.randn((w, tr.arena_bytes // 8 + 1001), generator=g,
                        dtype=torch.float64).cuda()
    check("all_gather", lambda: M.all_gather(parts[r:r + 1], mesh), lambda: M.all_gather(parts))
    vals = torch.randint(0, 1 << 40, (w, 5), generator=g).cuda()
    check("psum", lambda: M.psum(vals[r:r + 1], mesh), lambda: M.psum(vals))
    check("pmax", lambda: M.pmax(vals[r:r + 1], mesh), lambda: M.pmax(vals))
    m = 1 << 20
    khash = torch.randint(-(1 << 62), 1 << 62, (w * m,), generator=g).cuda()
    sel = (torch.rand(w * m, generator=g) < 0.9).cuda()
    col = torch.randint(-(1 << 40), 1 << 40, (w * m,), generator=g).cuda()
    bucket = X.needed_bucket(one, khash, sel)
    mine = slice(r * m, (r + 1) * m)
    check("hash_repartition",
          lambda: X.hash_repartition(mesh, [col[mine]], khash[mine], sel[mine], bucket)[0][0],
          lambda: X.hash_repartition(one, [col], khash, sel, bucket)[0][0].reshape(w, -1)[r])
    with open(os.path.join(out_dir, f"spmd_check.{os.getpid()}.json"), "w") as f:
        json.dump({"rank": r, **tr.describe(), "slot_bytes": tr.slot, "checks": checks}, f)


def spmd_mesh_reference(smi: str, runner) -> None:
    """Phase ``spmd``'s comparison, made while phase ``tpch22``'s engine
    and staged tables are there: each SPMD query once on a one-process
    mesh of three shards on the card (:data:`SPMD_MESH3`: its exchange
    counters, its cold ms and whether its rows equal the answers)."""
    import torch

    from trino_tpu_torch.benchmarks import tpch as B

    answers = B.load_answers()
    texts = B.queries(f"tpch.{SPMD_SCHEMA}")
    mesh = mesh_runner(runner.engine, 1 + SPMD_WORKERS)
    try:
        for q in SPMD_QUERIES:
            want = answers["queries"][str(q)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mesh.engine.execute_statement(texts[q], mesh.session)
            torch.cuda.synchronize()
            SPMD_MESH3[q] = {
                "cold_ms": (time.perf_counter() - t0) * 1e3,
                "matches_reference": B.first_mismatch(
                    B.canonical_rows(res.rows), want["rows"], want["order_by"]) is None,
                **mesh_fields(res)}
    finally:
        runner.engine.mesh = None
    log("spmd", card=smi, part="mesh3_reference", shards=1 + SPMD_WORKERS,
        queries={f"Q{q}": v for q, v in SPMD_MESH3.items()})


def _spmd_run(runner, sql: str) -> tuple[list, dict]:
    """``runner.execute`` of ``sql`` and the coordinator's document of
    that statement, by the query id its first response names."""
    from trino_tpu_torch.client import ClientSession, StatementClient

    client = StatementClient(runner.coordinator_uri, sql,
                             ClientSession(properties={"execution_mode": "cluster"}))
    rows = list(client.rows())
    return rows, http_json(f"{runner.coordinator_uri}/v1/query/{client.query_id}")


def _worker_task_count(runner) -> int:
    n = 0
    for uri in runner.worker_uris:
        try:
            n += len(http_json(f"{uri}/v1/task"))
        except OSError:
            continue
    return n


def phase_spmd(smi: str) -> tuple[dict, int]:
    """Phase ``spmd``: a coordinator and :data:`SPMD_WORKERS` workers on the
    card in one SPMD group (``MultiProcessQueryRunner(spmd=True)``, each
    process :data:`SPMD_SHARE` of the card and a 64 MiB exchange arena
    (``transport.ARENA_BYTES``), started through :func:`cluster_process` so
    that every K2 build of every process is held against its plain
    version). At boot each process checks the peer-copy collectives
    against the one-process mesh (:func:`spmd_selfcheck`). TPC-H Q1, Q3,
    Q5 and Q10 at SF1, cold and once warm, rows against the committed
    answers: each ran SPMD (no worker task; every process's run in the
    query's document), Q3, Q5 and Q10 launched K2 in every process, the
    exchange counters equal the one-process three-shard mesh's
    (:data:`SPMD_MESH3`), beside phase ``cluster``'s and the in-process
    times. Then two overlapping queries, a window query that falls back
    to tasks, and after a worker is killed a query that falls back.
    Returns the processes' launches over the four queries' runs and the
    largest K2 error."""
    import secrets
    import shutil
    import tempfile

    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.server import auth
    from trino_tpu_torch.testing import LocalQueryRunner, MultiProcessQueryRunner

    t_phase = time.perf_counter()
    answers = B.load_answers()
    texts = B.queries(f"tpch.{SPMD_SCHEMA}")
    work = tempfile.mkdtemp(prefix="chip_smoke_spmd_")
    k2_dir = os.path.join(work, "k2")
    os.makedirs(k2_dir)
    failures, launches = [], {"dense_groupby": 0, "dense_join_build": 0}
    os.environ.setdefault(auth.ENV_VAR, secrets.token_hex(16))
    t0 = time.perf_counter()
    checks: list = []
    runner = MultiProcessQueryRunner(
        n_workers=SPMD_WORKERS, device="cuda", card_share=SPMD_SHARE, spmd=True,
        command=[sys.executable, os.path.abspath(__file__), "--cluster-process"],
        extra_env={"CHIP_SMOKE_K2_DIR": k2_dir, "CHIP_SMOKE_SPMD_CHECK": "1",
                   "PYTHONPATH": CHILD_ENV["PYTHONPATH"]},
    )
    boot_s = time.perf_counter() - t0
    try:
        for name in sorted(os.listdir(k2_dir)):
            if name.startswith("spmd_check."):
                with open(os.path.join(k2_dir, name)) as f:
                    checks.append({**json.load(f), "pid": name.split(".")[1]})
        checks.sort(key=lambda c: c["rank"])
        log("spmd", card=smi, part="group", processes=1 + SPMD_WORKERS, card_share=SPMD_SHARE,
            boot_s=boot_s, transports=sorted({c["transport"] for c in checks}),
            arena_bytes=[c["arena_bytes"] for c in checks],
            checks={c["rank"]: c["checks"] for c in checks})
        if len(checks) != 1 + SPMD_WORKERS or {c["transport"] for c in checks} != {"peer"}:
            failures.append(f"the group's data plane is not peer copies in every process: "
                            f"{[(c['rank'], c['transport']) for c in checks]}")
        for c in checks:
            for nm, v in c["checks"].items():
                if v["max_abs_err"]:
                    failures.append(f"rank {c['rank']} {nm} != the one-process mesh")
        # 1. the four queries, cold then warm
        cold_sum = warm_sum = 0.0
        for q in SPMD_QUERIES:
            want = answers["queries"][str(q)]
            times, per_run = [], []
            for run in range(2):
                t0 = time.perf_counter()
                rows, doc = _spmd_run(runner, texts[q])
                times.append((time.perf_counter() - t0) * 1e3)
                bad = B.first_mismatch(B.canonical_rows(rows), want["rows"], want["order_by"])
                if bad is not None:
                    failures.append(f"Q{q} run {run}: {bad}")
                spmd = (doc.get("exchangeStats") or {}).get("spmd")
                if not spmd:
                    failures.append(f"Q{q} run {run} did not run SPMD")
                    continue
                procs = [spmd["coordinator"]] + spmd["workers"]
                k2 = [p.get("launches", {}).get("dense_join_build", 0) for p in procs]
                for p in procs:
                    for k in launches:
                        launches[k] += p.get("launches", {}).get(k, 0)
                if q in SPMD_JOIN_QUERIES and not all(k2):
                    failures.append(f"Q{q} run {run}: a process launched no K2 {k2}")
                per_run.append({
                    "k2_launches_by_rank": k2,
                    "bytes_moved_by_rank": [p["transport"]["bytes_moved"] for p in procs],
                    "transport_ms_by_rank": [p["transport"]["ms"] for p in procs],
                    "collectives": spmd["coordinator"]["transport"]["collectives"],
                    "host_reductions": spmd["coordinator"]["transport"]["host_reductions"],
                    "process_ms_by_rank": [p["ms"] for p in procs],
                    "exchange": {k: spmd["coordinator"]["exchange"].get(k)
                                 for k in MESH_EXCHANGE_KEYS},
                })
            ref = SPMD_MESH3.get(q)
            if ref is not None and per_run:
                for k in ("exchanges", "shuffle_rows", "padded_shuffle_rows"):
                    if per_run[0]["exchange"].get(k) != ref.get(k):
                        failures.append(f"Q{q}: {k} {per_run[0]['exchange'].get(k)} against "
                                        f"the one-process mesh's {ref.get(k)}")
            cold_sum += times[0]
            warm_sum += times[1]
            log("spmd", card=smi, query=f"Q{q}", cold_ms=times[0], warm_ms=times[1],
                cluster_cold_ms=(CLUSTER_MS.get(q) or [None])[0],
                cluster_warm_ms=(CLUSTER_MS.get(q) or [None, None])[-1],
                inprocess_warm_ms=TPCH22_WARM_MS.get(q),
                mesh3_cold_ms=(ref or {}).get("cold_ms"),
                mesh3_exchange={k: (ref or {}).get(k) for k in MESH_EXCHANGE_KEYS},
                runs=per_run)
        tasks = _worker_task_count(runner)
        if tasks:
            failures.append(f"the SPMD queries left {tasks} worker tasks")
        log("spmd", card=smi, part="tpch", queries=len(SPMD_QUERIES), cold_total_ms=cold_sum,
            warm_total_ms=warm_sum, worker_tasks=tasks, launches=launches,
            seconds=time.perf_counter() - t_phase)
        # 2. two overlapping queries
        from concurrent.futures import ThreadPoolExecutor

        count_rows, _ = runner.execute(SPMD_COUNT_SQL)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            fa = pool.submit(runner.execute, texts[1])
            fb = pool.submit(runner.execute, SPMD_COUNT_SQL)
            a, b = fa.result(timeout=600)[0], fb.result(timeout=600)[0]
        want = answers["queries"]["1"]
        ok = (B.first_mismatch(B.canonical_rows(a), want["rows"], want["order_by"]) is None
              and b == count_rows)
        log("spmd", card=smi, scenario="overlapping", ms=(time.perf_counter() - t0) * 1e3,
            rows_equal=ok)
        if not ok:
            failures.append("overlapping queries: rows differ")
        # 3. a window query is not fusable: per-task scheduling
        local = LocalQueryRunner(device="cuda")
        want_rows, _ = local.execute(SPMD_WINDOW_SQL)
        t0 = time.perf_counter()
        got_rows, doc = _spmd_run(runner, SPMD_WINDOW_SQL)
        ms = (time.perf_counter() - t0) * 1e3
        tasks = _worker_task_count(runner)
        fell_back = "spmd" not in (doc.get("exchangeStats") or {})
        log("spmd", card=smi, scenario="window_falls_back", ms=ms,
            rows_equal=got_rows == want_rows, worker_tasks=tasks, ran_spmd=not fell_back)
        if got_rows != want_rows or not tasks or not fell_back:
            failures.append(f"window query: rows equal {got_rows == want_rows}, "
                            f"{tasks} worker tasks, spmd {not fell_back}")
        # 4. a lost peer: the next query falls back to tasks
        runner.kill_worker(SPMD_WORKERS - 1)
        dead = f"worker-{SPMD_WORKERS - 1}"
        deadline = time.time() + 60
        failed = False
        while time.time() < deadline and not failed:
            info = http_json(f"{runner.coordinator_uri}/v1/node").get("failureInfo", [])
            failed = any(n["nodeId"] == dead and n["failed"] for n in info)
            time.sleep(0.2)
        tiny = B.queries("tpch.tiny")[1]
        tiny_want = B.load_answers(
            B.ANSWERS_SF1.replace("tpch_sf1_answers", "tpch_tiny_answers"))["queries"]["1"]
        t0 = time.perf_counter()
        rows, doc = _spmd_run(runner, tiny)
        ms = (time.perf_counter() - t0) * 1e3
        ok = B.first_mismatch(B.canonical_rows(rows), tiny_want["rows"],
                              tiny_want["order_by"]) is None
        fell_back = "spmd" not in (doc.get("exchangeStats") or {})
        log("spmd", card=smi, scenario="lost_peer_falls_back", ms=ms, rows_equal=ok,
            ran_spmd=not fell_back, dead_node_failed=failed)
        if not ok or not fell_back:
            failures.append(f"after a lost peer: rows equal {ok}, spmd {not fell_back}")
    finally:
        runner.close()
    builds, procs = [], []
    for name in sorted(os.listdir(k2_dir)):
        with open(os.path.join(k2_dir, name)) as f:
            if name.startswith("k2."):
                builds.append((name.split(".")[1],
                               [json.loads(line) for line in f if line.strip()]))
            elif name.startswith("proc."):
                procs.append((name.split(".")[1], json.load(f)))
    rank_of = {c["pid"]: c["rank"] for c in checks}
    per_rank = {rank_of.get(pid, -1): len(bs) for pid, bs in builds}
    flat_builds = [b for _, bs in builds for b in bs]
    k2_err = max([max(b["max_abs_err"], b["unplaced_err"]) for b in flat_builds] or [0])
    log("spmd", card=smi, part="processes", k2_checked_builds_by_rank=per_rank,
        k2_max_abs_err=k2_err, peaks_by_rank={rank_of.get(pid): p["peak_bytes"]
                                              for pid, p in procs},
        seconds=time.perf_counter() - t_phase)
    shutil.rmtree(work, ignore_errors=True)
    if sorted(r for r, n in per_rank.items() if n) != list(range(1 + SPMD_WORKERS)):
        failures.append(f"K2 builds checked by rank {per_rank}: a process checked none")
    if k2_err:
        failures.append(f"a process's K2 build differs from plain (max |err| {k2_err})")
    if failures:
        raise AssertionError("spmd: " + "; ".join(failures))
    return launches, k2_err


VERIFY_SCHEMA = "sf1"     # phase verify's CTAS and its large queries
# the TPC-H queries it runs at VERIFY_SCHEMA, the others at tiny: the
# seven phase cluster ran at SF1 before phase spmd took three of them
# (the 22 at SF1 took the phase 119.13 s, past its ~90 s)
VERIFY_SF1_QUERIES = (1, 3, 5, 6, 9, 10, 18)
# the TPC-H queries that launch K2 at SF1 (phase tpch22, PERF.md §4)
VERIFY_K2_QUERIES = (2, 3, 5, 7, 8, 9, 10, 11, 12, 14, 15, 16, 17, 18, 19, 20, 21)
VERIFY_K1_SQL = ("select l_linenumber, sum(l_quantity), count(*) from memory.default.li1"
                 " group by l_linenumber")
VERIFY_MISSING_SQL = "select count(*) from tpch.tiny.no_such_table"


def verify_corpus(schema: str, large: tuple) -> dict:
    """Label -> statement of phase verify's first run: phase surface's
    CREATE TABLE AS of lineitem into ``memory.default.li1``, the K1 GROUP
    BY over it, and the 22 TPC-H queries, spec text, those of ``large`` at
    ``schema`` and the others at ``tpch.tiny``."""
    from trino_tpu_torch.benchmarks import tpch as B

    big, tiny = B.queries(f"tpch.{schema}"), B.queries("tpch.tiny")
    out = {"ctas": f"create table memory.default.li1 as select {SURFACE_LI1_COLUMNS}"
                   f" from tpch.{schema}.lineitem",
           "k1": VERIFY_K1_SQL}
    for q in sorted(big):
        out[f"Q{q}" + ("" if q in large else "_tiny")] = big[q] if q in large else tiny[q]
    return out


def phase_verify(smi: str, schema: str = VERIFY_SCHEMA, device: str = "cuda") -> tuple[dict, int, int]:
    """Phase ``verify``: the port's query verifier through its CLI entry,
    ``trino_tpu_torch.verifier.main``, in this process so that the kernel
    launches are counted. Three runs:

    1. control ``local`` (the interpreter), test ``distributed`` (the
       program path), both on the card, over :func:`verify_corpus`: main
       returns 0, the test side launches K1 on the GROUP BY and K2 on
       every query of ``VERIFY_K2_QUERIES`` run at ``schema``;
    2. control a port coordinator booted in this process on an engine of
       its own at an ephemeral port, with the port's lockdep installed
       first (``install(only_paths=(ROOT,))``), test ``distributed``, the
       22 queries at ``tpch.tiny``: main returns 0 and the lockdep's
       report is empty; then the lockdep is uninstalled;
    3. a statement on a missing table: counted as a failure, main
       returns 1.
    The verifier makes its own runners (``_runner_for``); the script wraps
    each to time a statement and count its launches, allocator peak and
    side. Every K1 launch and every K2 build that is no capture is held
    against its plain version on the same inputs. The counts start at 0
    before run 1 and are read after run 3. Any failed check raises.
    Returns the launches and the largest K1 and K2 differences."""
    import inspect
    import shutil
    import tempfile

    import torch

    from trino_tpu_torch import _kernels, verifier
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.lint import lockdep
    from trino_tpu_torch.ops import dense_groupby as DG
    from trino_tpu_torch.server.http import TrinoTpuServer

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    work = tempfile.mkdtemp(prefix="chip_smoke_verify_")
    state = {"run": None, "made": [], "labels": {}}
    calls, engines, k1_errs, builds, query = [], {}, [], [], [None]
    real_runner_for, real_dense = verifier._runner_for, DG.dense_groupby_device

    def checked_dense(plan, bins, vals):
        lt = real_dense(plan, bins, vals)
        if not (on_card and torch.cuda.is_current_stream_capturing()):
            k1_errs.append(int((lt - DG.dense_groupby_plain(plan, bins, vals)).abs().max()))
        return lt

    def runner_for(spec, device=None):
        run = real_runner_for(spec, device)
        side = ("control", "test")[len(state["made"])]
        state["made"].append(spec)
        runner = inspect.getclosurevars(run).nonlocals.get("r")
        if runner is not None:
            engines[(state["run"], side)] = runner.engine

        def counted(sql):
            label = state["labels"].get(sql.strip(), sql.strip()[:40])
            query[0] = f"{state['run']}:{side}:{label}"
            before = dict(_kernels.LAUNCHES)
            if on_card:
                reset_peak()
            t0 = time.perf_counter()
            try:
                return run(sql)
            finally:
                if on_card:
                    torch.cuda.synchronize()
                calls.append({
                    "run": state["run"], "side": side, "query": label,
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "k1": _kernels.LAUNCHES["dense_groupby"] - before["dense_groupby"],
                    "k2": _kernels.LAUNCHES["dense_join_build"] - before["dense_join_build"],
                    "peak_bytes": read_peak() if on_card else None,
                })
        return counted

    def main_over(run: str, control: str, statements: dict) -> int:
        state["run"], state["made"] = run, []
        state["labels"] = {sql.strip(): name for name, sql in statements.items()}
        path = os.path.join(work, f"{run}.sql")
        with open(path, "w") as f:
            f.write(";\n".join(statements.values()) + ";\n")
        t0 = time.perf_counter()
        rc = verifier.main(["--control", control, "--test", "distributed",
                            "--queries", path, "--device", device])
        log("verify", card=smi, run=run, control=control, test="distributed",
            statements=len(statements), rc=rc, run_s=time.perf_counter() - t0)
        return rc

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"verify: {what}")

    def pool_after(run: str) -> None:
        # one pool line a run, for its test engine; then the runners' engines go
        eng = engines.pop((run, "test"), None)
        engines.clear()
        if eng is not None:
            check_pool(eng, f"verify:{run}")
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    _kernels.reset_counts()
    verifier._runner_for = runner_for
    DG.dense_groupby_device = checked_dense
    server = None
    try:
        with k2_checked(builds, query):
            # 1. the interpreter against the program path, on the card
            rc1 = main_over("local", "local", verify_corpus(schema, VERIFY_SF1_QUERIES))
            pool_after("local")
            # 2. a coordinator of the port as control, under the port's lockdep
            lockdep.reset()
            check(lockdep.install(only_paths=(ROOT,)), "the lockdep was installed already")
            try:
                server = TrinoTpuServer(engine=Engine(device=device)).start()
                tiny = {f"Q{q}": sql for q, sql in B.queries("tpch.tiny").items()}
                rc2 = main_over("coordinator", server.base_uri, tiny)
                server.stop()
                server = None
                problems = lockdep.report()
            finally:
                if server is not None:
                    server.stop()
                lockdep.uninstall()
            pool_after("coordinator")
            # 3. a failing statement
            rc3 = main_over("missing", "local", {"missing": VERIFY_MISSING_SQL})
            pool_after("missing")
    finally:
        verifier._runner_for = real_runner_for
        DG.dense_groupby_device = real_dense
        shutil.rmtree(work, ignore_errors=True)
    launches = dict(_kernels.LAUNCHES)
    by_query = {}
    for c in calls:
        row = by_query.setdefault((c["run"], c["query"]), {"run": c["run"], "query": c["query"]})
        for k in ("ms", "k1", "k2", "peak_bytes"):
            row[f"{c['side']}_{k}"] = c[k]
    for row in by_query.values():
        log("verify", card=smi, **row)
    peaks = {}
    for c in calls:
        if c["peak_bytes"] is not None:
            key = f"{c['run']}:{c['side']}"
            peaks[key] = max(peaks.get(key, 0), c["peak_bytes"])
    k2_err = max([b["max_abs_err"] + b["unplaced_err"] for b in builds], default=0)
    k1_err = max(k1_errs, default=0)
    test1 = {c["query"]: c for c in calls if c["run"] == "local" and c["side"] == "test"}
    missing_k2 = [q for q in VERIFY_K2_QUERIES
                  if q in VERIFY_SF1_QUERIES and not test1.get(f"Q{q}", {}).get("k2")]
    log("verify", card=smi, k1_launches=launches["dense_groupby"],
        k2_launches=launches["dense_join_build"],
        test_k1_on_group_by=test1.get("k1", {}).get("k1"), k1_checked=len(k1_errs),
        k1_max_abs_err=k1_err, k2_checked_builds=len(builds), k2_max_abs_err=k2_err,
        allocator_peak_bytes=peaks, lockdep_report=len(problems), rcs=[rc1, rc2, rc3],
        phase_s=time.perf_counter() - t_phase)
    check(rc1 == 0, f"local against distributed: main returned {rc1}")
    check(rc2 == 0, f"the coordinator against distributed: main returned {rc2}")
    check(rc3 == 1, f"the missing table: main returned {rc3}, not 1")
    check(not problems, "the lockdep found problems:\n" + "\n\n".join(problems))
    check(test1.get("k1", {}).get("k1", 0) >= 1, "the GROUP BY over li1 launched no K1 on the test side")
    check(not missing_k2, f"no K2 launch on the test side of Q{missing_k2}")
    check(len(k1_errs) >= 1 and not k1_err, f"K1 differs from plain: {k1_errs}")
    check(bool(builds) and not k2_err, f"K2 differs from plain by {k2_err} ({len(builds)} builds)")
    missing = [c for c in calls if c["run"] == "missing"]
    check(len(missing) == 1, f"the missing table ran {len(missing)} times")
    return launches, k1_err, k2_err


def phase_spill_alone(smi: str) -> None:
    """Phase ``spill`` on its own: the SF10 tables and their oracle, the
    memory tables of phase ``join``, then the spilled runs."""
    from trino_tpu_torch.testing import LocalQueryRunner

    t0 = time.perf_counter()
    tables = tpch_tables(SF, seed=7)
    oracle = tpch_oracle(tables)
    log("tpch", sf=SF, generate_and_oracle_s=time.perf_counter() - t0)
    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    load_tpch(runner, tables)
    phase_spill(runner, oracle, smi)


def phase_spmd_alone(smi: str) -> None:
    """Phase ``spmd`` on its own: the staged SF1 tables for its one-process
    mesh comparison first (:func:`spmd_mesh_reference`), released before
    the group boots."""
    import torch

    runner = tpch_sf1_runner(smi)
    spmd_mesh_reference(smi, runner)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    phase_spmd(smi)


def phase_mesh_alone(smi: str) -> None:
    """Phase ``mesh`` on its own: the SF10 tables and their oracle in
    memory tables, its SF10 part, then the staged SF1 tables and its SF1
    part."""
    from trino_tpu_torch.testing import LocalQueryRunner

    tables = tpch_tables(SF, seed=7)
    oracle = tpch_oracle(tables)
    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    load_tpch(runner, tables)
    phase_mesh_join(runner, oracle, smi)
    del runner, tables, oracle
    gc.collect()
    import torch

    torch.cuda.empty_cache()
    phase_mesh(smi, tpch_sf1_runner(smi))


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--cluster-process":
        return cluster_process(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import trino_tpu_torch  # noqa: F401
    except ImportError:
        # the script alone, without its repository: nothing to run
        print("chip_smoke: the trino_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 3
    t_run = time.perf_counter()
    smi = phase_device()
    # each phase's wall seconds (a lap ends where the next phase starts)
    laps: dict = {}
    t_lap = [t_run]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        # a part of the script, for work on one phase: no result lines
        for name in sys.argv[2].split(","):
            {"tpch22": lambda smi: phase_tpch22(smi, tpch_sf1_runner(smi)),
             "programs": lambda smi: phase_programs(smi, tpch_sf1_runner(smi)),
             "surface": lambda smi: phase_surface(smi, tpch_sf1_runner(smi)),
             "files": lambda smi: phase_files(smi, tpch_sf1_runner(smi)),
             "server": lambda smi: phase_server(smi, tpch_sf1_runner(smi)),
             "obs": lambda smi: phase_obs(smi, tpch_sf1_runner(smi)),
             "tpcds": phase_tpcds, "spill": phase_spill_alone,
             "mesh": phase_mesh_alone,
             "mesh_sf1": lambda smi: phase_mesh(smi, tpch_sf1_runner(smi)),
             "cluster": phase_cluster,
             "spmd": phase_spmd_alone,
             "verify": phase_verify}[name](smi)
            gc.collect()
            torch.cuda.empty_cache()
        return 0
    kern = phase_kernel()
    lap("device+kernel")
    t0 = time.perf_counter()
    tables = tpch_tables(SF, seed=7)
    oracle = tpch_oracle(tables)
    log("tpch", sf=SF, rows={t: len(next(iter(c.values()))) for t, c in tables.items()},
        generate_and_oracle_s=time.perf_counter() - t0)
    k2 = phase_k2(tables)
    lap("tables+k2")
    sql_launches = phase_sql()
    if sql_launches["dense_groupby"] < 1:
        raise AssertionError("the group-by path launched no dense group-by kernel")
    lap("sql")
    join_launches, join_k2_err, join_runner = phase_join(tables, oracle)
    lap("join")
    if join_launches["dense_join_build"] < 1:
        raise AssertionError("the join path launched no join-build kernel")
    check_pool(join_runner.engine, "join")
    spill_launches = phase_spill(join_runner, oracle, smi)
    lap("spill")
    check_pool(join_runner.engine, "spill")
    mesh_join_launches, mesh_join_k2_err = phase_mesh_join(join_runner, oracle, smi)
    lap("mesh_sf10")
    # release the join phase's tables and device memory first
    del tables, oracle, join_runner
    gc.collect()
    torch.cuda.empty_cache()
    tpch_launches = phase_tpch(smi)
    lap("tpch")
    gc.collect()
    torch.cuda.empty_cache()
    sf1_runner = tpch_sf1_runner(smi)
    t22, t22_k2_err = phase_tpch22(smi, sf1_runner)
    lap("tpch22")
    check_pool(sf1_runner.engine, "tpch22")
    if t22["dense_join_build"] < 1:
        raise AssertionError("the TPC-H queries launched no join-build kernel")
    progs, progs_k2_err = phase_programs(smi, sf1_runner)
    lap("programs")
    check_pool(sf1_runner.engine, "programs")
    if progs["dense_join_build"] < 1:
        raise AssertionError("the programs launched no join-build kernel")
    served, served_k1_err, served_k2_err = phase_server(smi, sf1_runner)
    lap("server")
    check_pool(sf1_runner.engine, "server")
    observed, obs_k1_err, obs_k2_err = phase_obs(smi, sf1_runner)
    lap("obs")
    check_pool(sf1_runner.engine, "obs")
    surface, surface_k1_err, surface_k2_err = phase_surface(smi, sf1_runner)
    lap("surface")
    check_pool(sf1_runner.engine, "surface")
    gc.collect()
    torch.cuda.empty_cache()
    files, files_k2_err = phase_files(smi, sf1_runner)
    lap("files")
    check_pool(sf1_runner.engine, "files")
    gc.collect()
    torch.cuda.empty_cache()
    mesh, mesh_k2_err = phase_mesh(smi, sf1_runner)
    spmd_mesh_reference(smi, sf1_runner)
    lap("mesh_sf1")
    del sf1_runner
    gc.collect()
    torch.cuda.empty_cache()
    clustered, cluster_k2_err = phase_cluster(smi)
    lap("cluster")
    gc.collect()
    torch.cuda.empty_cache()
    spmd, spmd_k2_err = phase_spmd(smi)
    lap("spmd")
    gc.collect()
    torch.cuda.empty_cache()
    ds, ds_k2_err = phase_tpcds(smi)
    lap("tpcds")
    gc.collect()
    torch.cuda.empty_cache()
    verified, verify_k1_err, verify_k2_err = phase_verify(smi)
    lap("verify")
    a, ka = kern["a"], k2["a"]
    log("run", card=smi, seconds=time.perf_counter() - t_run, phase_seconds=laps)
    print(json.dumps({"kernels": [{
        "name": "dense_groupby",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/dense_groupby.cu",
        "replaces": "trino_tpu/ops/dense_groupby.py:229",
        "launches": (sql_launches["dense_groupby"] + join_launches["dense_groupby"]
                     + spill_launches["dense_groupby"] + tpch_launches
                     + t22["dense_groupby"] + progs["dense_groupby"]
                     + surface["dense_groupby"] + served["dense_groupby"]
                     + observed["dense_groupby"]
                     + files["dense_groupby"] + ds["dense_groupby"]
                     + mesh_join_launches["dense_groupby"] + mesh["dense_groupby"]
                     + clustered.get("dense_groupby", 0) + verified["dense_groupby"]),
        "matches_plain": True,
        "max_abs_err": max(kern["max_abs_err"], surface_k1_err, served_k1_err, obs_k1_err,
                           verify_k1_err),
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
        "launches": (join_launches["dense_join_build"] + spill_launches["dense_join_build"]
                     + t22["dense_join_build"] + progs["dense_join_build"]
                     + surface["dense_join_build"] + served["dense_join_build"]
                     + observed["dense_join_build"]
                     + files["dense_join_build"] + ds["dense_join_build"]
                     + mesh_join_launches["dense_join_build"] + mesh["dense_join_build"]
                     + clustered["dense_join_build"] + spmd["dense_join_build"]
                     + verified["dense_join_build"]),
        "matches_plain": True,
        "max_abs_err": max([p["max_abs_err"] for p in k2.values()]
                           + [join_k2_err, t22_k2_err, progs_k2_err, surface_k2_err,
                              served_k2_err, obs_k2_err, files_k2_err,
                              ds_k2_err, mesh_join_k2_err, mesh_k2_err, cluster_k2_err,
                              spmd_k2_err, verify_k2_err]),
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
