"""SPMD across server processes through trino_tpu_torch, on the CPU.

``trino_tpu_torch/parallel/spmd.py``: every process of a gloo group holds
one shard of a mesh that spans the processes, and each fusable query runs
as the same fragment programs on every process, its collectives crossing
processes (``parallel/transport.py``). Three levels, each against the
one-process mesh of as many shards or the reference:

- the collectives and exchanges on 2 and 3 processes equal the
  one-process mesh's outputs exactly (``tests/torch_spmd_workers.py``);
- TPC-H Q1 (also streamed), Q3, Q5 and Q10 at ``tpch.tiny`` through
  ``SpmdRunner._execute`` on three processes equal the one-process
  three-shard mesh in rows and exchange counters, and the reference's
  ``LocalQueryRunner`` in rows; the host words the processes read before
  their reduction differ, so the reduction decides;
- the seven cases of ``tests/test_spmd.py`` through the port's HTTP
  cluster (``MultiProcessQueryRunner(spmd=True)``).

Every group's collectives run under a 60 s deadline (the cluster's under
120 s), so processes that disagree fail the case instead of holding the
run.
"""

import os
import socket
import threading
import time

import pytest
import torch

import torch_spmd_workers as W

Q1 = """select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
              sum(l_extendedprice) as sum_base_price,
              avg(l_quantity) as avg_qty, count(*) as count_order
       from lineitem where l_shipdate <= date '1998-09-02'
       group by l_returnflag, l_linestatus
       order by l_returnflag, l_linestatus"""

Q3 = """select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
              o_orderdate, o_shippriority
       from customer, orders, lineitem
       where c_mktsegment = 'BUILDING'
         and c_custkey = o_custkey and l_orderkey = o_orderkey
         and o_orderdate < date '1995-03-15'
         and l_shipdate > date '1995-03-15'
       group by l_orderkey, o_orderdate, o_shippriority
       order by revenue desc, o_orderdate limit 10"""

Q5 = """select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
       from customer, orders, lineitem, supplier, nation, region
       where c_custkey = o_custkey and l_orderkey = o_orderkey
         and l_suppkey = s_suppkey and c_nationkey = s_nationkey
         and s_nationkey = n_nationkey and n_regionkey = r_regionkey
         and r_name = 'ASIA'
         and o_orderdate >= date '1994-01-01'
         and o_orderdate < date '1995-01-01'
       group by n_name order by revenue desc"""

Q10 = """select c_custkey, c_name,
               sum(l_extendedprice * (1 - l_discount)) as revenue, c_acctbal
       from customer, orders, lineitem, nation
       where c_custkey = o_custkey and l_orderkey = o_orderkey
         and o_orderdate >= date '1993-10-01'
         and o_orderdate < date '1994-01-01'
         and l_returnflag = 'R' and c_nationkey = n_nationkey
       group by c_custkey, c_name, c_acctbal
       order by revenue desc limit 20"""

GROUP_DEADLINE_S = 300.0


def _group(world: int, case: str, outdir) -> list:
    """``case`` of ``torch_spmd_workers`` on ``world`` spawned processes
    of one gloo group; each rank's saved results."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(W.run, args=(world, port, str(outdir), case), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.time() + GROUP_DEADLINE_S
    try:
        while not ctx.join(timeout=2):
            assert time.time() < deadline, f"the {case} group outlived its deadline"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
    for r, out in enumerate(outs):
        assert "error" not in out, f"rank {r}: {out['error']}"
    return outs


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_equal_the_one_process_mesh(world, tmp_path):
    """all_to_all, all_gather, psum, pmax, the sketch, hash and two-tier
    (plain, detecting, replicating) repartitions, their exact sizing and
    the build broadcast on ``world`` gloo processes, one shard each,
    against the one-process mesh of ``world`` shards on the same seeded
    input: equal exactly, each rank holding its shard of a sharded output
    and all of a replicated one."""
    outs = _group(world, "collectives", tmp_path)
    for r, out in enumerate(outs):
        assert out["transport"] == {"transport": "gloo", "rank": r, "world": world}
        assert len(out["pairs"]) >= 40
        for name, got, want in out["pairs"]:
            assert got.shape == want.shape and got.dtype == want.dtype, (r, name)
            assert bool((got == want).all()), (r, name, got, want)
        assert out["stats"]["collectives"] > 0


@pytest.fixture(scope="module")
def ref_local():
    from trino_tpu.testing import LocalQueryRunner as RefRunner

    return RefRunner()


def test_tpch_through_the_runner_equals_the_one_process_mesh(tmp_path, ref_local):
    """TPC-H Q1 (materialized and streamed), Q3, Q5 and Q10 at tiny through
    ``SpmdRunner._execute`` on three processes: every process's rows equal
    the one-process three-shard mesh's and the reference's, its
    ``exchanges``, ``shuffle_rows`` and ``padded_shuffle_rows`` the mesh's;
    each process read host words that differ from another's before their
    reduction (its own shard's flags, counts and counters)."""
    from trino_tpu_torch.benchmarks import tpch as B

    outs = _group(3, "queries", tmp_path)
    texts = B.queries("tpch.tiny")
    for name, q in (("Q1", 1), ("Q1s", 1), ("Q3", 3), ("Q5", 5), ("Q10", 10)):
        one = outs[0]["queries"][name]["one_process"]
        ref_rows, _ = ref_local.execute(texts[q])
        assert one["rows"] == ref_rows, name
        for r, out in enumerate(outs):
            got = out["queries"][name]
            assert got["rows"] == one["rows"], (name, r)
            for key in ("exchanges", "shuffle_rows", "padded_shuffle_rows"):
                assert got["stats"]["exchange"][key] == one["exchange"][key], (name, r, key)
            assert got["stats"]["rank"] == r
            assert got["stats"]["transport"]["host_reductions"] > 0
        if name == "Q1s":
            assert one["modes"][max(one["modes"])] == "streamed"
    words = [out["local_words"] for out in outs]
    assert all(len(w) == len(words[0]) for w in words)
    assert any(words[0][i] != words[r][i] for r in (1, 2) for i in range(len(words[0])))


# --- the seven cases of tests/test_spmd.py through the HTTP cluster ----------


@pytest.fixture(scope="module")
def spmd_cluster():
    from trino_tpu_torch.testing import MultiProcessQueryRunner

    with MultiProcessQueryRunner(n_workers=2, device="cpu", spmd=True) as runner:
        yield runner


def check(cluster, local, sql):
    crows, _ = cluster.execute(sql)
    lrows, _ = local.execute(sql)
    assert crows == lrows, (
        f"spmd != local for {sql}\nspmd: {crows[:5]}\nlocal: {lrows[:5]}"
    )


class TestSpmdQueries:
    def test_tpch_q1_q3_q5_q10(self, spmd_cluster, ref_local):
        """The reference's ``test_q1``, ``test_q3``, ``test_q5`` and
        ``test_q10`` in one case, so that the module's cluster boots in
        fewer xdist workers."""
        for sql in (Q1, Q3, Q5, Q10):
            check(spmd_cluster, ref_local, sql)

    def test_ran_spmd_not_tasks(self, spmd_cluster, ref_local):
        """Fusable queries run SPMD: no per-task HTTP scheduling, no worker
        task registry entries, and the query's document has every
        process's run."""
        from torch_cluster_fixtures import get_json

        sql = "select count(*), sum(l_quantity) as ran_spmd from lineitem"
        check(spmd_cluster, ref_local, sql)
        for uri in spmd_cluster.worker_uris:
            assert get_json(uri, "/v1/task") == [], uri
        (info,) = [q for q in get_json(spmd_cluster.coordinator_uri, "/v1/query")
                   if "ran_spmd" in q["query"]]
        doc = get_json(spmd_cluster.coordinator_uri, f"/v1/query/{info['queryId']}")
        spmd = doc["exchangeStats"]["spmd"]
        assert spmd["processes"] == 3
        assert [w["rank"] for w in spmd["workers"]] == [1, 2]
        assert spmd["coordinator"]["transport"]["transport"] == "gloo"

    def test_nonfusable_falls_back_to_tasks(self, spmd_cluster, ref_local):
        """Window functions aren't fusable: the query still succeeds via
        per-task cluster scheduling."""
        sql = (
            "select o_orderstatus, rank() over "
            "(partition by o_orderstatus order by o_totalprice desc) as rnk "
            "from orders order by o_orderstatus, rnk limit 5"
        )
        check(spmd_cluster, ref_local, sql)

    def test_two_overlapping_queries(self, spmd_cluster, ref_local):
        """Two SPMD queries submitted concurrently both complete (the
        two-phase protocol serializes only the run order)."""
        sqls = [Q1, "select count(*), sum(l_quantity) from lineitem"]
        results: dict = {}

        def run(i, sql):
            try:
                results[i] = spmd_cluster.execute(sql)
            except Exception as e:  # noqa: BLE001
                results[i] = e

        ts = [threading.Thread(target=run, args=(i, s)) for i, s in enumerate(sqls)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        for i, sql in enumerate(sqls):
            assert not isinstance(results[i], Exception), results[i]
            crows, _ = results[i]
            lrows, _ = ref_local.execute(sql)
            assert crows == lrows, f"overlapped query {i} diverged"


class TestSpmdRecovery:
    def test_lost_peer_falls_back(self):
        """A peer that vanishes is detected at the PREPARE round trip and
        the query falls back to per-task scheduling; the aborted slot
        advanced the sequence."""
        from trino_tpu_torch.config import Session
        from trino_tpu_torch.parallel.spmd import SpmdRunner, SpmdUnsupported
        from trino_tpu_torch.testing import LocalQueryRunner

        runner = LocalQueryRunner(device="cpu")
        spmd = SpmdRunner.__new__(SpmdRunner)  # no process group needed
        spmd.engine = runner.engine
        spmd.process_count = 2
        spmd._seq_lock = threading.Lock()
        spmd._seq = 0
        spmd._done_seq = -1
        spmd._cond = threading.Condition()
        spmd._pending = {}
        plan = runner.plan("select count(*) from tpch.tiny.region")
        with pytest.raises(SpmdUnsupported, match="peer unavailable"):
            spmd.execute(plan, Session(), ["http://127.0.0.1:1"])  # dead peer
        # a later slot is not head-of-line blocked behind the aborted one
        assert spmd._done_seq == 0
