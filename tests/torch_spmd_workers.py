"""Process bodies of ``tests/test_torch_spmd.py``: each rank of a gloo
group on the CPU runs one of these (``torch.multiprocessing`` with the
spawn start method) and writes what it computed, beside the one-process
mesh's answer on the same inputs, to ``<outdir>/rank<r>.pt``. Not a test
file."""

from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch

# one collective's deadline inside a test group: a rank that diverges
# fails its peers within it
TIMEOUT_S = 60.0


def _join(rank: int, world: int, port: int):
    import torch.distributed as dist

    from trino_tpu_torch.parallel import transport as TR

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    TR.install(TR.open_transport("cpu"))
    return TR.current()


def _leave():
    import torch.distributed as dist

    from trino_tpu_torch.parallel import transport as TR

    TR.install(None)
    dist.destroy_process_group()


def run(rank: int, world: int, port: int, outdir: str, case: str) -> None:
    """The rank's body: join, run ``case``, save its results (or its
    error) for the parent to compare."""
    out: dict = {}
    try:
        _join(rank, world, port)
        out = {"collectives": _collectives, "queries": _queries}[case](rank, world)
    except BaseException:  # noqa: BLE001 — the parent reports it
        out = {"error": traceback.format_exc()}
    finally:
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
        try:
            _leave()
        except Exception:  # noqa: BLE001
            pass


def _local(x: torch.Tensor, world: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of a one-process shard-major tensor."""
    per = x.shape[0] // world
    return x[rank * per:(rank + 1) * per]


def skewed_input(n: int, m_per: int, seed: int):
    """``tests/test_torch_mesh.py::_skewed_input``: hashes with three hot
    keys at distinct counts above unique ones, some rows dead."""
    rng = np.random.default_rng(seed)
    m = n * m_per
    khash = rng.integers(-(1 << 62), 1 << 62, m).astype(np.int64)
    pick = rng.random(m)
    khash[pick < 0.30] = 1000
    khash[(pick >= 0.30) & (pick < 0.45)] = -77
    khash[(pick >= 0.45) & (pick < 0.55)] = 5
    sel = rng.random(m) < 0.9
    cols = [
        rng.integers(-(1 << 40), 1 << 40, m).astype(np.int64),
        rng.random(m) < 0.8,
        rng.integers(-(1 << 30), 1 << 30, m).astype(np.int32),
        rng.standard_normal(m),
    ]
    return khash, sel, cols


def _collectives(rank: int, world: int) -> dict:
    """Every collective and exchange of the mesh over ``world`` processes
    (one shard each) against the one-process mesh of ``world`` shards:
    ``(name, spmd, one_process)`` pairs, the one-process side cut to this
    rank's shard where the output is sharded."""
    from trino_tpu_torch.ops import skew as SK
    from trino_tpu_torch.parallel import exchange as X
    from trino_tpu_torch.parallel import mesh as M
    from trino_tpu_torch.parallel import transport as TR

    spmd = M.make_mesh(device="cpu")
    one = M.make_mesh(world, "cpu")
    assert spmd.spans and spmd.size == world and spmd.rank == rank and spmd.local == 1
    pairs = []
    rng = np.random.default_rng(11)
    blocks = torch.from_numpy(rng.integers(-1000, 1000, (world, world, 5, 2)))
    pairs.append(("all_to_all", M.all_to_all(blocks[rank:rank + 1], spmd),
                  M.all_to_all(blocks)[rank:rank + 1]))
    parts = torch.from_numpy(rng.standard_normal((world, 7)))
    pairs.append(("all_gather", M.all_gather(parts[rank:rank + 1], spmd), M.all_gather(parts)))
    vals = torch.from_numpy(rng.integers(0, 1 << 40, (world, 3)))
    pairs.append(("psum", M.psum(vals[rank:rank + 1], spmd), M.psum(vals)))
    pairs.append(("pmax", M.pmax(vals[rank:rank + 1], spmd), M.pmax(vals)))
    # a lane of a packed state: one row whose stride is its parent's width
    lanes = torch.from_numpy(rng.integers(0, 1 << 40, (world, 5)))
    pairs.append(("psum.strided", M.psum(lanes[rank:rank + 1, 1], spmd), M.psum(lanes[:, 1])))
    pairs.append(("all_gather.strided", M.all_gather(lanes[rank:rank + 1, 1:2], spmd),
                  M.all_gather(lanes[:, 1:2])))

    khash, sel, cols = skewed_input(world, 257, seed=3 + world)
    kt, st = torch.from_numpy(khash), torch.from_numpy(sel)
    ct = [torch.from_numpy(c) for c in cols]

    def mine(x):
        return _local(x, world, rank)

    # the sketch: the hot set every process sees
    p = SK.hot_key_hashes(spmd, mine(kt), mine(st), 3, 0.5)
    o = SK.hot_key_hashes(one, kt, st, 3, 0.5)
    for i, nm in enumerate(("hot_hashes", "hot_valid", "n_hot", "total")):
        pairs.append((f"hot_key_sketch.{nm}", p[i], o[i]))
    # hash repartition at the exact bucket
    bucket = X.needed_bucket(one, kt, st)
    pairs.append(("needed_bucket", torch.tensor(X.needed_bucket(spmd, mine(kt), mine(st))),
                  torch.tensor(bucket)))
    pout, psel, povf = X.hash_repartition(spmd, [mine(c) for c in ct], mine(kt), mine(st),
                                          bucket)
    oout, osel, oovf = X.hash_repartition(one, ct, kt, st, bucket)
    for j, (a, b) in enumerate(zip(pout, oout)):
        pairs.append((f"hash_repartition.col{j}", a, mine(b)))
    pairs += [("hash_repartition.sel", psel, mine(osel)), ("hash_repartition.ovf", povf, oovf)]
    # the two-tier exchange in its three skew modes
    hh, hv = o[0], o[1]
    for mode, kw in (("plain", {}),
                     ("detect", {"hot_mode": "local", "hot_cap": 64, "detect": (3, 0.5)}),
                     ("replicate", {"hot_mode": "replicate", "hot_cap": 64,
                                    "hot_set": (hh, hv)})):
        pr = X.skewed_repartition(spmd, [mine(c) for c in ct], mine(kt), mine(st), 8, 64, **kw)
        orr = X.skewed_repartition(one, ct, kt, st, 8, 64, **kw)
        for j, (a, b) in enumerate(zip(pr[0], orr[0])):
            pairs.append((f"skewed.{mode}.col{j}", a, mine(b)))
        pairs.append((f"skewed.{mode}.sel", pr[1], mine(orr[1])))
        for j, (a, b) in enumerate(zip(pr[2], orr[2])):
            pairs.append((f"skewed.{mode}.flag{j}", a, b))
        for j, (a, b) in enumerate(zip(pr[3], orr[3])):
            pairs.append((f"skewed.{mode}.counter{j}", a, b))
        for j, (a, b) in enumerate(zip(pr[4], orr[4])):
            pairs.append((f"skewed.{mode}.hotset{j}", a, b))
    counts = X.skew_split_counts(one, kt, st, hh, hv)
    pairs.append(("skew_split_counts",
                  torch.tensor(X.skew_split_counts(spmd, mine(kt), mine(st), hh, hv)),
                  torch.tensor(counts)))
    # build-side broadcast: every process sees the whole side
    rep, rsel = X.broadcast_all(spmd, [mine(ct[0])], mine(st))
    orep, orsel = X.broadcast_all(one, [ct[0]], st)
    pairs += [("broadcast_all.col", rep[0], orep[0]), ("broadcast_all.sel", rsel, orsel)]
    return {"pairs": pairs, "transport": TR.current().describe(),
            "stats": dict(TR.current().stats)}


QUERY_PROPS = {
    # Q1 streamed: lineitem past the threshold streams one part a shard
    "Q1s": {"stream_scan_threshold_rows": 1 << 14, "stream_device_chunk_rows": 1 << 16},
}


def _queries(rank: int, world: int) -> dict:
    """TPC-H Q1, Q3, Q5 and Q10 at ``tpch.tiny`` through
    ``SpmdRunner._execute`` on this process, each beside the one-process
    mesh of ``world`` shards (rank 0 runs it); the host words each
    process read before their reduction are kept, to show they differ."""
    from trino_tpu_torch.benchmarks import tpch as B
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.parallel import mesh as M
    from trino_tpu_torch.parallel.spmd import SpmdRunner
    from trino_tpu_torch.sql import parse_statement
    from trino_tpu_torch.testing import DistributedQueryRunner

    seen: list = []
    real = M.Mesh.reduce_host

    def recording(self, values, ops):
        seen.append(list(values))
        return real(self, values, ops)

    M.Mesh.reduce_host = recording
    texts = B.queries("tpch.tiny")
    engine = Engine(device="cpu")
    runner = SpmdRunner(engine)
    out: dict = {"queries": {}, "local_words": seen}
    for name, q in (("Q1", 1), ("Q1s", 1), ("Q3", 3), ("Q5", 5), ("Q10", 10)):
        session = Session()
        for k, v in QUERY_PROPS.get(name, {}).items():
            session.set(k, v)
        plan = engine.plan(parse_statement(texts[q]), session)
        stats: dict = {}
        batch, names = runner._execute(plan, session, stats)
        got = {"rows": batch.to_pylist(), "names": names, "stats": stats}
        if rank == 0:
            ref = DistributedQueryRunner(n_devices=world, device="cpu")
            for k, v in QUERY_PROPS.get(name, {}).items():
                ref.session.set(k, v)
            res = ref.engine.execute_statement(texts[q], ref.session)
            got["one_process"] = {"rows": res.rows, "exchange": res.exchange_stats,
                                  "modes": res.fragment_modes}
        out["queries"][name] = got
    M.Mesh.reduce_host = real
    return out
