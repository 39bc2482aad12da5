"""trino_tpu_torch stands alone: no JAX, nothing of trino_tpu, no pyarrow,
and no silent fallback to the CPU.

The import check runs in a fresh interpreter so that this test process's
own JAX import (tests/conftest.py) cannot mask a leak.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_reference():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import trino_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            trino_tpu_torch.__path__, "trino_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # the GPU smoke script: torch only, too
        leaked = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith("jax.")
            or m == "jaxlib" or m.startswith("jaxlib.")
            or m == "trino_tpu" or m.startswith("trino_tpu.")
            or m == "pyarrow" or m.startswith("pyarrow.")
        )
        print(",".join(names))
        print(",".join(leaked))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names, leaked = out.stdout.splitlines()[-2:]
    names = names.split(",")
    assert len(names) >= 20  # every module of the package was imported
    for module in ("connectors.tpch", "connectors.dbgen", "benchmarks.tpch",
                   "ops.decimal128", "exec.streaming", "native", "strings",
                   "connectors.tpcds", "benchmarks.tpcds", "ops.window",
                   "ingest", "memory", "spill", "security", "transaction",
                   "stats", "datetimefmt", "connectors.blackhole", "serde",
                   "formats.parquet", "formats.orc", "connectors.parquet",
                   "connectors.orc", "connectors.file", "connectors.synthetic",
                   "connectors.diskcache", "planner.serde", "planner.canonicalize",
                   "events", "connectors.system", "exec.batching", "exec.programs",
                   "parallel.mesh", "parallel.exchange", "parallel.distributed",
                   "ops.skew", "ft.retry", "obs.trace", "obs.metrics",
                   "server.statemachine", "server.auth", "server.webui",
                   "server.eventloop", "server.resourcegroups", "server.querymanager",
                   "server.http", "server.main", "client", "cli", "dbapi",
                   "obs.history", "obs.slo", "obs.flight", "obs.profiler",
                   "cache", "cache.result_cache", "ft.injection",
                   "server.failuredetector", "server.task", "server.cluster",
                   "exchange", "exchange.spool", "testing", "lint", "lint.cli",
                   "lint.jit_safety", "lint.concurrency", "lint.obs_metrics",
                   "lint.lockdep", "verifier", "parallel.spmd", "parallel.transport"):
        assert f"trino_tpu_torch.{module}" in names
    assert leaked == ""


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_cuda_and_raises_without_it(no_cuda):
    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.testing import LocalQueryRunner

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalQueryRunner()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(device="cuda")
    assert Engine(device="cpu").device == torch.device("cpu")
    assert LocalQueryRunner(device="cpu").engine.device.type == "cpu"


def test_kernel_wrapper_never_falls_back_for_cuda_tensors():
    """A CUDA tensor goes to the kernel or raises; only CPU tensors take
    the plain version. Here that shows as: a non-CPU, non-CUDA tensor is
    refused rather than run on the host."""
    from trino_tpu_torch.ops import dense_groupby as D

    plan = D.DensePlan(G=128, cols=(D.DenseCol(True, 8),), pair128=(False,))
    bins = torch.zeros(16, dtype=torch.int32, device="meta")
    vals = [torch.zeros(16, dtype=torch.int64, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        D.dense_groupby_device(plan, bins, vals)


def test_port_reads_and_builds_no_source_of_the_reference(tmp_path):
    """The port builds its native library from its own
    ``trino_tpu_torch/csrc/columnar.cpp``: in a fresh interpreter, a build
    into an empty directory, the dictionary encoder, the text-pool
    generator (its first 64 KiB) and the codecs open no file under
    ``native/`` or ``trino_tpu/`` and pass none to the compiler (an audit
    hook sees every open and every process start)."""
    code = textwrap.dedent(
        f"""
        import sys
        seen = []
        def hook(event, args):
            if event == "open" and isinstance(args[0], str):
                seen.append(args[0])
            elif event == "subprocess.Popen":
                seen.extend(str(a) for a in args[1])
        sys.addaudithook(hook)
        from pathlib import Path
        from trino_tpu_torch import native
        from trino_tpu_torch.connectors import dbgen
        native.BUILD_DIR = Path({str(tmp_path)!r}) / "native"
        native.load()
        native.dict_encode(["a", "b", "a"])
        native.tpch_textpool(1 << 16, dbgen.dists_blob(), dbgen.S_TEXT_POOL)
        import numpy as np
        vals = np.arange(100) % 7
        native.varint_decode(native.varint_encode(vals), 100)
        native.lz_decompress(native.lz_compress(b"abcabcabc" * 9), 81)
        native.snappy_decompress(native.snappy_compress(b"xy" * 40), 80)
        native.orc_rle2(native.orc_rle2_encode(vals, True), 100, True)
        native.parquet_rle_decode(native.parquet_rle_encode(vals, 3), 3, 100)
        native.pack_arena([vals])
        print(native.SRC)
        print("\\n".join(seen))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    src, *paths = out.stdout.splitlines()
    assert src == os.path.join(REPO, "trino_tpu_torch", "csrc", "columnar.cpp")
    assert src in paths  # the build read it
    forbidden = (os.path.join(REPO, "native") + os.sep,
                 os.path.join(REPO, "trino_tpu") + os.sep)
    assert not [p for p in paths if os.path.abspath(p).startswith(forbidden)]


# reference handlers and plan-node executors with no counterpart of the
# same name in the port, each with the reason and the ROADMAP item
NOT_PORTED = {
    # the reference's spilled operators re-enter ``_exec`` through a
    # ``_FixedNode`` wrapping their materialized input; the port's spill
    # (ROADMAP item 5) calls the operators on the partitions' batches
    "_exec__fixednode": "item 5: internal to the reference's spill path",
}


def test_every_reference_handler_and_executor_has_a_counterpart():
    """Every ``_do_*`` method of the reference's ``Engine`` and every
    ``_exec_*`` method of its ``LocalExecutor`` exists in the port, but
    the named exceptions."""
    from trino_tpu.engine import Engine as RefEngine
    from trino_tpu.exec.local import LocalExecutor as RefExecutor
    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.exec.local import LocalExecutor

    missing = []
    for ref, port, prefix in ((RefEngine, Engine, "_do_"),
                              (RefExecutor, LocalExecutor, "_exec_")):
        names = [n for n in dir(ref) if n.startswith(prefix)]
        assert len(names) > 10
        missing += [n for n in names if not hasattr(port, n)]
    assert sorted(missing) == sorted(NOT_PORTED)


# the program tier's modules and their reference counterparts; the port's
# program (a CUDA graph of a unit's device work, exec/programs.py) has its
# own module, where the reference's program is a jitted function kept in
# trino_tpu/exec/fragments.py
PROGRAM_TIER = {
    "planner/serde.py": "trino_tpu/planner/serde.py",
    "planner/canonicalize.py": "trino_tpu/planner/canonicalize.py",
    "events.py": "trino_tpu/events.py",
    "connectors/system.py": "trino_tpu/connectors/system.py",
    "exec/batching.py": "trino_tpu/exec/batching.py",
    "exec/programs.py": None,
}

# the reference FragmentedExecutor's run methods whose work the port does
# under another name: its spans (obs/trace.py) are not ported, and its
# batched K-unrolled programs are K replays of the one program here
RUN_METHOD_COUNTERPARTS = {
    "_run_fragment_spanned": "_run_fragment",
    "_run_fragment_batched": "execute_batched",
    "_run_fused_unit_batched": "execute_batched",
    "run_fragment_program_batched": "_replay_batch",
    "run_fused_program_batched": "_replay_batch",
}


def test_program_tier_modules_map_to_the_reference():
    for port, ref in PROGRAM_TIER.items():
        assert os.path.exists(os.path.join(REPO, "trino_tpu_torch", port)), port
        if ref is not None:
            assert os.path.exists(os.path.join(REPO, ref)), ref


# the N-shard mesh's modules: each function of the reference module has a
# counterpart of the same name in the port's
MESH_MODULES = {
    "parallel.mesh": ("prepare_shards", "shard_batch", "_unify_part_dictionaries",
                      "make_mesh", "smap"),
    "parallel.exchange": ("hash_repartition", "skewed_repartition", "skew_split_counts",
                          "needed_bucket", "broadcast_all"),
    "ops.skew": ("hot_key_sketch", "is_hot", "hot_key_hashes"),
}


def test_mesh_modules_and_distributed_executor_have_counterparts():
    """The mesh, exchange and skew functions of the reference exist in the
    port's modules of the same path, and every ``_exec_*`` override and
    sharded path of the reference's ``DistributedExecutor`` exists on the
    port's (whose ``FragmentedExecutor`` is one, as the reference's is)."""
    import importlib

    from trino_tpu.parallel.distributed import DistributedExecutor as RefDist
    from trino_tpu_torch.exec.fragments import FragmentedExecutor
    from trino_tpu_torch.parallel.distributed import DistributedExecutor

    for module, names in MESH_MODULES.items():
        ref = importlib.import_module(f"trino_tpu.{module}")
        port = importlib.import_module(f"trino_tpu_torch.{module}")
        for name in names:
            assert hasattr(ref, name) and hasattr(port, name), (module, name)
    overrides = [n for n, v in vars(RefDist).items()
                 if n.startswith("_exec_") and callable(v)]
    assert sorted(overrides) == ["_exec_aggregate", "_exec_join", "_exec_tablescan"]
    for name in overrides + ["_partial_final_agg", "_prepare_agg_inputs", "_final_combine",
                             "_global_agg_distributed", "_broadcast_join",
                             "_partitioned_join", "_hybrid_repartition"]:
        assert name in vars(DistributedExecutor), name
    assert issubclass(FragmentedExecutor, DistributedExecutor)
    from trino_tpu_torch.parallel import distributed as D

    assert callable(D._sharded_probe) and callable(D._is_sharded)


def test_every_reference_run_method_has_a_counterpart():
    """Every ``_run_*``/``run_*`` method of the reference's
    ``FragmentedExecutor`` exists in the port under its name, or under
    the named counterpart."""
    from trino_tpu.exec.fragments import FragmentedExecutor as RefExecutor
    from trino_tpu_torch.exec.fragments import FragmentedExecutor

    names = [n for n in dir(RefExecutor) if n.startswith(("_run_", "run_"))]
    assert len(names) >= 10
    for name in names:
        assert hasattr(FragmentedExecutor, RUN_METHOD_COUNTERPARTS.get(name, name)), name


def test_port_opens_no_data_path_of_the_reference(tmp_path):
    """The port's disk cache of generated splits lives in
    ``.cache/dbgen_torch``: reading tpch and tpcds splits in a fresh
    interpreter opens nothing under the reference's ``.cache/dbgen``."""
    code = textwrap.dedent(
        """
        import os, sys
        seen = []
        def hook(event, args):
            if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
                seen.append(os.fsdecode(args[0]))
            elif event in ("os.listdir", "os.scandir", "os.mkdir") and args[0]:
                seen.append(os.fsdecode(args[0]))
        sys.addaudithook(hook)
        from trino_tpu_torch.connectors.tpch import TpchConnector
        from trino_tpu_torch.connectors.tpcds import TpcdsConnector
        for c, table in ((TpchConnector(), "nation"), (TpcdsConnector(), "store")):
            cols = c.get_table("tiny", table).column_names()
            c.read_split("tiny", table, cols, c.get_splits("tiny", table, 1)[0])
            print(c._disk_cache.directory)
        print("\\n".join(seen))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    tpch_dir, tpcds_dir, *paths = out.stdout.splitlines()
    want = os.path.join(REPO, ".cache", "dbgen_torch")
    assert tpch_dir == tpcds_dir == want
    assert any(os.path.abspath(p).startswith(want) for p in paths)  # it was used
    reference = os.path.join(REPO, ".cache", "dbgen")
    assert not [p for p in paths
                if os.path.abspath(p) == reference
                or os.path.abspath(p).startswith(reference + os.sep)]


def test_every_reference_catalog_kind_has_a_counterpart(tmp_path):
    """``register_catalog_spec`` takes the reference's kinds and makes the
    connector class of the same name."""
    from trino_tpu.connectors.api import CatalogManager as RefManager
    from trino_tpu.connectors.api import register_catalog_spec as ref_register
    from trino_tpu_torch.connectors.api import CatalogManager, register_catalog_spec

    for kind in ("memory", "blackhole", "file", "parquet", "orc", "tpch"):
        spec = f"c={kind}:{tmp_path / kind}"
        ref, port = RefManager(), CatalogManager()
        ref_register(ref, spec)
        register_catalog_spec(port, spec)
        assert type(port.get("c")).__name__ == type(ref.get("c")).__name__
        assert type(port.get("c")).__module__.startswith("trino_tpu_torch.")
    for manager, register in ((RefManager(), ref_register),
                              (CatalogManager(), register_catalog_spec)):
        with pytest.raises(ValueError, match="unknown catalog kind"):
            register(manager, "c=tpcds")


# one request a branch of the reference's router (``_route_post``,
# ``_route_get``, ``_route_delete``, ``_route_put``); ``{qid}`` is a query
# each server ran
ROUTE_SAMPLES = {
    "POST": ["/v1/statement", "/v1/task/t1.0.0", "/v1/write", "/v1/spmd",
             "/v1/spool/t1.0.0"],
    "GET": ["/v1/info", "/v1/memory", "/v1/info/state", "/v1/status", "/ui", "/ui/",
            "/", "/v1/resourceGroup", "/v1/task", "/v1/task/t1.0.0",
            "/v1/task/t1.0.0/results/0/0", "/v1/spool/t1.0.0/results/0/0", "/v1/spool",
            "/v1/node", "/v1/metrics", "/v1/metrics?format=json", "/v1/history",
            "/v1/cache", "/v1/slo", "/v1/query", "/v1/query/{qid}/timeline",
            "/v1/query/{qid}/flight", "/v1/query/{qid}",
            "/v1/statement/executing/{qid}/x0/0"],
    "DELETE": ["/v1/statement/executing/{qid}/x0/0", "/v1/query/no_such_query",
               "/v1/task/t1.0.0", "/v1/spool/t1.0.0", "/v1/announce/worker-1"],
    "PUT": ["/v1/discovery", "/v1/announce", "/v1/info/state",
            "/v1/spool/t1.0.0/complete"],
}
ROUTE_BODIES = {"/v1/statement": b"select 1", "/v1/info/state": b'"ACTIVE"'}


def _reference_routes():
    """(method, path literal) and (method, ``/v1/<segment>/`` prefix) of
    every branch of the reference's router, read from its source."""
    import inspect
    import re

    from trino_tpu.server.http import TrinoTpuServer as RefServer

    literals, prefixes = set(), set()
    for method in ROUTE_SAMPLES:
        src = inspect.getsource(getattr(RefServer, f"_route_{method.lower()}"))
        for lit in re.findall(r'path (?:==|in) \(?([^:]*?)\)?:', src):
            literals |= {(method, p) for p in re.findall(r'"(/[^"]*)"', lit)}
        prefixes |= {(method, f"/v1/{seg}/")
                     for seg in re.findall(r'parts\[:2\] == \["v1", "(\w+)"\]', src)}
    return literals, prefixes


def _answer(base_uri, method, path):
    import json
    import urllib.error
    import urllib.request

    from trino_tpu_torch.server import auth

    body = ROUTE_BODIES.get(path.split("?")[0], b"{}") if method in ("POST", "PUT") else None
    # as a cluster peer sends it: with the internal credential when the
    # process has a shared secret (both servers check the same one)
    req = urllib.request.Request(f"{base_uri}{path}", data=body, method=method,
                                 headers=auth.headers())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            raw, status = r.read(), r.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    try:
        doc = json.loads(raw.decode())
    except ValueError:
        doc = None
    return status, doc


def test_every_reference_route_has_a_counterpart_or_a_named_501():
    """Each branch of ``trino_tpu/server/http.py``'s router has a sample
    here (read from its source), and the port answers every sample as the
    reference does (the same status); never with the router's
    unknown-path 404, and with no 501: every route is ported."""
    from trino_tpu.server.http import TrinoTpuServer as RefServer
    from trino_tpu_torch.client import Connection
    from trino_tpu_torch.server.http import TrinoTpuServer

    literals, prefixes = _reference_routes()
    assert len(literals) >= 20 and len(prefixes) >= 8
    for method, path in literals:
        assert path in ROUTE_SAMPLES[method], (method, path)
    for method, prefix in prefixes:
        assert any(p.startswith(prefix) for p in ROUTE_SAMPLES[method]), (method, prefix)

    answers = {}
    for name, server in (("reference", RefServer()), ("port", TrinoTpuServer(device="cpu"))):
        server.start()
        try:
            Connection(server.base_uri).execute("select 1")
            qid = server.query_manager.queries()[0].query_id
            answers[name] = {
                (method, path): _answer(server.base_uri, method, path.format(qid=qid))
                for method, paths in ROUTE_SAMPLES.items() for path in paths
            }
        finally:
            server.stop()
    not_ported = []
    for key, (status, doc) in answers["port"].items():
        ref_status, _ = answers["reference"][key]
        if status == 501:
            assert doc["roadmapItem"] == "9c" and "ROADMAP item" in doc["error"], key
            not_ported.append(key)
            continue
        assert status == ref_status, (key, status, ref_status)
        assert not (status == 404 and "unknown path" in str(doc)), key
    # every route, SPMD's (400 on a server without it) included, answers
    # as the reference's
    assert not_ported == []


# the reference's modules with no counterpart in the port, each with its
# ROADMAP item: none since SPMD (parallel/spmd.py) was ported
UNPORTED_MODULES: dict = {}


def test_no_module_is_unported():
    """``comm -23`` of the two packages' module lists is empty: every
    module of the reference has its counterpart."""
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        out = set()
        for dirpath, _, files in os.walk(root):
            rel = os.path.relpath(dirpath, root)
            for f in files:
                if f.endswith(".py"):
                    out.add(os.path.normpath(os.path.join(rel, f)))
        return out

    missing = modules("trino_tpu") - modules("trino_tpu_torch")
    # a directory none of whose modules is ported counts as one entry
    grouped = {m.split(os.sep)[0] + "/" if os.sep in m and not (
        modules("trino_tpu_torch") & {x for x in modules("trino_tpu")
                                      if x.split(os.sep)[0] == m.split(os.sep)[0]})
               else m.replace(os.sep, "/") for m in missing}
    # native/ is the reference's C sources' build glue; the port keeps its
    # own in csrc/ and native.py
    grouped.discard("native/")
    assert grouped == set(UNPORTED_MODULES), sorted(grouped)


# the cluster tier's classes: every ``_do_*``, ``_exec_*`` and
# ``_run_*``/``run_*`` method of the reference's has a counterpart
CLUSTER_CLASSES = [
    ("server.task", "SqlTask"), ("server.task", "WorkerExecutor"),
    ("server.task", "FusedWorkerRunner"), ("server.task", "ExchangeClient"),
    ("server.task", "OutputBuffer"), ("server.task", "SqlTaskManager"),
    ("server.cluster", "ClusterScheduler"), ("server.cluster", "HttpRemoteTask"),
    ("server.cluster", "ClusterNodeManager"), ("server.cluster", "NodeScheduler"),
    ("server.failuredetector", "HeartbeatFailureDetector"),
    ("exchange.spool", "SpoolStore"), ("exchange.spool", "DiskSpoolStore"),
    ("exchange.spool", "SpoolWriter"), ("ft.injection", "FaultInjector"),
    ("server.http", "TrinoTpuServer"), ("memory", "ClusterMemoryManager"),
    ("testing", "MultiProcessQueryRunner"), ("engine", "Engine"),
]


@pytest.mark.parametrize("module,cls", CLUSTER_CLASSES)
def test_cluster_tier_methods_have_counterparts(module, cls):
    import importlib

    ref = getattr(importlib.import_module(f"trino_tpu.{module}"), cls)
    port = getattr(importlib.import_module(f"trino_tpu_torch.{module}"), cls)
    names = [n for n in vars(ref)
             if n.startswith(("_do_", "_exec_", "_run_", "run_", "_scaled", "_execute",
                              "_await", "_heal", "_recover", "_drain", "_announce",
                              "_task_"))]
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing


def test_spawned_worker_imports_neither_jax_nor_reference():
    """A worker process as the runner spawns it (``python -m
    trino_tpu_torch.server.main --role worker``), once it listens, holds
    no ``jax`` and nothing of ``trino_tpu`` in ``sys.modules``."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    code = textwrap.dedent(
        f"""
        import os, sys, threading, time, urllib.request
        def probe():
            deadline = time.time() + 120
            while time.time() < deadline:
                try:
                    urllib.request.urlopen("http://127.0.0.1:{port}/v1/info", timeout=2)
                    break
                except OSError:
                    time.sleep(0.1)
            leaked = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "trino_tpu"))
            print("LEAKED", ",".join(leaked), flush=True)
            os._exit(0)
        threading.Thread(target=probe, daemon=True).start()
        sys.argv = ["main", "--role", "worker", "--device", "cpu", "--port", "{port}",
                    "--discovery", "http://127.0.0.1:9"]
        import runpy
        runpy.run_module("trino_tpu_torch.server.main", run_name="__main__")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=180, env={**os.environ, "OMP_NUM_THREADS": "1"})
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("LEAKED")]
    assert lines, out.stdout + out.stderr
    assert lines[0] == "LEAKED ", lines[0]
