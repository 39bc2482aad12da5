"""Host paths of the port's server, each against the reference's, on one CUDA card.

Three host paths of ``trino_tpu_torch`` differ from the JAX package's:

- ``ResultPager._produce_locked`` sizes a chunk of ``max_rows_per_page``
  rows in one encoding until a chunk reaches the page budget, where the
  reference encodes every row on its own;
- ``Batch.to_pylist`` converts the plain types a column at a time
  (``columnar.python_values``), where the reference calls the type's
  ``to_python`` on every value;
- ``_DispatchPool.submit`` starts a worker for every item no idle worker
  takes, where the reference starts one only while no worker is idle.

This script puts the reference's version of each back, one at a time and
all together, and measures what each path moves:

- ``extract``: ``select o_orderkey, o_custkey, o_totalprice, o_orderdate
  from tpch.sf1.orders`` (1,500,000 rows) over HTTP under the default
  1 MiB page budget, through the port's client: seconds, rows/s, pages,
  the pager's peak buffered bytes, and the rows' checksum against the
  final variant's;
- ``concurrent``: 8 clients at once, each a literal variant of one orders
  aggregate, batched (``batch_window_ms`` 5000, ``batch_max_size`` 8):
  wall ms and each query's batch size.

Variants: ``final`` (the port as it stands), ``row_pager``, ``row_values``,
``reference`` (both), and for the concurrent step ``reference_spawn``. The
order is mirrored (ABCD DCBA) so that a drift of the host shows. One JSON
line a run.

Usage: ``python3 scripts/server_paths_experiment.py`` (generates and
stages ``tpch.sf1.orders`` first, about 10 s).
"""

import contextlib
import json
import os
import sys
import threading
import time
import urllib.request
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from trino_tpu_torch import columnar  # noqa: E402
from trino_tpu_torch.client import ClientSession, StatementClient  # noqa: E402
from trino_tpu_torch.server import querymanager as QM  # noqa: E402

EXTRACT = "select o_orderkey, o_custkey, o_totalprice, o_orderdate from tpch.sf1.orders"
AGGREGATE = ("select count(*), sum(o_totalprice) from tpch.sf1.orders "
             "where o_custkey < {}")
CLIENTS = 8


def log(**kv) -> None:
    print(json.dumps(kv, default=str), flush=True)


def reference_produce_locked(self) -> None:
    """``trino_tpu/server/querymanager.py``'s ``ResultPager._produce_locked``."""
    rows: list = []
    nbytes = 2  # brackets
    for row in self._src:
        try:
            enc = len(json.dumps(row, default=str))
        except (TypeError, ValueError):
            enc = 64
        rows.append(row)
        nbytes += enc + 2
        if nbytes >= self._budget or len(rows) >= self._max_rows:
            break
    else:
        self._exhausted = True
    if not rows:
        self._exhausted = True
        return
    self._store_locked(rows, nbytes)


def reference_submit(self, fn, *args) -> None:
    """``trino_tpu/server/querymanager.py``'s ``_DispatchPool.submit``."""
    with self._lock:
        if self._shutdown:
            raise RuntimeError("dispatch pool is shut down")
        self._q.put_nowait((fn, args))
        if self._idle == 0 and len(self._threads) < self._max:
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"{self._name}-{len(self._threads)}")
            self._threads.append(t)
            t.start()


PATCHES = {
    "row_pager": [(QM.ResultPager, "_produce_locked", reference_produce_locked)],
    "row_values": [(columnar, "python_values", lambda *_: None)],
    "reference_spawn": [(QM._DispatchPool, "submit", reference_submit)],
}
PATCHES["reference"] = PATCHES["row_pager"] + PATCHES["row_values"]


@contextlib.contextmanager
def variant(name: str):
    saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in PATCHES.get(name, [])]
    for owner, attr, fn in PATCHES.get(name, []):
        setattr(owner, attr, fn)
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def checksum(rows) -> list:
    """The count, the sums of the first three columns and of the dates'
    CRC-32s."""
    out = [len(rows), 0, 0, 0, 0]
    for a, b, c, d in rows:
        out[1] += a
        out[2] += b
        out[3] += c
        out[4] += zlib.crc32(str(d).encode())
    return [str(x) for x in out]


def query_info(base: str, query_id: str) -> dict:
    with urllib.request.urlopen(f"{base}/v1/query/{query_id}", timeout=60) as r:
        return json.loads(r.read().decode())


def main() -> int:
    if not torch.cuda.is_available():
        print("server_paths_experiment: needs a CUDA card", file=sys.stderr)
        return 2
    from trino_tpu_torch.connectors.tpch import _SCHEMAS, TpchConnector
    from trino_tpu_torch.exec.streaming import slab_stage_rows
    from trino_tpu_torch.server.http import TrinoTpuServer
    from trino_tpu_torch.testing import LocalQueryRunner

    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    tpch = TpchConnector()
    runner.catalogs.register("tpch", tpch)
    t0 = time.perf_counter()
    tpch.device_slab("sf1", "orders", [c for c, _ in _SCHEMAS["orders"]],
                     slab_stage_rows(runner.session),
                     int(runner.session.get("stream_device_cache_bytes")), device="cuda")
    torch.cuda.synchronize()
    log(step="stage", table="tpch.sf1.orders", seconds=time.perf_counter() - t0)
    props = dict(runner.session.properties)
    one_props = {**props, "stream_scan_threshold_rows": 1 << 24}
    batch_props = {**one_props, "batch_window_ms": 5000, "batch_max_size": CLIENTS}
    server = TrinoTpuServer(engine=runner.engine).start()
    base = server.base_uri
    try:
        # warm: the extraction's program and the aggregate's, stored
        list(StatementClient(base, EXTRACT, ClientSession("u", "tpch", "sf1", props)).rows())
        list(StatementClient(base, AGGREGATE.format(1000),
                             ClientSession("u", "tpch", "sf1", one_props)).rows())
        want = None
        for name in ("final", "row_pager", "row_values", "reference",
                     "reference", "row_values", "row_pager", "final"):
            with variant(name):
                t0 = time.perf_counter()
                c = StatementClient(base, EXTRACT, ClientSession("u", "tpch", "sf1", props))
                rows = list(c.rows())
                seconds = time.perf_counter() - t0
            pager = server.query_manager.get(c.query_id)._pager
            got = checksum(rows)
            want = want or got
            log(step="extract", variant=name, rows=len(rows), seconds=seconds,
                rows_per_s=len(rows) / seconds, pages=pager.pages_produced,
                peak_buffered_bytes=pager.peak_buffered_bytes, checksum_equal=got == want)
            del rows
    finally:
        server.stop()
    # each burst on a new server whose pool ran one query before it, as
    # a burst meets a server that served one client at a time
    for name in ("final", "reference_spawn", "reference_spawn", "final",
                 "final", "reference_spawn"):
        out = [None] * CLIENTS

        def client(i, base, p=batch_props):
            c = StatementClient(base, AGGREGATE.format(1000 + 10 * i),
                                ClientSession("u", "tpch", "sf1", p))
            out[i] = (list(c.rows()), c.query_id)

        server = TrinoTpuServer(engine=runner.engine).start()
        try:
            with variant(name):
                client(0, server.base_uri, one_props)
                threads = [threading.Thread(target=client, args=(i, server.base_uri))
                           for i in range(CLIENTS)]
                t0 = time.perf_counter()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(120)
                wall_ms = (time.perf_counter() - t0) * 1e3
            sizes = [query_info(server.base_uri, o[1])["batchStats"] if o else None
                     for o in out]
            log(step="concurrent", variant=name, clients=CLIENTS, wall_ms=wall_ms,
                batch_sizes=[b and b["batchSize"] for b in sizes],
                batch_wait_ms=[b and b["batchWaitMs"] for b in sizes],
                pool_threads=len(server.query_manager._pool._threads))
        finally:
            server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
