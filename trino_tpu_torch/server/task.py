"""Worker task runtime: execute one fragment, buffer partitioned output.

Reference: ``execution/SqlTaskManager.java:88,370`` (task registry +
updateTask), ``execution/SqlTaskExecution.java`` (fragment -> drivers),
``execution/buffer/OutputBuffer.java:23,88-94`` with its Partitioned /
Broadcast variants (producer side of the shuffle), and
``server/TaskResource.java:84,127,261`` (the REST surface in http.py).

A task executes its fragment with a :class:`WorkerExecutor` — the local
interpreter with two overrides: scans read only the task's assigned splits,
and RemoteSource leaves pull pages from upstream tasks over HTTP
(``operator/ExchangeOperator.java:35`` / ``ExchangeClient.java:149``).
Output rows are partitioned per the fragment's output exchange into
per-consumer page lists served token-acked (at-least-once + dedupe, like
``HttpPageBufferClient.java:93``).

A port of ``trino_tpu/server/task.py``. The device tie is
:class:`FusedWorkerRunner`: a worker's fragment runs through the port's
``FragmentedExecutor`` on the worker's card, one shard
(:func:`~trino_tpu_torch.parallel.mesh.make_local_mesh`), its programs
captured into the engine's ``ProgramPool``; the host pages of its remote
sources go to the card in one pinned copy (``ingest.to_device``), and its
output comes back to the host to be paginated. Interpreted tasks
(:class:`WorkerExecutor`) run the port's ``LocalExecutor`` on the same
device. A CUDA or kernel error fails the task, unretryable
(:func:`device_error`): it is never re-run on the interpreter or the
CPU.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import traceback
import urllib.request
from typing import Any, Optional

import numpy as np
import torch

from trino_tpu_torch.columnar import Batch, Column, concat_batches, torch_dtype
from trino_tpu_torch.config import Session
from trino_tpu_torch.exec.local import LocalExecutor, Result
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.fragmenter import PlanFragment
from trino_tpu_torch.serde import deserialize_batch, serialize_batch
from trino_tpu_torch.server.statemachine import TaskState

PAGE_ROWS = 1 << 16

# Worker-side fragment/program memo (cross-attempt compile reuse): TASK
# retry re-sends the same fragment payload to a worker; deserializing it
# afresh gives the plan nodes new object identities, which makes every
# program-store key miss and forces a full retrace per attempt. Keyed by
# (query_id, fragment_id, payload digest), each entry pins ONE deserialized
# PlanFragment (stable node ids) plus the program dict compiled against it,
# so attempt N+1 re-executes attempt N's compiled programs. Entries hold
# compiled executables — keep the bound small.
_WORKER_FRAGMENT_CACHE_MAX = 8


def _shared_fragment_entry(
    engine, query_id, payload_fragment, validate, payload_members=None
):
    """Return a locked {fragment, members, programs, lock} entry for this
    payload (a program-cache entry of the worker: its programs are
    captured into the engine's ``ProgramPool``), or None when another live task of the same fragment holds it
    (concurrent partitions must not share a FragmentedExecutor's mutable
    state). ``payload_members`` is the serialized fused-unit chain when
    the task ships one — it joins the digest so a fused and an unfused
    payload of the same root fragment never share programs."""
    import hashlib

    from trino_tpu_torch.planner.serde import fragment_from_json

    cache = getattr(engine, "_task_fragment_cache", None)
    if cache is None:
        from collections import OrderedDict

        cache = engine._task_fragment_cache = OrderedDict()
        engine._task_fragment_cache_lock = threading.Lock()
    digest = hashlib.sha256(
        json.dumps(
            [payload_fragment, payload_members], sort_keys=True, default=str
        ).encode()
    ).hexdigest()
    key = (query_id, payload_fragment.get("id"), digest)
    with engine._task_fragment_cache_lock:
        entry = cache.get(key)
        if entry is None:
            members = (
                [
                    fragment_from_json(m, validate=validate)
                    for m in payload_members
                ]
                if payload_members
                else None
            )
            entry = {
                # the chain's last member IS the unit root — reuse the
                # deserialized object so plan-node identities agree
                "fragment": (
                    members[-1]
                    if members
                    else fragment_from_json(payload_fragment, validate=validate)
                ),
                "members": members,
                "programs": {},
                "lock": threading.Lock(),
            }
            cache[key] = entry
            while len(cache) > _WORKER_FRAGMENT_CACHE_MAX:
                _, old = cache.popitem(last=False)
                # its captured graphs leave the engine's program pool
                engine._drop_programs(old["programs"])
        else:
            cache.move_to_end(key)
    if not entry["lock"].acquire(blocking=False):
        return None
    return entry


class OutputBuffer:
    """Per-partition page deques with token-acked consumption, bounded
    memory, and producer backpressure.

    Reference: ``execution/buffer/OutputBufferMemoryManager.java`` — the
    producer blocks once buffered bytes exceed the cap; a consumer GET with
    token N acknowledges (and frees) every page below N, releasing the
    producer. At-least-once delivery: unacknowledged pages are re-served on
    retry with the same token.

    ``retain=True`` (TASK retry policy) switches to materialized-exchange
    semantics (reference: Tardigrade's spooled exchange): acks no longer
    free pages, so a *retried consumer attempt* can re-pull the stream
    from token 0 bit-identically. Memory is released when the coordinator
    deletes the task after the consuming stage finishes. Retained buffers
    skip producer backpressure — blocking would deadlock a stage-barrier
    schedule where consumers only start after producers finish.
    """

    def __init__(
        self,
        n_partitions: int,
        max_buffered_bytes: int = 64 << 20,
        retain: bool = False,
    ):
        self.n = n_partitions
        self._pages: list[list[bytes]] = [[] for _ in range(n_partitions)]
        self._base: list[int] = [0] * n_partitions  # first unacked token
        self._buffered = 0
        self.max_buffered_bytes = max_buffered_bytes
        self.retain = retain
        self._complete = False
        self._aborted = False
        self.dropped_unacked = False  # abort() discarded undelivered pages
        # spooled exchange (exchange/spool.py): mirrors every enqueued
        # page to the coordinator's spool store off the critical path
        self.spool_writer = None
        self._lock = threading.Condition()

    def enqueue(self, partition: int, page: bytes) -> None:
        with self._lock:
            # backpressure: block until consumers ack enough pages
            while (
                not self.retain
                and self._buffered + len(page) > self.max_buffered_bytes
                and self._buffered > 0
                and not self._aborted
            ):
                self._lock.wait(1.0)
            if self._aborted:
                return
            self._pages[partition].append(page)
            self._buffered += len(page)
            self._lock.notify_all()
        if self.spool_writer is not None:
            self.spool_writer.offer(partition, page)

    def set_complete(self) -> None:
        with self._lock:
            self._complete = True
            self._lock.notify_all()

    def abort(self) -> None:
        """Unblock producers and drop buffered pages (task cancel/fail).
        Also aborts any in-flight spool write — DELETE /v1/task and
        speculative cancels must not leave half-spooled (or now-stale)
        pages in the coordinator's store."""
        with self._lock:
            self._aborted = True
            self._complete = True
            if any(self._pages):
                # a consumer re-reading these tokens must not mistake the
                # truncated stream for a successful empty result
                self.dropped_unacked = True
            self._pages = [[] for _ in range(self.n)]
            self._buffered = 0
            self._lock.notify_all()
        if self.spool_writer is not None:
            self.spool_writer.abort()

    def get(self, partition: int, token: int, max_wait: float = 1.0):
        """Pages from `token` on; blocks up to max_wait for more data.
        A request at token N acks (frees) pages below N. Returns
        (pages, next_token, complete)."""
        deadline = time.monotonic() + max_wait
        with self._lock:
            # acknowledge everything below `token`
            base = self._base[partition]
            if token > base and not self.retain:
                drop = token - base
                dropped = self._pages[partition][:drop]
                del self._pages[partition][:drop]
                self._base[partition] = token
                self._buffered -= sum(len(p) for p in dropped)
                self._lock.notify_all()
            while True:
                base = self._base[partition]
                pages = self._pages[partition][max(0, token - base):]
                if pages or self._complete:
                    return pages, token + len(pages), self._complete
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [], token, False
                self._lock.wait(remaining)


class ExchangeClient:
    """Pull one partition of an upstream fragment from all its tasks.

    Reference: ``operator/ExchangeClient.java:56,149`` — one buffer client
    per upstream location, token-advancing GETs until complete.

    Timeouts come from the session (``exchange_timeout_s`` /
    ``exchange_poll_s``) so chaos tests can shrink them. Each GET is
    retried through transient connection errors (and injected HTTP drops)
    with deterministic backoff: token-addressed reads are idempotent —
    the producer re-serves unacknowledged pages at the same token — so a
    replayed pull cannot duplicate or lose rows.
    """

    def __init__(
        self,
        locations: list[str],
        partition: int,
        timeout: float = 300.0,
        poll_wait: float = 15.0,
        injector=None,
        http_retries: int = 3,
        backoff=None,
        trace=None,
    ):
        from trino_tpu_torch.ft.retry import Backoff

        self.locations = locations
        self.partition = partition
        self.timeout = timeout
        self.poll_wait = poll_wait  # server-side long-poll hold per GET
        self.injector = injector
        self.http_retries = max(1, int(http_retries))
        self.backoff = backoff or Backoff()
        # (trace_id, parent_span_id) for the exchange_read span: pull
        # threads start with a fresh context, so callers that spawn one
        # thread per source must capture and pass the parent explicitly
        self.trace = trace

    @classmethod
    def for_session(
        cls, session, locations: list[str], partition: int, injector=None,
        trace=None,
    ) -> "ExchangeClient":
        """Injector may be passed in to share one event log / counter set
        with the caller (the owning task); otherwise it is derived from
        the session."""
        from trino_tpu_torch.ft.injection import FaultInjector
        from trino_tpu_torch.ft.retry import Backoff

        try:
            return cls(
                locations,
                partition,
                timeout=float(session.get("exchange_timeout_s")),
                poll_wait=float(session.get("exchange_poll_s")),
                injector=injector or FaultInjector.from_session(session),
                http_retries=int(session.get("http_retry_attempts")),
                backoff=Backoff.from_session(session),
                trace=trace,
            )
        except KeyError:  # sessions predating the ft properties
            return cls(locations, partition, injector=injector, trace=trace)

    def _get_json(self, loc: str, uri: str, token: int, deadline: float) -> dict:
        """One token read, retried through transient errors. The site key
        strips per-run identifiers (host:port, query counter) so injected
        drops replay deterministically."""
        from trino_tpu_torch.ft.retry import is_retryable

        task_tail = loc.rsplit("/", 1)[-1].split(".", 1)[-1]
        last: Optional[Exception] = None
        for attempt in range(1, self.http_retries + 1):
            if time.monotonic() > deadline and last is not None:
                break
            from trino_tpu_torch.server import auth

            try:
                if self.injector is not None:
                    site = self.injector.http_site(
                        "results",
                        f"{task_tail}.p{self.partition}.k{token}",
                        attempt,
                    )
                    self.injector.delay_http(site)
                    self.injector.maybe_drop_http(site)
                req = urllib.request.Request(uri, headers=auth.headers())
                with urllib.request.urlopen(
                    req, timeout=self.poll_wait + 30
                ) as r:
                    return json.loads(r.read().decode())
            except Exception as e:  # noqa: BLE001
                if not is_retryable(e) or attempt >= self.http_retries:
                    raise
                last = e
                time.sleep(self.backoff.delay(attempt))
        raise last  # deadline exceeded mid-retry

    def read_all(self) -> list[Batch]:
        from trino_tpu_torch.obs.metrics import get_registry
        from trino_tpu_torch.obs.trace import get_tracer

        tracer = get_tracer()
        ctx = self.trace or tracer.context()
        t0 = time.monotonic()
        batches: list[Batch] = []
        threads = []
        errors: list[Exception] = []
        xfer = {"pages": 0, "bytes": 0}
        lock = threading.Lock()

        def pull(loc: str):
            from trino_tpu_torch.server import auth

            try:
                token = 0
                deadline = time.monotonic() + self.timeout
                while True:
                    uri = (
                        f"{loc}/results/{self.partition}/{token}"
                        f"?maxWait={self.poll_wait}"
                    )
                    payload = self._get_json(loc, uri, token, deadline)
                    for b64 in payload["pages"]:
                        raw = base64.b64decode(b64)
                        batch = deserialize_batch(raw)
                        with lock:
                            batches.append(batch)
                            xfer["pages"] += 1
                            xfer["bytes"] += len(raw)
                    token = payload["token"]
                    if payload["complete"]:
                        # final ack frees the last unacked page window on
                        # the producer (nothing re-reads a complete buffer)
                        try:
                            ack = f"{loc}/results/{self.partition}/{token}?maxWait=0"
                            urllib.request.urlopen(
                                urllib.request.Request(
                                    ack, headers=auth.headers()
                                ),
                                timeout=5,
                            ).close()
                        except Exception:  # noqa: BLE001 - best-effort
                            pass
                        return
                    if payload.get("failed"):
                        raise RuntimeError(payload.get("error", "upstream task failed"))
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"exchange timed out reading {uri}")
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(e)

        try:
            for loc in self.locations:
                t = threading.Thread(target=pull, args=(loc,), daemon=True)
                t.start()
                threads.append(t)
            deadline = time.monotonic() + self.timeout
            for t in threads:
                t.join(max(0.0, deadline - time.monotonic()))
            if errors:
                raise errors[0]
            if any(t.is_alive() for t in threads):
                # a stalled puller must not yield silently-partial results
                raise TimeoutError("exchange read timed out with pulls in flight")
            return batches
        finally:
            dur_ms = (time.monotonic() - t0) * 1000.0
            tracer.record(
                "exchange_read", dur_ms,
                attrs={
                    "locations": len(self.locations),
                    "partition": self.partition,
                    "pages": xfer["pages"],
                    "bytes": xfer["bytes"],
                },
                trace_id=ctx[0] if ctx else None,
                parent_id=ctx[1] if ctx else None,
                status="OK" if not errors else "ERROR",
            )
            reg = get_registry()
            reg.histogram("trino_tpu_exchange_read_ms").observe(dur_ms)
            reg.counter("trino_tpu_exchange_read_bytes_total").inc(xfer["bytes"])
            reg.counter("trino_tpu_exchange_read_pages_total").inc(xfer["pages"])


class WorkerExecutor(LocalExecutor):
    """Local interpreter + assigned-split scans + HTTP remote sources, on
    ``device`` (the worker's engine device). ``splits`` None scans every
    split of a table here: the coordinator's root fragment, whose scans
    no task was assigned (the reference passes no splits there, and a
    root fragment that scans a table, TPC-H Q20's, reads nothing)."""

    def __init__(
        self,
        catalogs,
        session: Session,
        splits: Optional[dict[str, list[dict]]],
        sources: dict[int, dict],
        prefetched: Optional[dict[int, list[Batch]]] = None,
        device="cpu",
    ):
        super().__init__(catalogs, session, device)
        self._splits = splits
        self._sources = sources
        self._prefetched = prefetched or {}

    def _scan_splits(self, node: P.TableScan):
        from trino_tpu_torch.connectors.api import Split

        if self._splits is None:
            return super()._scan_splits(node)
        key = f"{node.catalog}.{node.schema}.{node.table}"
        return [
            Split(d["table"], d["index"], d["total"], d.get("info"))
            for d in self._splits.get(key, [])
        ]

    def _exec_tablescan(self, node: P.TableScan, splits=None) -> Result:
        if splits is None:
            splits = self._scan_splits(node)
        if not splits:
            layout = {s.name: i for i, s in enumerate(node.symbols)}
            empty = Batch([_empty_column(s.type) for s in node.symbols], 0)
            return Result(empty.to(self.device), layout)
        # assigned splits decode through the double-buffered ingest tier
        # (decode of split k+1 overlaps device work on split k)
        return super()._exec_tablescan(node, splits)

    def _exec_remotesource(self, node: P.RemoteSource) -> Result:
        if node.fragment_id in self._prefetched:
            batches = self._prefetched[node.fragment_id]
        else:
            src = self._sources[node.fragment_id]
            client = ExchangeClient.for_session(
                self.session, src["locations"], src["partition"]
            )
            batches = client.read_all()
        layout = {s.name: i for i, s in enumerate(node.symbols)}
        nonempty = [b for b in batches if b.num_rows > 0]
        if not nonempty:
            cols = [_empty_column(s.type) for s in node.symbols]
            return Result(Batch(cols, 0).to(self.device), layout)
        return Result(self._to_device(concat_batches(nonempty)), layout)


class FusedWorkerRunner:
    """Execute one fragment on this worker's card as programs of the
    port's fragment executor (the reference hooks its compiled tier in at
    ``LocalExecutionPlanner.java:307``; there the whole fragment is one
    compiled program over the worker-local mesh).

    Inputs arrive as host batches (splits, HTTP pages) and are placed onto
    the mesh respecting the exchange semantics the in-process fused path
    gets from its collectives:
    - broadcast sources replicate (every local shard sees the full build);
    - hash sources re-partition rows by key hash over local shards (the
      per-shard joins/combines in the tracer require co-partitioning);
    - everything else splits contiguously.
    A worker's mesh is one shard on its card, so each source is one batch
    and one pinned host-to-device copy (``ingest.to_device``); the copies
    are counted in the executor's ingest stats (``h2d_bytes``,
    ``h2d_transfers``). Programs are captured into the engine's
    ``ProgramPool`` when the task holds a program-cache entry
    (:func:`_shared_fragment_entry`), so a retried attempt replays them.
    """

    def __init__(
        self,
        engine,
        session: Session,
        fragment: PlanFragment,
        programs: Optional[dict] = None,
    ):
        from trino_tpu_torch.exec.fragments import FragmentedExecutor
        from trino_tpu_torch.parallel.mesh import make_local_mesh

        mesh = getattr(engine, "mesh", None) or make_local_mesh(engine.device)
        # device execution must not re-enter cluster scheduling
        local = Session(
            user=session.user, catalog=session.catalog, schema=session.schema
        )
        for k, v in session.properties.items():
            if k != "execution_mode":
                local.properties[k] = v
        self.executor = FragmentedExecutor(
            engine.catalogs, local, engine.device, mesh=mesh, programs=programs,
            # programs are captured only into a program-cache entry
            pool=engine.program_pool if programs is not None else None,
        )
        self.fragment = fragment
        self.mesh = mesh

    @property
    def n(self) -> int:
        return self.mesh.size

    def run(
        self,
        splits: dict[str, list[dict]],
        source_batches: dict[int, list[Batch]],
        source_meta: dict[int, dict],
        stats_sink: Optional[dict] = None,
    ) -> Result:
        self.fragment = self._df_rewrite(self.fragment, source_batches)
        inputs: dict[str, Batch] = {}
        layouts: dict[str, dict[str, int]] = {}
        copied: set = set()
        self._gather_inputs(
            self.fragment.root,
            splits,
            source_batches,
            source_meta,
            inputs,
            layouts,
            copied,
        )
        return self._program(
            lambda: self.executor.run_fragment_program(
                self.fragment, self.fragment.root, inputs, layouts, copied
            ),
            stats_sink,
        )

    def run_chain(
        self,
        members: list[PlanFragment],
        splits: dict[str, list[dict]],
        source_batches: dict[int, list[Batch]],
        source_meta: dict[int, dict],
        stats_sink: Optional[dict] = None,
    ) -> Result:
        """Fused-unit chain (bottom-up, unit root LAST) as ONE program on
        the worker-local mesh: interior hash/'single' exchanges lower to
        in-program collectives, so every member rides this task's single
        dispatch round-trip. Only external feeds — member table scans and
        out-of-unit remote sources — are placed host-side; in-unit links
        never leave the device."""
        member_ids = frozenset(m.id for m in members)
        frags = [self._df_rewrite(m, source_batches) for m in members]
        self.fragment = frags[-1]
        # in-unit skew pairs detect/salt in-trace; _skew_roles normally
        # derives roles from the query SubPlan, which never ships to
        # workers — seed the memo from the member list instead
        if self.executor.programs.get("__skewroles__") is None:
            from trino_tpu_torch.planner.fragmenter import partitioned_join_pairs

            roles: dict[int, dict] = {}
            if bool(self.executor.session.get("skew_handling")):
                for probe, build in partitioned_join_pairs(frags):
                    roles[probe] = {"role": "probe"}
                    roles[build] = {"role": "build", "peer": probe}
            self.executor.programs["__skewroles__"] = roles
        inputs: dict[str, Batch] = {}
        layouts: dict[str, dict[str, int]] = {}
        copied: set = set()
        for f in frags:
            self._gather_inputs(
                f.root,
                splits,
                source_batches,
                source_meta,
                inputs,
                layouts,
                copied,
                skip_fids=member_ids,
            )
        out = self._program(
            lambda: self.executor.run_fused_program(
                [(f, f.root) for f in frags], inputs, layouts, copied
            ),
            stats_sink,
        )
        # the chain's members ran as one program (queryStats.fusedFragments)
        self.executor._count("fusedFragments", len(frags))
        return out

    def _program(self, run, stats_sink: Optional[dict]) -> Result:
        """Run one program under the task's parameter tensor (a worker's
        fragment carries its literals; nothing is hoisted), with the
        executor's wall time, operator rows and exchange counters in
        ``stats_sink``."""
        from trino_tpu_torch.compiler import param_tensor

        self.executor.params = param_tensor([], self.executor.device)
        t0 = time.perf_counter()
        res = run()
        if stats_sink is not None:
            stats_sink["program_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
        return res

    def _df_rewrite(
        self, fragment: PlanFragment, source_batches: dict[int, list[Batch]]
    ) -> PlanFragment:
        """Dynamic filtering: prefetched build pages prune this task's
        probe splits and rows (sound under hash partitioning — probe rows
        are co-partitioned with their build rows). In-unit build sides
        are traced values, not host pages, so they simply don't prune."""
        import dataclasses as _dc

        from trino_tpu_torch.dynfilter import fragment_dynamic_filters

        by_fid = {
            n.fragment_id: n
            for n in P.walk_plan(fragment.root)
            if isinstance(n, P.RemoteSource)
        }

        def build_lookup(fid):
            node = by_fid.get(fid)
            batches = source_batches.get(fid)
            if node is None or batches is None:
                return None
            nonempty = [b for b in batches if b.num_rows > 0]
            pos = {s.name: i for i, s in enumerate(node.symbols)}
            if not nonempty:
                def get_empty(name):
                    if name not in pos:
                        return None
                    return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.bool_)

                return get_empty, 0
            merged = (
                concat_batches(nonempty) if len(nonempty) > 1 else nonempty[0]
            ).compact()

            def get_column(name):
                i = pos.get(name)
                if i is None:
                    return None
                return merged.columns[i].to_numpy()

            return get_column, merged.num_rows

        root = fragment_dynamic_filters(
            fragment.root,
            build_lookup,
            self.executor.session,
            self.executor.dynamic_filters,
        )
        return _dc.replace(fragment, root=root)

    def _gather_inputs(
        self,
        root: P.PlanNode,
        splits: dict[str, list[dict]],
        source_batches: dict[int, list[Batch]],
        source_meta: dict[int, dict],
        inputs: dict[str, Batch],
        layouts: dict[str, dict[str, int]],
        copied: set,
        skip_fids: frozenset = frozenset(),
    ) -> None:
        from trino_tpu_torch.connectors.api import Split
        from trino_tpu_torch.exec.fragments import FusedUnsupported

        spill_threshold = (
            int(self.executor.session.get("spill_threshold_rows"))
            if self.executor.session.get("spill_enabled")
            else None
        )
        for node in P.walk_plan(root):
            if isinstance(node, P.TableScan):
                key = f"{node.catalog}.{node.schema}.{node.table}"
                assigned = splits.get(key, [])
                connector = self.executor.catalogs.get(node.catalog)
                if node.constraint is not None and assigned:
                    # dynamic-filter (and pushed) constraints drop whole
                    # splits before any read
                    objs = [
                        Split(d["table"], d["index"], d["total"], d.get("info"))
                        for d in assigned
                    ]
                    kept = connector.prune_splits(
                        node.schema, node.table, objs, node.constraint
                    )
                    kept_ids = {(s.index, s.total) for s in kept}
                    assigned = [
                        d
                        for d in assigned
                        if (d["index"], d["total"]) in kept_ids
                    ]
                parts: list[list[Batch]] = [[] for _ in range(self.n)]
                for i, d in enumerate(assigned):
                    parts[i % self.n].append(
                        connector.read_split(
                            node.schema,
                            node.table,
                            node.column_names,
                            Split(d["table"], d["index"], d["total"], d.get("info")),
                        )
                    )
                layout = {s.name: i for i, s in enumerate(node.symbols)}
                batch = self._assemble(
                    [self._concat(p) for p in parts], node.symbols
                )
                if spill_threshold is not None and batch.capacity > spill_threshold:
                    # same guard as the in-process fused path: spill-sized
                    # working sets belong to the interpreter's spill tier
                    raise FusedUnsupported("spill-sized input")
                inputs[f"scan{id(node)}"] = batch
                layouts[f"scan{id(node)}"] = layout
            elif isinstance(node, P.RemoteSource):
                if node.fragment_id in skip_fids:
                    continue  # in-unit link: fed as a traced value
                batches = source_batches[node.fragment_id]
                meta = source_meta.get(node.fragment_id, {})
                batch = self._place(node, batches, meta)
                inputs[f"remote{node.fragment_id}"] = batch
                layouts[f"remote{node.fragment_id}"] = {
                    s.name: i for i, s in enumerate(node.symbols)
                }
                # a replay copies remote inputs into its static buffers
                copied.add(f"remote{node.fragment_id}")

    # --- input placement --------------------------------------------------

    def _concat(self, batches: list[Batch]) -> Optional[Batch]:
        nonempty = [b for b in batches if b.num_rows > 0]
        if not nonempty:
            return None
        return (
            concat_batches(nonempty) if len(nonempty) > 1 else nonempty[0]
        ).compact()

    def _to_device(self, batch: Batch) -> Batch:
        """One pinned host-to-device copy of an assembled input, counted
        in the executor's ingest stats."""
        return self.executor._to_device(batch)

    def _assemble(
        self, parts: list[Optional[Batch]], symbols
    ) -> Batch:
        from trino_tpu_torch.parallel.mesh import shard_batch

        proto = next((p for p in parts if p is not None), None)
        filled = []
        for p in parts:
            if p is not None:
                filled.append(p)
            elif proto is not None:
                cols = [
                    Column(
                        c.type,
                        c.data.new_zeros((0,) + tuple(c.data.shape[1:])),
                        None,
                        c.dictionary,
                    )
                    for c in proto.columns
                ]
                filled.append(Batch(cols, 0))
            else:
                cols = [_empty_column(s.type) for s in symbols]
                filled.append(Batch(cols, 0))
        return shard_batch(self.mesh, filled, to_device=self._to_device)

    def _place(self, node: P.RemoteSource, batches: list[Batch], meta: dict) -> Batch:
        merged = self._concat(batches)
        if merged is None:
            merged = Batch([_empty_column(s.type) for s in node.symbols], 0)
        if node.exchange_type == "broadcast":
            # full build side on every local shard (one shard: the batch)
            return self._assemble([merged] * self.n, node.symbols)
        if node.exchange_type == "hash":
            from trino_tpu_torch.exec.fragments import FusedUnsupported

            keys = meta.get("keys") or []
            symbols = meta.get("symbols") or []
            if not keys or any(k not in symbols for k in keys):
                # co-partitioning is a correctness requirement for the
                # per-shard joins/combines — never silently degrade
                raise FusedUnsupported("hash source without key metadata")
            if self.n == 1:
                return self._assemble([merged], node.symbols)
            positions = [symbols.index(k) for k in keys]
            key_pairs = [_hash_key(merged.columns[pos]) for pos in positions]
            khash, _ = J.hash_keys(key_pairs)
            dest = (khash % self.n).numpy()
            parts = [
                _take_rows(merged, np.nonzero(dest == p)[0])
                for p in range(self.n)
            ]
            return self._assemble(parts, node.symbols)
        # single/gather: contiguous chunks
        rows = merged.num_rows
        chunk = max(1, -(-rows // self.n))
        parts = [
            _take_rows(merged, np.arange(lo, min(lo + chunk, rows)))
            for lo in range(0, self.n * chunk, chunk)
        ]
        return self._assemble(parts, node.symbols)


def device_error(exc: BaseException) -> bool:
    """Is ``exc`` an error of the card or of a hand kernel (a CUDA error,
    an out-of-memory of the card, a kernel that failed to build, load or
    launch)? Such an error fails its task unretryable: it names a fault
    of the device path, which neither the interpreter nor another attempt
    may hide."""
    from trino_tpu_torch._kernels import KernelError

    if isinstance(exc, KernelError):
        return True
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA" in str(exc)


class SqlTask:
    """One task = one fragment execution on this node.

    Reference: ``execution/SqlTask.java`` + ``SqlTaskExecution.java``.
    """

    def __init__(self, task_id: str, engine, payload: dict, trace=None):
        self.task_id = task_id
        self.engine = engine
        self.state = TaskState.RUNNING
        # the node this task runs on (server/http.py sets engine.node_id);
        # delay-fault injection targets nodes by this identity
        self.node_id: Optional[str] = getattr(engine, "node_id", None)
        self.error: Optional[str] = None
        self.created = time.monotonic()  # interval math only (elapsed/reap)
        self.finished: Optional[float] = None  # monotonic, set on _run exit
        # (trace_id, parent_span_id) from the coordinator's X-Trino-Trace
        # header: parents this worker's task_execute span to the
        # dispatching attempt span across the process boundary
        self.trace = trace
        self.fragment_id = payload["fragment"]["id"]
        s = payload.get("session", {})
        self.session = Session(
            user=s.get("user", "worker"),
            catalog=s.get("catalog", "tpch"),
            schema=s.get("schema", "tiny"),
        )
        for k, v in s.get("properties", {}).items():
            self.session.properties[k] = v
        from trino_tpu_torch.planner.sanity import validation_enabled
        from trino_tpu_torch.planner.serde import fragment_from_json

        # whole-pipeline fusion: the payload may ship a fused-unit chain
        # (bottom-up, the task's fragment last) compiled as ONE program
        fused_payload = payload.get("fused_fragments")
        # TASK retry: reuse the attempt-1 fragment object (stable plan-node
        # identities) and its compiled programs; lock released in _run()
        self._frag_entry = _shared_fragment_entry(
            engine,
            task_id.rsplit(".", 2)[0],
            payload["fragment"],
            validation_enabled(self.session),
            payload_members=fused_payload,
        )
        if self._frag_entry is not None:
            self.fragment: PlanFragment = self._frag_entry["fragment"]
            self.fused_members = self._frag_entry.get("members")
        else:
            members = (
                [
                    fragment_from_json(
                        m, validate=validation_enabled(self.session)
                    )
                    for m in fused_payload
                ]
                if fused_payload
                else None
            )
            self.fragment = (
                members[-1]
                if members
                else fragment_from_json(
                    payload["fragment"],
                    validate=validation_enabled(self.session),
                )
            )
            self.fused_members = members
        self.splits: dict[str, list[dict]] = payload.get("splits", {})
        self.sources: dict[int, dict] = {
            int(k): v for k, v in payload.get("sources", {}).items()
        }
        self.n_output_partitions = payload.get("output_partitions", 1)
        # interpreter fallback runs single-node on this fragment
        self.session.properties["execution_mode"] = "local"
        try:
            buffer_bytes = int(self.session.get("exchange_buffer_bytes"))
        except (KeyError, TypeError, ValueError):
            buffer_bytes = 64 << 20
        # TASK retry: the coordinator asks for materialized (retained)
        # output so a retried consumer attempt can re-pull this stream
        self.buffer = OutputBuffer(
            self.n_output_partitions,
            max_buffered_bytes=buffer_bytes,
            retain=bool(payload.get("retain_output")),
        )
        # spooled exchange: the coordinator asks (payload["spool"]) for an
        # async durable copy of this task's retained output, so a consumer
        # can re-read it after this worker dies
        spool = payload.get("spool")
        if spool and self.buffer.retain:
            from trino_tpu_torch.exchange.spool import SpoolWriter

            self.buffer.spool_writer = SpoolWriter(
                spool["uri"], task_id, spool.get("queryId", self.query_id)
            )
        from trino_tpu_torch.ft.injection import FaultInjector

        self.injector = FaultInjector.from_session(self.session)
        # worker-side retryable classification of a FAILED state; None
        # while RUNNING/FINISHED (TaskFailure consumes this coordinator-side)
        self.retryable: Optional[bool] = None
        self.execution_path = "pending"
        self.stats: dict[str, Any] = {}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # --- execution --------------------------------------------------------

    def _prefetch_sources(self) -> dict[int, list[Batch]]:
        """Pull every remote source exactly once (pages are freed on final
        ack, so a retry after a failed device attempt cannot re-pull)."""
        out: dict[int, list[Batch]] = {}
        threads = []
        errors: list[Exception] = []

        from trino_tpu_torch.obs.trace import get_tracer

        # capture the task span context here: pull threads start fresh
        ctx = get_tracer().context()

        def pull(fid: int, src: dict):
            try:
                out[fid] = ExchangeClient.for_session(
                    self.session,
                    src["locations"],
                    src["partition"],
                    injector=self.injector,
                    trace=ctx,
                ).read_all()
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        for fid, src in self.sources.items():
            t = threading.Thread(target=pull, args=(fid, src), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out

    @property
    def query_id(self) -> str:
        """Task ids are ``{query_id}.{fragment}.{partition}``."""
        return self.task_id.rsplit(".", 2)[0]

    def _account(self, nbytes: int) -> None:
        """Per-task memory accounting against this node's pool, keyed by
        query id — the reservations workers report to the coordinator's
        ClusterMemoryManager (reference: per-task memory contexts rolling
        up to ``MemoryPool`` / ``ClusterMemoryManager.java:89``)."""
        if nbytes <= 0:
            return
        from trino_tpu_torch.memory import ExceededMemoryLimitError

        if not self.engine.memory_pool.try_reserve(self.query_id, nbytes):
            raise ExceededMemoryLimitError(
                f"task {self.task_id}: node memory pool exhausted reserving "
                f"{nbytes} bytes"
            )
        self._reserved += nbytes

    def _run(self) -> None:
        from trino_tpu_torch.obs.metrics import get_registry
        from trino_tpu_torch.obs.trace import get_tracer

        tracer = get_tracer()
        span = tracer.start_span(
            "task_execute",
            trace_id=self.trace[0] if self.trace else None,
            parent_id=self.trace[1] if self.trace else None,
            attrs={"taskId": self.task_id, "stage": self.fragment_id},
        )
        from trino_tpu_torch import _kernels

        self._reserved = 0
        launches: dict = {}
        try:
            with tracer.activate(span), _kernels.launch_scope() as launches:
                prefetched = self._prefetch_sources()
                if self.injector is not None:
                    # crash AFTER the sources were pulled: a retried attempt
                    # must be able to re-pull them (retained buffers / unacked
                    # token windows make the replay idempotent)
                    from trino_tpu_torch.ft.injection import task_site

                    site = task_site(self.task_id)
                    self.injector.maybe_crash_task(site)
                    # straggler manufacturing: fixed stall before execution
                    # on targeted slow nodes
                    self.injector.stall_task(site, self.node_id)
                from trino_tpu_torch.memory import batch_nbytes

                in_bytes = sum(
                    batch_nbytes(b)
                    for batches in prefetched.values()
                    for b in batches
                )
                self._account(in_bytes)
                self.stats["input_bytes"] = int(in_bytes)
                result = None
                exec_t0 = time.monotonic()
                mode = self.session.get("worker_execution")
                if mode in ("fused", "fused_strict"):
                    result = self._try_fused(prefetched, strict=mode == "fused_strict")
                if result is None:
                    self.execution_path = "interpreter"
                    result = self._run_interpreted(prefetched)
                if self.injector is not None:
                    # multiplicative slowdown applied before the result is
                    # emitted: a speculative cancel can still abort this
                    # buffer while the "slow" attempt is mid-sleep
                    self.injector.slow_task(
                        site, self.node_id, time.monotonic() - exec_t0
                    )
                    if self.state != TaskState.RUNNING:
                        # cancelled mid-stall (speculative loser): never
                        # emit into the aborted buffer
                        return
                self._account(batch_nbytes(result.batch) if result.batch is not None else 0)
                self._emit(result)
            if self.state == TaskState.RUNNING:
                self.state = TaskState.FINISHED
        except Exception as e:  # noqa: BLE001
            from trino_tpu_torch.ft.retry import is_retryable

            self.error = f"{e}\n{traceback.format_exc()}"
            self.retryable = is_retryable(e) and not device_error(e)
            if self.state == TaskState.RUNNING:
                # a cancelled task that then unwinds with an exception keeps
                # its cancelled state (the cancel is the cause, not the error)
                self.state = TaskState.FAILED
        finally:
            self.finished = time.monotonic()
            span.finish(
                status="OK" if self.state == TaskState.FINISHED else "ERROR",
                state=self.state,
                path=self.execution_path,
            )
            reg = get_registry()
            reg.counter(
                "trino_tpu_worker_tasks_total", state=self.state
            ).inc()
            reg.histogram(
                # fragment ids restart at 0 per plan: a bounded domain
                "trino_tpu_task_execute_ms", stage=str(self.fragment_id)  # lint: ignore[OBS001]
            ).observe((self.finished - self.created) * 1000.0)
            if self.injector is not None and self.injector.total_injected:
                self.stats["faults_injected"] = self.injector.total_injected
            if launches:
                # this task's hand-kernel launches (replays included)
                self.stats["kernel_launches"] = dict(launches)
            self.buffer.set_complete()
            writer = self.buffer.spool_writer
            if writer is not None:
                if self.state == TaskState.FINISHED:
                    # publish the completion manifest before the task is
                    # observable as durable; a failure here just leaves the
                    # spool incomplete (lineage recovery covers the gap)
                    if writer.finish():
                        self.stats["spooled_bytes"] = writer.spooled_bytes
                else:
                    writer.abort()
            if self._reserved:
                self.engine.memory_pool.free(self.query_id, self._reserved)
            # one-shot handoff (atomic pop): tests drive _run() directly on
            # top of the constructor-started thread, and the entry lock
            # must release exactly once no matter how many times _run ends
            entry = self.__dict__.pop("_frag_entry", None)
            if entry is not None:
                entry["lock"].release()
            if self.injector is not None:
                # worker-death fault LAST: by now the terminal state is
                # set, the buffer is complete, and (on FINISHED) the spool
                # manifest published — the deterministic death models a
                # node crashing right after its task output became durable
                from trino_tpu_torch.ft.injection import task_site

                self.injector.maybe_exit_worker(
                    task_site(self.task_id), self.node_id
                )

    def _try_fused(self, prefetched, strict: bool = False) -> Optional[Result]:
        """Fragment as programs on the worker's card; None means fall back
        to the interpreter (on the same card).

        ``strict`` (session ``worker_execution=fused_strict``) fails the
        task instead of silently interpreting: a fused-path regression
        turns a strict suite red rather than slow. A CUDA or kernel error
        (:func:`device_error`) always fails the task."""
        from trino_tpu_torch.exec.fragments import FusedUnsupported, fragment_fusable

        members = self.fused_members
        for frag in members or [self.fragment]:
            if not fragment_fusable(frag):
                if strict:
                    raise FusedUnsupported(
                        f"fused_strict: fragment {frag.id} is not fusable"
                    )
                return None
        try:
            # a concurrent _run() completion may have popped the entry;
            # the fragment object itself stays valid either way
            entry = getattr(self, "_frag_entry", None)
            runner = FusedWorkerRunner(
                self.engine,
                self.session,
                self.fragment,
                programs=entry["programs"] if entry else None,
            )
            source_meta = {
                fid: {"keys": src.get("keys"), "symbols": src.get("symbols")}
                for fid, src in self.sources.items()
            }
            if members:
                result = runner.run_chain(
                    members,
                    self.splits,
                    prefetched,
                    source_meta,
                    stats_sink=self.stats,
                )
                self.execution_path = "fused-pipeline"
            else:
                result = runner.run(
                    self.splits, prefetched, source_meta, stats_sink=self.stats
                )
                self.execution_path = "fused"
            self.stats["dynamic_filters"] = len(
                runner.executor.dynamic_filters
            )
            self.stats["compile"] = dict(runner.executor.compile_stats)
            # device profiler + exchange counters ride the task status back
            # to the coordinator, which merges them per stage for the
            # distributed EXPLAIN ANALYZE / queryStats rollup
            dsnap = runner.executor.device_stats_snapshot()
            if dsnap:
                self.stats["deviceStats"] = dsnap
            self.stats["exchange"] = runner.executor.exchange_stats_snapshot()
            isnap = runner.executor.ingest_stats
            if isnap:
                self.stats["ingest"] = dict(isnap)
            return result
        except FusedUnsupported as e:
            if strict:
                raise
            self.stats["fused_error"] = f"{type(e).__name__}: {e}"
            return None
        except Exception as e:  # noqa: BLE001
            # a CUDA or kernel error is the device path's fault: it fails
            # the task, named, and is never retried away
            if strict or device_error(e):
                raise
            # any other device-path failure (capacity retry exhaustion):
            # the interpreter fallback recomputes from the prefetched
            # sources — record why for observability
            self.stats["fused_error"] = f"{type(e).__name__}: {e}"
            return None

    def _run_interpreted(self, prefetched) -> Result:
        members = self.fused_members
        if members:
            # fused-unit fallback: interpret the chain bottom-up in this
            # one task, feeding each interior result to its consumer as a
            # prefetched source in wire (output_symbols) order — exactly
            # the pages the member would have shipped as its own task
            local = dict(prefetched)
            result = None
            for m in members:
                result = self._interpret_one(m, local)
                cols = [
                    result.batch.columns[result.layout[s.name]]
                    for s in m.root.output_symbols
                ]
                local[m.id] = [
                    Batch(cols, result.batch.num_rows, result.batch.sel).compact()
                ]
            return result
        return self._interpret_one(self.fragment, prefetched)

    def _interpret_one(self, fragment: PlanFragment, prefetched) -> Result:
        executor = WorkerExecutor(
            self.engine.catalogs,
            self.session,
            self.splits,
            self.sources,
            prefetched=prefetched,
            device=self.engine.device,
        )
        root = fragment.root
        if isinstance(root, P.Output):
            res_batch, _names = executor.execute(root)
            return Result(
                res_batch,
                {s.name: i for i, s in enumerate(root.output_symbols)},
            )
        return executor._exec(root)

    def _emit(self, result: Result) -> None:
        """The result to the host (one device-to-host read), partitioned
        per the fragment's output exchange and paginated into the output
        buffer. The read's and the serialization's times and the pages'
        bytes ride the task's stats (``d2h_ms``, ``serialize_ms``,
        ``pages_out``, ``page_bytes_out``)."""
        from trino_tpu_torch.memory import batch_nbytes

        t0 = time.perf_counter()
        batch = result.batch.compact()
        self.stats["d2h_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
        # per-task output volume — the coordinator's per-stage rows /
        # exchange-bytes merge reads these off the final task status
        self.stats["output_rows"] = int(batch.num_rows)
        self.stats["output_bytes"] = int(batch_nbytes(batch))
        n = self.n_output_partitions
        ex = self.fragment.output_exchange
        out: list[tuple[list[int], bytes]] = []
        t0 = time.perf_counter()

        def pages(b: Batch):
            # a task cancelled mid-serialization (its query killed or
            # cancelled, a speculative loser) stops and frees its
            # reservation instead of serializing pages no one reads
            for page in _paginate(b):
                if self.state != TaskState.RUNNING:
                    return
                yield page

        if ex == "broadcast":
            out = [(list(range(n)), page) for page in pages(batch)]
        elif ex == "hash" and n > 1:
            key_pairs = [
                _hash_key(batch.columns[result.layout[s.name]])
                for s in self.fragment.output_keys
            ]
            khash, _ = J.hash_keys(key_pairs)
            dest = (khash % n).numpy()
            for p in range(n):
                idx = np.nonzero(dest == p)[0]
                out += [([p], page) for page in pages(_take_rows(batch, idx))]
        else:
            # single (or hash with one consumer): everything to partition 0
            out = [([0], page) for page in pages(batch)]
        self.stats["serialize_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
        self.stats["pages_out"] = len(out)
        self.stats["page_bytes_out"] = sum(len(page) for _, page in out)
        if self.state != TaskState.RUNNING:
            return
        for parts, page in out:
            for p in parts:
                self.buffer.enqueue(p, page)

    # --- REST support -----------------------------------------------------

    def info(self) -> dict:
        return {
            "taskId": self.task_id,
            "state": self.state,
            "error": self.error,
            # worker-side classification for the coordinator's retry
            # policy; None unless FAILED
            "retryable": self.retryable,
            "fragment": self.fragment_id,
            # monotonic interval, frozen at completion (the coordinator's
            # per-stage sibling elapsed distribution reads this)
            "elapsed": (self.finished or time.monotonic()) - self.created,
            "executionPath": self.execution_path,
            "stats": self.stats,
        }

    def results(self, partition: int, token: int, max_wait: float) -> dict:
        pages, next_token, complete = self.buffer.get(partition, token, max_wait)
        # CANCELED counts as failed for consumers: abort() dropped pages, so
        # truncated output must never read as success. The same applies to a
        # FINISHED task whose buffer was aborted with undelivered pages
        # (cancel raced completion): report failed, not empty success.
        truncated = self.buffer.dropped_unacked
        canceled = self.state in (
            TaskState.CANCELED, TaskState.CANCELED_SPECULATIVE
        )
        return {
            "taskId": self.task_id,
            "pages": [base64.b64encode(p).decode() for p in pages],
            "token": next_token,
            "complete": complete
            and self.state == TaskState.FINISHED
            and not truncated,
            "failed": self.state == TaskState.FAILED or canceled or truncated,
            "error": self.error or (
                "task canceled" if canceled else
                ("task output aborted with undelivered pages" if truncated else None)
            ),
        }

    def cancel(self, speculative: bool = False) -> None:
        """Terminate a running task. ``speculative=True`` marks the loser
        of a hedged attempt pair: a sibling finished first, so this
        attempt's output is unwanted — abort the buffer so it can never
        double-deliver pages the winner already served."""
        if self.state == TaskState.RUNNING:
            self.state = (
                TaskState.CANCELED_SPECULATIVE if speculative
                else TaskState.CANCELED
            )
        # always release buffered pages (a finished task's final unacked
        # window would otherwise live as long as the registry entry)
        self.buffer.abort()


def _empty_column(t) -> Column:
    """Zero-row host column for a type: wide DECIMAL uses (0, 2) hi/lo
    lanes, strings carry an empty dictionary (string kernels require
    one)."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Dictionary

    if isinstance(t, T.DecimalType) and t.wide:
        return Column(t, torch.zeros((0, 2), dtype=torch.int64))
    return Column(
        t,
        torch.zeros(0, dtype=torch_dtype(t.storage_dtype)),
        None,
        Dictionary([]) if T.is_string(t) else None,
    )


def _paginate(batch: Batch):
    """Serialize a host batch as bounded pages (reference: PagesSerde
    splits at the output-operator page size); bounded pages are the unit
    of exchange backpressure. A page's dictionary columns carry the
    values its rows use, not the whole dictionary (the reference ships
    the whole one in every page: 1.5M ``o_comment`` values 27 times over
    in TPC-H Q13's exchange at SF1)."""
    if batch.num_rows == 0:
        return
    for lo in range(0, batch.num_rows, PAGE_ROWS):
        hi = min(lo + PAGE_ROWS, batch.num_rows)
        cols = []
        for c in batch.columns:
            valid = c.valid_mask()[lo:hi]
            cols.append(_page_column(Column(
                c.type, c.data[lo:hi], None if bool(valid.all()) else valid,
                c.dictionary,
            )))
        yield serialize_batch(Batch(cols, hi - lo))


def _hash_key(c: Column):
    """``(data, valid)`` of a partitioning key column: its values, or for
    a dictionary column a stable hash of each row's value. Each process
    (and each page) builds its own dictionary, so the same string has
    different codes in two producers: partitioning by codes would send
    one group's rows to two consumers (the reference does, and TPC-H
    Q10's groups of customer strings split at SF1)."""
    import hashlib

    d = c.dictionary
    if d is None or c.data.ndim != 1:
        return c.data, c.valid_mask()
    valid = c.valid_mask()
    codes = c.data.to(torch.int64)
    used, inverse = torch.unique(torch.where(valid, codes, 0), return_inverse=True)
    values = d.values
    hashes = torch.tensor(
        [int.from_bytes(hashlib.blake2b(repr(values[i]).encode("utf-8", "surrogatepass"),
                                        digest_size=8).digest(), "little", signed=True)
         if 0 <= i < len(values) else 0 for i in used.tolist()],
        dtype=torch.int64,
    )
    return hashes[inverse], valid


def _page_column(c: Column) -> Column:
    """``c`` with its dictionary cut to the values its valid rows use,
    codes renumbered (NULL rows keep code -1); as it is when that saves
    nothing."""
    from trino_tpu_torch.columnar import Dictionary

    d = c.dictionary
    if d is None or c.data.ndim != 1:
        return c
    valid = c.valid_mask()
    codes = c.data.to(torch.int64)
    used, inverse = torch.unique(codes[valid], return_inverse=True)
    if used.shape[0] == len(d.values):
        return c
    out = torch.full_like(codes, -1)
    out[valid] = inverse
    values = d.values
    return Column(c.type, out.to(c.data.dtype), c.valid,
                  Dictionary([values[i] for i in used.tolist()]))


def _take_rows(batch: Batch, idx: np.ndarray) -> Batch:
    """Rows ``idx`` of a host batch."""
    ti = torch.from_numpy(np.asarray(idx, dtype=np.int64))
    cols = []
    for c in batch.columns:
        valid = c.valid_mask()[ti]
        cols.append(
            Column(
                c.type,
                c.data[ti],
                None if bool(valid.all()) else valid,
                c.dictionary,
            )
        )
    return Batch(cols, len(ti))


class SqlTaskManager:
    """Task registry (reference: SqlTaskManager.java:88 — terminal tasks
    are evicted after a retention window, like the reference's
    ``info-max-age`` pruning)."""

    TERMINAL_RETENTION = 240.0

    def __init__(self, engine):
        self.engine = engine
        self._tasks: dict[str, SqlTask] = {}
        self._lock = threading.Lock()

    def _reap(self) -> None:
        now = time.monotonic()
        for tid in [
            tid
            for tid, t in self._tasks.items()
            if t.state != TaskState.RUNNING
            and now - t.created > self.TERMINAL_RETENTION
        ]:
            self._tasks[tid].buffer.abort()
            del self._tasks[tid]

    def create_or_update(
        self, task_id: str, payload: dict, trace=None
    ) -> SqlTask:
        with self._lock:
            self._reap()
            task = self._tasks.get(task_id)
            if task is None:
                task = SqlTask(task_id, self.engine, payload, trace=trace)
                self._tasks[task_id] = task
            return task

    def get(self, task_id: str) -> Optional[SqlTask]:
        with self._lock:
            return self._tasks.get(task_id)

    def cancel(self, task_id: str, speculative: bool = False) -> bool:
        task = self.get(task_id)
        if task is None:
            return False
        task.cancel(speculative=speculative)
        return True

    def tasks(self) -> list[SqlTask]:
        with self._lock:
            return list(self._tasks.values())
