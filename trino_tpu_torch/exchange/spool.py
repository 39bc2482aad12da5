"""Spooled exchange store + worker-side async spool writer.

Reference: Trino's fault-tolerant execution exchange SPI
(``plugin/trino-exchange-filesystem`` / the Tardigrade design): workers
copy finished task output to a store that outlives them, so a consumer
whose producer died re-reads the spool instead of forcing the producer
(and transitively the whole query) to re-run.

Topology here: the **coordinator** hosts one :class:`SpoolStore` (RAM or
local disk — pluggable backends behind one registry) and serves it over
``/v1/spool/...`` (server/http.py). Workers never touch the spool medium
directly: a :class:`SpoolWriter` per task asynchronously POSTs completed
``OutputBuffer`` pages to the coordinator as they are enqueued, then
publishes a completion manifest (per-partition page counts) when the task
finishes. A spooled task is *readable* only once its manifest matches the
stored pages — a half-spooled stream from a crashed worker never serves.

The read side speaks the exact task-results wire shape
(``taskId/pages/token/complete/failed``), so the existing
``ExchangeClient`` (server/task.py) pulls a spool URI unchanged.

Capacity: ``spool_max_bytes`` bounds the store. Admission evicts
oldest-FINISHED-query data first (finish order, never a live query); when
eviction cannot make room the page is rejected and the task's spool stays
incomplete — recovery then falls back to lineage re-execution instead of
serving a truncated stream.

A copy of ``trino_tpu/exchange/spool.py``: a spool directory written by either package
reads in the other (the same page files, manifest and debris rules).
"""

from __future__ import annotations

import base64
import json
import os
import queue
import threading
import time
import urllib.request
from typing import Optional

from trino_tpu_torch.obs.metrics import get_registry


class _TaskSpool:
    """Registry entry for one task's spooled output."""

    __slots__ = ("task_id", "query_id", "pages", "seqs", "bytes", "complete")

    def __init__(self, task_id: str, query_id: str):
        self.task_id = task_id
        self.query_id = query_id
        # partition -> ordered list of page handles (backend-defined)
        self.pages: dict[int, list] = {}
        # (partition, seq) already stored — re-POSTed pages dedupe
        self.seqs: set[tuple[int, int]] = set()
        self.bytes = 0
        self.complete = False


class SpoolStore:
    """Pluggable spool registry; backends implement page storage only.

    Thread-safe. Readable iff :meth:`complete` verified the producer's
    manifest against the stored page counts.
    """

    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = int(max_bytes)
        self._tasks: dict[str, _TaskSpool] = {}
        # query_id -> finish ordinal (present = evictable, lowest first)
        self._finished_queries: dict[str, int] = {}
        self._finish_seq = 0
        self._total_bytes = 0
        self._evicted_bytes = 0
        self._rejected_pages = 0
        self.reaped_entries = 0  # startup debris sweep (disk backend)
        self._lock = threading.Lock()

    # --- backend hooks ----------------------------------------------------

    def _store_page(self, task_id: str, partition: int, seq: int,
                    page: bytes):
        raise NotImplementedError

    def _load_page(self, handle) -> bytes:
        raise NotImplementedError

    def _delete_pages(self, task_id: str, handles: list) -> None:
        raise NotImplementedError

    def _persist_manifest(self, task_id: str, query_id: str,
                          partitions: dict[int, int]) -> None:
        """Durable completion marker (disk backend): a spool directory
        without one is half-written debris after a coordinator crash."""

    # --- write path (worker POSTs relayed by server/http.py) --------------

    def put_page(self, query_id: str, task_id: str, partition: int,
                 seq: int, page: bytes) -> bool:
        """Store one page; False when the capacity cap rejects it (the
        task's spool then can never complete — lineage recovery applies).
        Idempotent per (task, partition, seq)."""
        with self._lock:
            entry = self._tasks.get(task_id)
            if entry is None:
                entry = self._tasks[task_id] = _TaskSpool(task_id, query_id)
                # a new task of a query revives it (QUERY retry re-runs
                # under the same id after the first attempt finished)
                self._finished_queries.pop(query_id, None)
            if (partition, seq) in entry.seqs:
                return True
            if not self._admit_locked(len(page), protect=query_id):
                self._rejected_pages += 1
                return False
            handle = self._store_page(task_id, partition, seq, page)
            entry.pages.setdefault(partition, []).append((seq, handle))
            entry.seqs.add((partition, seq))
            entry.bytes += len(page)
            self._total_bytes += len(page)
        reg = get_registry()
        reg.counter("trino_tpu_spooled_bytes_total").inc(len(page))
        reg.counter("trino_tpu_spooled_pages_total").inc()
        return True

    def _admit_locked(self, nbytes: int, protect: str) -> bool:
        """Make room under max_bytes, evicting oldest-finished-query data
        first; never evicts ``protect`` (the writing query) or any query
        not yet finished."""
        if nbytes > self.max_bytes:
            return False
        while self._total_bytes + nbytes > self.max_bytes:
            victim = min(
                (q for q in self._finished_queries if q != protect),
                key=lambda q: self._finished_queries[q],
                default=None,
            )
            if victim is None:
                return False
            self._delete_query_locked(victim)
        return True

    def complete(self, task_id: str, query_id: str,
                 partitions: dict[int, int]) -> bool:
        """Producer manifest: ``{partition: page_count}``. Marks the task
        readable iff every counted page is stored (a cap-rejected or lost
        page keeps it incomplete)."""
        with self._lock:
            entry = self._tasks.get(task_id)
            if entry is None:
                if not partitions:  # zero-output task: trivially complete
                    entry = self._tasks[task_id] = _TaskSpool(
                        task_id, query_id
                    )
                    entry.complete = True
                    self._persist_manifest(task_id, query_id, {})
                    return True
                return False
            for p, count in partitions.items():
                if len(entry.pages.get(int(p), [])) != int(count):
                    return False
            entry.complete = True
            self._persist_manifest(
                task_id, query_id, {int(p): int(c) for p, c in partitions.items()}
            )
            return True

    # --- read path (coordinator /v1/spool results route) ------------------

    def is_complete(self, task_id: str) -> bool:
        with self._lock:
            entry = self._tasks.get(task_id)
            return entry is not None and entry.complete

    def read(self, task_id: str, partition: int, token: int
             ) -> Optional[dict]:
        """Task-results wire dict for one token window, or None when the
        task is unknown/incomplete (the route 404s; a consumer pointed
        here by recovery only ever sees complete spools)."""
        with self._lock:
            entry = self._tasks.get(task_id)
            if entry is None or not entry.complete:
                return None
            handles = [
                h for _, h in sorted(entry.pages.get(partition, []))
            ][token:]
            pages = [self._load_page(h) for h in handles]
        return {
            "taskId": task_id,
            "pages": [base64.b64encode(p).decode() for p in pages],
            "token": token + len(pages),
            "complete": True,
            "failed": False,
            "error": None,
        }

    # --- lifecycle --------------------------------------------------------

    def delete_task(self, task_id: str) -> None:
        """Drop one task's spool (aborted writer, cancelled attempt)."""
        with self._lock:
            entry = self._tasks.pop(task_id, None)
            if entry is None:
                return
            self._drop_entry_locked(entry)

    def finish_query(self, query_id: str) -> None:
        """Mark a query's spool evictable (oldest-finished-first order)."""
        with self._lock:
            if query_id not in self._finished_queries:
                self._finish_seq += 1
                self._finished_queries[query_id] = self._finish_seq

    def delete_query(self, query_id: str) -> None:
        with self._lock:
            self._delete_query_locked(query_id)

    def query_bytes(self, query_id: str) -> int:
        with self._lock:
            return sum(
                e.bytes for e in self._tasks.values()
                if e.query_id == query_id
            )

    def _delete_query_locked(self, query_id: str) -> None:
        evicted = 0
        for tid in [
            tid for tid, e in self._tasks.items() if e.query_id == query_id
        ]:
            entry = self._tasks.pop(tid)
            evicted += entry.bytes
            self._drop_entry_locked(entry)
        self._finished_queries.pop(query_id, None)
        self._evicted_bytes += evicted

    def _drop_entry_locked(self, entry: _TaskSpool) -> None:
        self._total_bytes -= entry.bytes
        self._delete_pages(
            entry.task_id,
            [h for hs in entry.pages.values() for _, h in hs],
        )

    def stats(self) -> dict:
        with self._lock:
            return {
                "tasks": len(self._tasks),
                "completeTasks": sum(
                    1 for e in self._tasks.values() if e.complete
                ),
                "bytes": self._total_bytes,
                "maxBytes": self.max_bytes,
                "evictedBytes": self._evicted_bytes,
                "rejectedPages": self._rejected_pages,
                "finishedQueries": len(self._finished_queries),
                "reapedEntries": self.reaped_entries,
            }


class MemorySpoolStore(SpoolStore):
    """Host-RAM backend: page handles ARE the bytes."""

    def _store_page(self, task_id, partition, seq, page):
        return page

    def _load_page(self, handle):
        return handle

    def _delete_pages(self, task_id, handles):
        pass


class DiskSpoolStore(SpoolStore):
    """Local-disk backend: one directory per task under ``dir`` holding
    ``p{partition}.{seq}.page`` files plus a ``manifest.json`` written
    (tmp + rename) when the producer's completion manifest verifies. The
    live registry stays in memory; the on-disk manifest exists so a
    later process can tell a COMPLETE spool from half-written debris.

    Crash safety: a coordinator ``kill -9`` leaves ``*.tmp`` files and
    manifest-less task directories behind. ``_reap_debris`` sweeps both
    on startup (counted in ``reaped_entries`` / stats ``reapedEntries``)
    and re-registers manifest-complete directories as readable, already
    finish-marked (evictable) spools."""

    def __init__(self, directory: str, max_bytes: int = 256 << 20):
        super().__init__(max_bytes)
        self.dir = directory
        os.makedirs(self.dir, exist_ok=True)
        self._reap_debris()

    def _task_dir(self, task_id: str) -> str:
        return os.path.join(self.dir, task_id.replace("/", "_"))

    def _path(self, task_id: str, partition: int, seq: int) -> str:
        return os.path.join(
            self._task_dir(task_id), f"p{partition}.{seq}.page"
        )

    def _store_page(self, task_id, partition, seq, page):
        path = self._path(task_id, partition, seq)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(page)
        os.replace(tmp, path)  # readers never see a partial file
        return path

    def _load_page(self, handle):
        with open(handle, "rb") as f:
            return f.read()

    def _delete_pages(self, task_id, handles):
        for path in handles:
            try:
                os.remove(path)
            except OSError:
                pass
        d = self._task_dir(task_id)
        try:
            os.remove(os.path.join(d, "manifest.json"))
        except OSError:
            pass
        try:
            os.rmdir(d)  # only if nothing is left in it
        except OSError:
            pass

    def _persist_manifest(self, task_id, query_id, partitions):
        d = self._task_dir(task_id)
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(
                {
                    "taskId": task_id,
                    "queryId": query_id,
                    "partitions": {str(p): c for p, c in partitions.items()},
                },
                f,
            )
        os.replace(tmp, os.path.join(d, "manifest.json"))

    def _reap_debris(self) -> None:
        """Startup sweep. Orphaned ``*.tmp`` files (anywhere) and task
        directories without a landed ``manifest.json`` are deleted;
        directories with one are rehydrated into the registry so their
        data stays readable — and reclaimable via normal eviction."""
        import shutil

        reaped = 0
        for name in sorted(os.listdir(self.dir)):
            path = os.path.join(self.dir, name)
            if not os.path.isdir(path):
                # loose file in the spool root: a torn tmp or a stray
                # page from an older layout — debris either way
                try:
                    os.remove(path)
                    reaped += 1
                except OSError:
                    pass
                continue
            manifest_path = os.path.join(path, "manifest.json")
            if not os.path.isfile(manifest_path):
                shutil.rmtree(path, ignore_errors=True)
                reaped += 1
                continue
            for fn in sorted(os.listdir(path)):
                if fn.endswith(".tmp"):
                    try:
                        os.remove(os.path.join(path, fn))
                        reaped += 1
                    except OSError:
                        pass
            if not self._rehydrate(path, manifest_path):
                shutil.rmtree(path, ignore_errors=True)
                reaped += 1
        self.reaped_entries = reaped

    def _rehydrate(self, task_dir: str, manifest_path: str) -> bool:
        """Re-register one manifest-complete spool directory; False when
        the stored pages don't match the manifest (treated as debris)."""
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
            task_id = manifest["taskId"]
            query_id = manifest["queryId"]
            partitions = {
                int(p): int(c)
                for p, c in (manifest.get("partitions") or {}).items()
            }
        except (OSError, ValueError, KeyError, TypeError):
            return False
        entry = _TaskSpool(task_id, query_id)
        for fn in os.listdir(task_dir):
            if not fn.endswith(".page"):
                continue
            try:
                stem = fn[:-len(".page")]
                p_str, seq_str = stem.lstrip("p").split(".", 1)
                partition, seq = int(p_str), int(seq_str)
            except ValueError:
                return False
            path = os.path.join(task_dir, fn)
            entry.pages.setdefault(partition, []).append((seq, path))
            entry.seqs.add((partition, seq))
            entry.bytes += os.path.getsize(path)
        for p, count in partitions.items():
            if len(entry.pages.get(p, [])) != count:
                return False
        entry.complete = True
        with self._lock:
            self._tasks[task_id] = entry
            self._total_bytes += entry.bytes
        # an inherited spool's query is long gone: evictable immediately
        self.finish_query(query_id)
        return True


def get_spool_store(engine, spool_dir: str = "",
                    max_bytes: Optional[int] = None) -> SpoolStore:
    """The coordinator's spool store, created on first use and pinned on
    the engine. The first spooling query's backend choice (RAM unless
    ``spool_dir`` is set) wins for the process — switching backends
    mid-flight would orphan live queries' spooled data; ``max_bytes`` is
    re-applied per query."""
    store = getattr(engine, "spool_store", None)
    if store is None:
        if spool_dir:
            store = DiskSpoolStore(
                spool_dir, max_bytes if max_bytes is not None else 256 << 20
            )
        else:
            store = MemorySpoolStore(
                max_bytes if max_bytes is not None else 256 << 20
            )
        engine.spool_store = store
    elif max_bytes is not None:
        store.max_bytes = int(max_bytes)
    return store


class SpoolWriter:
    """Worker-side async spooler for one task's output buffer.

    Pages enter via :meth:`offer` (called from ``OutputBuffer.enqueue``,
    off the producer's critical path — a daemon thread drains the queue
    and POSTs each page to the coordinator). :meth:`finish` blocks until
    the queue drains, then publishes the completion manifest; a worker
    dying before ``finish`` leaves the spool incomplete, which reads as
    "not recoverable from spool" — never as a truncated success.
    :meth:`abort` stops the drain and deletes the remote spool, unless
    the manifest already published (the coordinator owns complete spools;
    task cancel/reap must not yank data recovery may be serving).
    """

    def __init__(self, base_uri: str, task_id: str, query_id: str,
                 timeout: float = 10.0, http_retries: int = 3):
        self.uri = f"{base_uri.rstrip('/')}/v1/spool/{task_id}"
        self.task_id = task_id
        self.query_id = query_id
        self.timeout = float(timeout)
        self.http_retries = max(1, int(http_retries))
        self.failed = False  # a page POST was rejected or errored out
        self.completed = False  # manifest accepted by the coordinator
        self.spooled_bytes = 0
        self._counts: dict[int, int] = {}  # partition -> pages offered
        self._q: queue.Queue = queue.Queue()
        self._drained = threading.Event()
        self._aborted = False
        self._finish_lock = threading.Lock()
        self._finishing = False  # a finish() attempt is in flight
        self._finish_wave = threading.Event()  # set when that attempt ends
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    # --- producer side ----------------------------------------------------

    def offer(self, partition: int, page: bytes) -> None:
        if self._aborted or self.failed:
            return
        seq = self._counts.get(partition, 0)
        self._counts[partition] = seq + 1
        self._q.put((partition, seq, page))

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._drained.set()
                return
            partition, seq, page = item
            if self._aborted or self.failed:
                continue
            try:
                resp = self._request(
                    "POST",
                    f"{self.uri}?query={self.query_id}"
                    f"&partition={partition}&seq={seq}",
                    body=page,
                    content_type="application/octet-stream",
                )
                if not (resp or {}).get("accepted"):
                    self.failed = True  # cap-rejected: spool unusable
                else:
                    self.spooled_bytes += len(page)
            except Exception:  # noqa: BLE001 — spooling is best-effort
                self.failed = True

    def _request(self, method: str, uri: str, body: Optional[bytes] = None,
                 content_type: str = "application/json") -> Optional[dict]:
        from trino_tpu_torch.ft.retry import is_retryable
        from trino_tpu_torch.server import auth

        last: Optional[Exception] = None
        for attempt in range(1, self.http_retries + 1):
            try:
                req = urllib.request.Request(
                    uri, data=body, method=method, headers=auth.headers()
                )
                if body is not None:
                    req.add_header("Content-Type", content_type)
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    raw = r.read()
                    return json.loads(raw.decode()) if raw else None
            except Exception as e:  # noqa: BLE001
                last = e
                if not is_retryable(e) or attempt >= self.http_retries:
                    raise
                time.sleep(0.05 * attempt)
        raise last  # pragma: no cover

    # --- completion / teardown --------------------------------------------

    def finish(self, timeout: float = 60.0) -> bool:
        """Drain and publish the manifest. Idempotent; returns whether
        the coordinator verified the spool complete.

        The lock only claims the attempt — the drain wait and the manifest
        PUT run outside it, so concurrent finishers (task completion vs.
        worker drain) park on the attempt's wave event instead of
        serializing behind a mutex held across network I/O. A failed
        attempt clears ``_finishing`` so the next caller retries."""
        deadline = time.monotonic() + timeout
        while True:
            with self._finish_lock:
                if self.completed:
                    return True
                if self._aborted or self.failed:
                    return False
                if not self._finishing:
                    self._finishing = True
                    self._finish_wave.clear()
                    break
                wave = self._finish_wave
            # another caller owns the in-flight attempt: wait it out, then
            # re-check (it may have failed, in which case we retry)
            if not wave.wait(max(0.0, deadline - time.monotonic())):
                return False
        ok = False
        try:
            self._q.put_nowait(None)
            if (
                self._drained.wait(max(0.0, deadline - time.monotonic()))
                and not self.failed
            ):
                try:
                    resp = self._request(
                        "PUT",
                        f"{self.uri}/complete",
                        body=json.dumps(
                            {
                                "queryId": self.query_id,
                                "partitions": {
                                    str(p): c for p, c in self._counts.items()
                                },
                            }
                        ).encode(),
                    )
                    ok = bool((resp or {}).get("complete"))
                except Exception:  # noqa: BLE001
                    ok = False
        finally:
            with self._finish_lock:
                self.completed = ok or self.completed
                self._finishing = False
            self._finish_wave.set()
        return ok

    def abort(self) -> None:
        """Stop spooling and delete remote data — unless the manifest
        already published (complete spools belong to the coordinator's
        query lifecycle, not the producing task's)."""
        if self._aborted:
            return
        self._aborted = True
        self._q.put(None)
        if self.completed:
            return
        try:
            self._request("DELETE", self.uri)
        except Exception:  # noqa: BLE001 — best-effort
            pass
