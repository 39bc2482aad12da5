"""Query memory accounting and the device memory pool.

Counterpart of ``trino_tpu/memory.py`` (reference: ``lib/trino-memory-context``
``LocalMemoryContext.java:18`` and ``memory/MemoryPool.java``). The pool
models the card's memory; contexts form node -> query -> pool, and the
local executor reserves each plan node's output and frees its children's
once the node has materialized (``exec/local.py::LocalExecutor._exec``).
A query that passes ``query_max_memory_bytes``, or a pool that cannot
take a reservation after the revoke hook ran, raises
:class:`ExceededMemoryLimitError`, which ``errors.classify_error`` maps to
``EXCEEDED_MEMORY_LIMIT``.

What is accounted is the bytes of the batches the executor holds, not the
allocator's own peak: temporaries inside an operator and the allocator's
caching are not counted, and cached tables are the engine's, not a
query's. The coordinator-side ``ClusterMemoryManager`` belongs to the
server tier and is not ported here.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

from trino_tpu_torch.ingest import batch_nbytes  # noqa: F401  (one definition)

# the reference engine's pool (``trino_tpu/engine.py``: ``hbm_bytes``); the
# port sizes its pool from the card and keeps this for the CPU
CPU_POOL_BYTES = 16 << 30


class ExceededMemoryLimitError(Exception):
    """Reference: ``ExceededMemoryLimitException``: kills the query, not
    the engine."""


def device_pool_bytes(device) -> int:
    """The pool of an engine on ``device``: a card's total memory, or the
    reference's 16 GiB on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return CPU_POOL_BYTES


def device_free_bytes(device, pool: Optional[MemoryPool] = None) -> int:
    """Bytes a query could still allocate on ``device``: on a card, the
    free memory ``cudaMemGetInfo`` reports plus what PyTorch's caching
    allocator holds unused; elsewhere the pool's free bytes (the reference's 16 GiB
    without a pool)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
        return int(free + cached)
    return CPU_POOL_BYTES if pool is None else pool.free_bytes


class MemoryPool:
    """Byte-accounted pool shared by queries (``memory/MemoryPool.java``)."""

    def __init__(self, capacity_bytes: int, name: str = "general"):
        self.name = name
        self.capacity = int(capacity_bytes)
        self._lock = threading.Lock()
        self._query_reserved: dict[str, int] = {}

    @property
    def reserved(self) -> int:
        with self._lock:
            return sum(self._query_reserved.values())

    @property
    def free_bytes(self) -> int:
        return self.capacity - self.reserved

    def query_reserved(self, query_id: str) -> int:
        with self._lock:
            return self._query_reserved.get(query_id, 0)

    def try_reserve(self, query_id: str, bytes_: int) -> bool:
        with self._lock:
            if sum(self._query_reserved.values()) + bytes_ > self.capacity:
                return False
            self._query_reserved[query_id] = self._query_reserved.get(query_id, 0) + bytes_
            return True

    def free(self, query_id: str, bytes_: int) -> None:
        with self._lock:
            nxt = max(0, self._query_reserved.get(query_id, 0) - bytes_)
            if nxt:
                self._query_reserved[query_id] = nxt
            else:
                self._query_reserved.pop(query_id, None)

    def release_query(self, query_id: str) -> None:
        with self._lock:
            self._query_reserved.pop(query_id, None)

    def largest_query(self) -> Optional[str]:
        """TotalReservationLowMemoryKiller policy: the biggest query."""
        with self._lock:
            if not self._query_reserved:
                return None
            return max(self._query_reserved, key=self._query_reserved.get)


@dataclasses.dataclass
class QueryMemoryContext:
    """Per-query context with a hard limit (``query_max_memory``).

    ``on_revoke`` is the spill hook: called once with the shortfall before
    the reservation fails (the MemoryRevokingScheduler analog); it returns
    the bytes it freed."""

    pool: MemoryPool
    query_id: str
    max_bytes: Optional[int] = None
    on_revoke: Optional[Callable[[int], int]] = None
    peak_bytes: int = 0

    def reserved(self) -> int:
        return self.pool.query_reserved(self.query_id)

    def reserve(self, bytes_: int, what: str = "") -> None:
        if bytes_ <= 0:
            return
        at = f" at {what}" if what else ""
        cur = self.reserved()
        if self.max_bytes is not None and cur + bytes_ > self.max_bytes:
            raise ExceededMemoryLimitError(
                f"Query exceeded memory limit of {self.max_bytes} bytes: "
                f"reserved={cur} request={bytes_}{at}"
            )
        if not self.pool.try_reserve(self.query_id, bytes_):
            if self.on_revoke is not None:
                self.on_revoke(bytes_)
            if not self.pool.try_reserve(self.query_id, bytes_):
                raise ExceededMemoryLimitError(
                    f"Memory pool '{self.pool.name}' exhausted: "
                    f"capacity={self.pool.capacity} free={self.pool.free_bytes} "
                    f"request={bytes_}{at}"
                )
        self.peak_bytes = max(self.peak_bytes, self.reserved())

    def free(self, bytes_: int) -> None:
        if bytes_ > 0:
            self.pool.free(self.query_id, bytes_)

    def close(self) -> None:
        self.pool.release_query(self.query_id)
