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
query's. The coordinator-side :class:`ClusterMemoryManager` (a copy of
the reference's) sums the reservations the workers report on their
announcements and kills the largest query across the cluster.

Several processes may share one card (a coordinator and its workers on
one H100): each then holds a share of it (:func:`set_card_share`), and
every budget of the process reads that share instead of the whole card
(:func:`card_bytes`, :func:`card_used_bytes`). A TPU chip is never shared
by processes, so the reference has no counterpart.
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


# this process's share of its card (1.0: the whole card)
_CARD_SHARE = 1.0


def set_card_share(fraction: float, device=None) -> None:
    """Hold this process to ``fraction`` of its card: every budget reads
    the share (:func:`card_bytes`), and on a card
    ``torch.cuda.set_per_process_memory_fraction`` makes it a bound of the
    caching allocator. Set before the engine is built."""
    import torch

    global _CARD_SHARE
    fraction = float(fraction)
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"a card share is in (0, 1], got {fraction}")
    _CARD_SHARE = fraction
    if device is not None and torch.device(device).type == "cuda" and fraction < 1.0:
        dev = torch.device(device)
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        torch.cuda.set_per_process_memory_fraction(fraction, index)


def card_share() -> float:
    return _CARD_SHARE


def card_bytes(device) -> int:
    """This process's bytes of the card ``device``: its total memory times
    the process's share; 0 for a device without memory accounting."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.get_device_properties(dev).total_memory * _CARD_SHARE)


def card_used_bytes(device) -> tuple[int, int]:
    """``(used, budget)`` of the card ``device`` for this process. With the
    whole card, ``used`` is what ``cudaMemGetInfo`` reports in use by
    every process; with a share, what this process's caching allocator
    holds (the other processes hold their own shares)."""
    import torch

    dev = torch.device(device)
    if _CARD_SHARE >= 1.0:
        free, total = torch.cuda.mem_get_info(dev)
        return int(total - free), int(total)
    return int(torch.cuda.memory_reserved(dev)), card_bytes(dev)


def device_pool_bytes(device) -> int:
    """The pool of an engine on ``device``: this process's share of a
    card (:func:`card_bytes`), or the reference's 16 GiB on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return card_bytes(dev)
    return CPU_POOL_BYTES


def device_free_bytes(device, pool: Optional[MemoryPool] = None) -> int:
    """Bytes a query could still allocate on ``device``: on a card, the
    process's budget less what it uses (:func:`card_used_bytes`) plus
    what PyTorch's caching allocator holds unused; elsewhere the pool's
    free bytes (the reference's 16 GiB without a pool)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        used, budget = card_used_bytes(dev)
        cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
        return int(max(0, budget - used) + cached)
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


class ClusterMemoryManager:
    """Coordinator-side cluster-wide memory enforcement.

    Reference: ``memory/ClusterMemoryManager.java:89,104`` — workers report
    their pool state (here: piggybacked on the discovery announce), the
    coordinator aggregates reservations per query across every node, and
    when the cluster total exceeds the limit it kills the query with the
    largest total reservation (``TotalReservationLowMemoryKiller``).
    """

    def __init__(
        self,
        local_pool: MemoryPool,
        cluster_limit_bytes: int,
        kill_fn: Callable[[str, str], bool],
    ):
        self.local_pool = local_pool
        self.limit = int(cluster_limit_bytes)
        self.kill_fn = kill_fn  # (query_id, message) -> killed?
        self._lock = threading.Lock()
        self._nodes: dict[str, dict[str, int]] = {}  # node -> query -> bytes
        self.kills: list[str] = []  # query ids killed (observability)

    def update(self, node_id: str, memory_info: Optional[dict]) -> None:
        """Record one worker's per-query reservations and re-check."""
        if memory_info is None:
            return
        with self._lock:
            self._nodes[node_id] = {
                str(q): int(b)
                for q, b in (memory_info.get("queryReservations") or {}).items()
            }
        self.check()

    def remove_node(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def cluster_reservations(self) -> dict[str, int]:
        """Per-query bytes summed over the coordinator + every worker."""
        totals: dict[str, int] = {}
        with self._lock:
            snapshots = list(self._nodes.values())
        for per_query in snapshots:
            for q, b in per_query.items():
                totals[q] = totals.get(q, 0) + b
        with self.local_pool._lock:
            for q, b in self.local_pool._query_reserved.items():
                totals[q] = totals.get(q, 0) + b
        return totals

    def check(self) -> Optional[str]:
        """Kill the largest query if the cluster total exceeds the limit.

        Returns the killed query id (None when under the limit)."""
        totals = self.cluster_reservations()
        used = sum(totals.values())
        if used <= self.limit or not totals:
            return None
        # walk candidates in descending reservation order until one kill
        # lands: the largest query may have already finished while its
        # reservations were still being reported by worker announces
        # (reference: TotalReservationLowMemoryKiller skips completed
        # queries and keeps looking for a live victim)
        for victim in sorted(totals, key=lambda q: totals[q], reverse=True):
            if victim in self.kills:
                continue
            message = (
                f"Query killed by the cluster memory manager: cluster "
                f"memory used {used} bytes exceeds the limit {self.limit} "
                f"bytes (this query reserved {totals[victim]} across the "
                f"cluster)"
            )
            if self.kill_fn(victim, message):
                self.kills.append(victim)
                return victim
        return None

    def info(self) -> dict:
        totals = self.cluster_reservations()
        return {
            "clusterMemoryLimitBytes": self.limit,
            "clusterReservedBytes": sum(totals.values()),
            "queryReservations": totals,
            "killedQueries": list(self.kills),
        }
