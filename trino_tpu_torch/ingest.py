"""Device table cache: scanned tables kept resident on the card.

Counterpart of ``trino_tpu/ingest.py::DeviceTableCache`` and
``table_cache_key`` (the rest of the reference's ingest tier — split
prefetch, coalesced host-to-device copies — is ROADMAP Queue 1 item 7).
A warm repeat scan of an unchanged table returns the device batch of the
first scan, whole: device columns, valid masks and dictionaries; it skips
reading the splits, concatenating them on the host and copying them to
the card.

Keys carry the connector's ``data_version`` and a fingerprint of the
split list, so a write to a table (the memory connector bumps its
``_version``) makes the old entry unreachable and the next scan misses.
Entries are evicted least recently used first under the session's
``table_cache_max_bytes``.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Iterable, Optional, Sequence

import torch

from trino_tpu_torch.columnar import Batch


def batch_nbytes(batch: Batch) -> int:
    """Device bytes of a batch's columns, valid masks and selection."""
    total = 0 if batch.sel is None else batch.sel.numel()
    for c in batch.columns:
        total += c.data.numel() * c.data.element_size()
        if c.valid is not None:
            total += c.valid.numel()
    return total


def device_headroom_ok(nbytes: int, device, fraction: float = 0.9) -> bool:
    """Would pinning ``nbytes`` more on ``device`` stay under ``fraction``
    of its memory? CPU devices admit (the byte budget still bounds the
    cache)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return True
    free, total = torch.cuda.mem_get_info(dev)
    return (total - free) + nbytes <= fraction * total


class DeviceTableCache:
    """Byte-budget LRU of device-resident scanned tables."""

    def __init__(self):
        self._entries: "OrderedDict[tuple, tuple[Batch, int]]" = OrderedDict()
        self._lock = threading.Lock()
        self.total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejections = 0

    def lookup(self, key: tuple) -> Optional[Batch]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return ent[0]

    def admit(self, key: tuple, batch: Batch, nbytes: int, max_bytes: int) -> bool:
        if nbytes > max_bytes or not device_headroom_ok(nbytes, batch.device):
            with self._lock:
                self.rejections += 1
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.total_bytes -= old[1]
            while self._entries and self.total_bytes + nbytes > max_bytes:
                _, (_b, nb) = self._entries.popitem(last=False)
                self.total_bytes -= nb
                self.evictions += 1
            self._entries[key] = (batch, nbytes)
            self.total_bytes += nbytes
        return True

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self.total_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "rejections": self.rejections,
            }


def splits_fingerprint(splits: Sequence) -> str:
    """Stable identity of a split list."""
    blob = repr([(s.index, s.total, s.info) for s in splits])
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def table_cache_key(
    catalog: str,
    schema: str,
    table: str,
    version: Any,
    column_names: Iterable[str],
    splits: Sequence,
    device,
) -> tuple:
    return (
        catalog,
        schema,
        table,
        version,
        tuple(column_names),
        splits_fingerprint(splits),
        str(torch.device(device)),
    )
