"""The ingest tier: split decode, the host-to-device copy of a scan, and
the device table cache (reference: ``trino_tpu/ingest.py``).

- :class:`SplitPrefetcher` (session property ``ingest_prefetch``): a
  two-slot pipeline in which a background thread decodes split k+1 while
  the caller consumes split k; ctypes releases the GIL in the codecs, so
  host decode overlaps the device's work. The thread builds host tensors
  only. Each decode runs under the session's ``native_decode``.
- :func:`to_device` (``coalesced_h2d``, ``coalesce_min_bytes``): every
  data, valid-mask and selection buffer of a scan is packed into ONE
  pinned host buffer at 8-byte aligned offsets (16 for a DECIMAL(38) lane
  pair), moved with one ``non_blocking`` copy, and sliced back into typed
  views on the card. Every column coalesces: the reference's TPU
  workarounds (uint32 word lanes, float64 columns placed one by one) do
  not apply. A scan below ``coalesce_min_bytes`` copies column by column.
  On a CPU target the same layout is packed into an unpinned buffer and
  nothing is copied (``h2d_bytes`` stays 0).
- :class:`DeviceTableCache`: scanned tables kept resident on the card.
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

import contextvars
import hashlib
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch.columnar import Batch, Column


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
    of this process's memory of it (``memory.card_used_bytes``: the card,
    or the process's share of it)? CPU devices admit (the byte budget
    still bounds the cache)."""
    from trino_tpu_torch.memory import card_used_bytes

    dev = torch.device(device)
    if dev.type != "cuda":
        return True
    used, budget = card_used_bytes(dev)
    return used + nbytes <= fraction * budget


def device_hbm_limit(device=None) -> int:
    """The device's memory in bytes for this process (``total_memory`` of
    a CUDA device times the process's card share, ``memory.card_bytes``),
    or 0 for a device without memory accounting (the CPU): the history
    admission gate treats 0 as "inert" (reference: ``device_hbm_limit``,
    the backend's ``bytes_limit``)."""
    from trino_tpu_torch.memory import card_bytes

    try:
        if device is None or torch.device(device).type != "cuda":
            return 0
        return card_bytes(device)
    except Exception:  # noqa: BLE001
        return 0


def _add(stats: Optional[dict], key: str, value) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + value


# === double-buffered split decode ===========================================


class SplitPrefetcher:
    """Two-slot decode pipeline: a background thread decodes split k+1
    while the caller consumes split k (reference:
    ``trino_tpu/ingest.py::SplitPrefetcher``).

    Exactly two decoded splits are live at any time (one being consumed,
    one waiting in the one-slot queue). Decode errors reach the consumer
    in order; when the consumer stops early (a limit), the thread stops
    after the split it is decoding. ``native`` selects the codecs of each
    decode (``native.decode_mode``); the thread also runs in a copy of the
    caller's context."""

    _SENTINEL = object()

    def __init__(
        self,
        fn: Callable[[Any], Any],
        items: Sequence[Any],
        enabled: bool = True,
        stats: Optional[dict] = None,
        native: bool = True,
    ):
        self._fn = fn
        self._items = list(items)
        self._enabled = enabled and len(self._items) > 1
        self._stats = stats
        self._native = native

    def _decode(self, item):
        from trino_tpu_torch.native import decode_mode

        t0 = time.perf_counter()
        with decode_mode(self._native):
            out = self._fn(item)
        ms = (time.perf_counter() - t0) * 1000.0
        if self._stats is not None:
            self._stats["decode_ms"] = round(self._stats.get("decode_ms", 0.0) + ms, 3)
            _add(self._stats, "splits_decoded", 1)
            if not self._native:
                _add(self._stats, "splits_decoded_numpy", 1)
        from trino_tpu_torch.obs.metrics import get_registry

        get_registry().histogram("trino_tpu_ingest_decode_ms").observe(ms)
        return out

    def __iter__(self):
        if not self._enabled:
            for item in self._items:
                yield self._decode(item)
            return
        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()

        def worker():
            try:
                for item in self._items:
                    if stop.is_set():
                        break  # the consumer stopped (a limit): skip the tail
                    q.put(("ok", self._decode(item)))
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                q.put(("err", e))
            finally:
                q.put((None, self._SENTINEL))

        ctx = contextvars.copy_context()
        t = threading.Thread(
            target=ctx.run, args=(worker,), name="tt-ingest-decode", daemon=True
        )
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if payload is self._SENTINEL:
                    break
                if kind == "err":
                    raise payload
                yield payload
        finally:
            # unblock the producer if the consumer stopped early
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)


# === one host-to-device copy a scan =========================================

# staging buffers whose non_blocking copy may still be reading them, each
# with the event recorded after its copy; a buffer is dropped (and may be
# reused by the host allocator) only once its event has completed
_IN_FLIGHT: list[tuple[torch.cuda.Event, torch.Tensor]] = []
_IN_FLIGHT_LOCK = threading.Lock()


def _retire_copies() -> None:
    with _IN_FLIGHT_LOCK:
        _IN_FLIGHT[:] = [(e, b) for e, b in _IN_FLIGHT if not e.query()]


def _buffers(batch: Batch) -> list[torch.Tensor]:
    """The host buffers of a batch in layout order: the selection, then
    each column's data and valid mask."""
    out = [] if batch.sel is None else [batch.sel]
    for c in batch.columns:
        out.append(c.data)
        if c.valid is not None:
            out.append(c.valid)
    return out


def segment_layout(buffers: Sequence[torch.Tensor]) -> tuple[list[int], int]:
    """Byte offsets of each buffer in the staging buffer, and its length:
    each segment starts at a multiple of 8 bytes (16 for a row of two
    8-byte lanes, a DECIMAL(38) pair), so that every typed view is legal."""
    offsets, pos = [], 0
    for b in buffers:
        row = b.element_size() * (int(np.prod(b.shape[1:])) if b.dim() > 1 else 1)
        align = 16 if row == 16 else 8
        pos = (pos + align - 1) // align * align
        offsets.append(pos)
        pos += b.numel() * b.element_size()
    return offsets, (pos + 7) // 8 * 8


def _pack(buffers, offsets, nbytes: int, pin: bool) -> torch.Tensor:
    from trino_tpu_torch.native import scatter_segments

    staging = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
    arrays = [b.contiguous().reshape(-1).view(torch.uint8).numpy() for b in buffers]
    scatter_segments(arrays, offsets, staging.data_ptr(), nbytes)
    return staging


def _unpack(arena: torch.Tensor, like: Sequence[torch.Tensor], offsets) -> list[torch.Tensor]:
    out = []
    for b, off in zip(like, offsets):
        nb = b.numel() * b.element_size()
        out.append(arena[off : off + nb].view(b.dtype).reshape(b.shape))
    return out


def buffers_to_host(buffers: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Device tensors to host tensors in ONE device-to-host copy: each is
    copied into its aligned segment of one device buffer
    (:func:`segment_layout`), the buffer crosses once, and the host
    tensors are typed views of it."""
    if not buffers:
        return []
    offsets, nbytes = segment_layout(buffers)
    arena = torch.empty(nbytes, dtype=torch.uint8, device=buffers[0].device)
    for b, off in zip(buffers, offsets):
        flat = b.contiguous().reshape(-1).view(torch.uint8)
        arena[off : off + flat.numel()].copy_(flat)
    return _unpack(arena.cpu(), buffers, offsets)


def to_device(
    batch: Batch,
    device,
    coalesced: bool = True,
    min_bytes: int = 1 << 23,
    stats: Optional[dict] = None,
) -> Batch:
    """A host batch on ``device``, with its ingest accounting in ``stats``.

    With ``coalesced`` on and at least ``min_bytes`` of buffers, one
    pinned staging buffer, one ``non_blocking`` copy and typed views on
    the card (:func:`segment_layout`); else one copy a buffer. On a CPU
    target the coalesced layout is packed and viewed in place, and no
    byte is counted as copied."""
    device = torch.device(device)
    buffers = _buffers(batch)
    total = sum(b.numel() * b.element_size() for b in buffers)
    to_card = device.type != "cpu"
    if not buffers:
        return batch.to(device)
    if not coalesced or total < min_bytes:
        t0 = time.perf_counter()
        out = batch.to(device)
        if to_card:
            _add(stats, "h2d_bytes", total)
            _add(stats, "h2d_transfers", len(buffers))
            _add(stats, "h2d_ms", (time.perf_counter() - t0) * 1000.0)
        return out
    t0 = time.perf_counter()
    offsets, nbytes = segment_layout(buffers)
    if to_card:
        _retire_copies()
        staging = _pack(buffers, offsets, nbytes, pin=True)
        arena = staging.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        with _IN_FLIGHT_LOCK:
            _IN_FLIGHT.append((done, staging))
        _add(stats, "h2d_bytes", nbytes)
        _add(stats, "h2d_transfers", 1)
    else:
        arena = _pack(buffers, offsets, nbytes, pin=False)
    views = iter(_unpack(arena, buffers, offsets))
    sel = None if batch.sel is None else next(views)
    cols = []
    for c in batch.columns:
        data = next(views)
        valid = None if c.valid is None else next(views)
        cols.append(Column(c.type, data, valid, c.dictionary))
    if to_card:
        _add(stats, "h2d_ms", (time.perf_counter() - t0) * 1000.0)
    _add(stats, "coalesced_columns", len(cols))
    return Batch(cols, batch.num_rows, sel, device)


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
        from trino_tpu_torch.obs.metrics import get_registry

        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                get_registry().counter("trino_tpu_table_cache_misses_total").inc()
                return None
            self._entries.move_to_end(key)
            self.hits += 1
        get_registry().counter("trino_tpu_table_cache_hits_total").inc()
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


def parts_delta(old_parts, new_parts):
    """Classify a part-version transition (pairs from a connector's
    ``data_versions()``; reference ``trino_tpu/ingest.py:428``):
    ``("same", [])`` when identical, ``("append", new_ids)`` when every
    old ``(id, token)`` pair survives untouched and only new ids were
    added, else ``("changed", [])``. The result cache's maintain-or-
    invalidate decision; anything ambiguous (duplicate ids, removed or
    re-tokened parts) is "changed"."""
    old = dict(old_parts)
    new = dict(new_parts)
    if len(old) != len(old_parts) or len(new) != len(new_parts):
        return "changed", []
    if old == new:
        return "same", []
    appended = [pid for pid, _ in new_parts if pid not in old]
    if not appended or len(new) != len(old) + len(appended):
        return "changed", []
    for pid, tok in old_parts:
        if new.get(pid) != tok:
            return "changed", []
    return "append", appended


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
