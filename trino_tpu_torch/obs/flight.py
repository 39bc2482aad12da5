"""Crash-safe query flight recorder: a bounded on-disk lifecycle journal.

Copy of ``trino_tpu/obs/flight.py``; the journal is byte-compatible, so
either package replays a journal the other wrote. Every query's
lifecycle events (admission, state transitions, completion with
queryStats / operatorStats / error classification) go to disk as they
happen, in a format a fresh process can replay after a SIGKILL.

Format — length-prefixed CRC-checked records in segment files:

    <u32 body_len> <u32 crc32(body)> <body: UTF-8 JSON>

appended to ``flight-{seq:08d}.seg`` under the journal directory. A
segment rolls at ``segment_bytes``; oldest segments are deleted once the
journal exceeds ``max_bytes``. A SIGKILL mid-write tears at most the
final record: replay reads each segment's intact prefix and stops at the
first short or CRC-failing record, so everything already framed survives.

Writes are enqueued (``put_nowait`` — callers may be loop threads, which
must never block) and drained by one daemon writer thread that frames,
appends, and flushes. ``flush()`` barriers on durability for tests and
the read endpoints.

Readers: :func:`replay_dir` (used by ``GET /v1/query/{id}/flight``) needs
only the directory — it works against a journal whose writer process is
long dead.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
import time
import zlib
from typing import Iterator, Optional

_HEADER = struct.Struct("<II")
# replay refuses absurd lengths (a torn/corrupt header would otherwise
# read garbage as a giant record); generous vs. any real event body
_MAX_RECORD = 8 << 20
_SEGMENT_PREFIX = "flight-"
_SEGMENT_SUFFIX = ".seg"


def _segment_seq(name: str) -> Optional[int]:
    if not (
        name.startswith(_SEGMENT_PREFIX) and name.endswith(_SEGMENT_SUFFIX)
    ):
        return None
    try:
        return int(name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)])
    except ValueError:
        return None


def _segments(directory: str) -> list[tuple[int, str]]:
    """(seq, path) pairs, oldest first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        seq = _segment_seq(name)
        if seq is not None:
            out.append((seq, os.path.join(directory, name)))
    return sorted(out)


def _read_segment(path: str) -> Iterator[dict]:
    """Decode one segment's intact prefix; stops (silently) at the first
    torn or CRC-failing record — the crash-safety contract."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return
    off = 0
    while off + _HEADER.size <= len(data):
        length, crc = _HEADER.unpack_from(data, off)
        if length == 0 or length > _MAX_RECORD:
            return  # corrupt header: treat the rest as torn tail
        body = data[off + _HEADER.size: off + _HEADER.size + length]
        if len(body) < length or zlib.crc32(body) & 0xFFFFFFFF != crc:
            return  # short write or bit rot: intact prefix ends here
        try:
            rec = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return
        if isinstance(rec, dict):
            yield rec
        off += _HEADER.size + length


def replay_dir(
    directory: str, query_id: Optional[str] = None
) -> list[dict]:
    """Replay the journal under ``directory`` (all segments, oldest
    first), optionally filtered to one query. Safe against torn tails and
    concurrent writers; needs no :class:`FlightRecorder` instance."""
    out: list[dict] = []
    for _, path in _segments(directory):
        for rec in _read_segment(path):
            if query_id is None or rec.get("queryId") == query_id:
                out.append(rec)
    return out


class FlightRecorder:
    """One journal writer per coordinator process (per directory)."""

    def __init__(
        self,
        directory: str,
        max_bytes: int = 16 << 20,
        segment_bytes: int = 1 << 20,
    ):
        self.directory = directory
        self.max_bytes = max(4096, int(max_bytes))
        self.segment_bytes = max(1024, int(segment_bytes))
        os.makedirs(directory, exist_ok=True)
        # never append to a pre-crash segment: its tail may be torn, and
        # records appended after a tear would be unreachable to replay
        existing = _segments(directory)
        self._seq = (existing[-1][0] + 1) if existing else 0
        self._file = None
        self._file_bytes = 0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self.records = 0
        self.dropped = 0
        self.segments_deleted = 0
        self._writer = threading.Thread(
            target=self._drain, daemon=True, name="flight-writer"
        )
        self._writer.start()

    # --- write ------------------------------------------------------------

    def record(
        self, query_id: str, event: str, payload: Optional[dict] = None
    ) -> None:
        """Enqueue one event. Never blocks and never raises toward the
        query path (a full disk degrades to dropped counts, not failed
        queries); callers may be event-loop threads."""
        if self._closed:
            return
        rec = {"ts": time.time(), "queryId": query_id, "event": event}
        if payload:
            rec.update(payload)
        try:
            self._q.put_nowait(rec)
        except Exception:  # noqa: BLE001 — unbounded queue; belt+braces
            self.dropped += 1

    def flush(self, timeout: float = 5.0) -> bool:
        """Barrier: True once every event enqueued before this call is
        durable on disk (read endpoints and tests use it)."""
        if self._closed:
            return True
        done = threading.Event()
        self._q.put_nowait(("__flush__", done))
        return done.wait(timeout)

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._closed = True
        self._q.put_nowait(None)

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                break
            try:
                if isinstance(item, tuple) and item[0] == "__flush__":
                    self._sync()
                    item[1].set()
                else:
                    self._append(item)
            except Exception:  # noqa: BLE001 — journal loss, not query loss
                self.dropped += 1
        self._sync()
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass

    def _append(self, rec: dict) -> None:
        body = json.dumps(rec, default=str).encode("utf-8")
        frame = _HEADER.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF) + body
        f = self._open_segment(len(frame))
        f.write(frame)
        f.flush()
        self._file_bytes += len(frame)
        self.records += 1

    def _sync(self) -> None:
        if self._file is not None:
            try:
                self._file.flush()
                os.fsync(self._file.fileno())
            except OSError:
                pass

    def _open_segment(self, need: int):
        if (
            self._file is not None
            and self._file_bytes + need > self.segment_bytes
        ):
            self._sync()
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        if self._file is None:
            path = os.path.join(
                self.directory,
                f"{_SEGMENT_PREFIX}{self._seq:08d}{_SEGMENT_SUFFIX}",
            )
            self._seq += 1
            self._file = open(path, "ab")
            self._file_bytes = 0
            self._enforce_budget()
        return self._file

    def _enforce_budget(self) -> None:
        """Delete oldest whole segments while the journal exceeds
        max_bytes (the current — newest — segment always survives)."""
        segs = _segments(self.directory)
        total = 0
        sizes = []
        for seq, path in segs:
            try:
                sz = os.path.getsize(path)
            except OSError:
                sz = 0
            sizes.append((seq, path, sz))
            total += sz
        for seq, path, sz in sizes[:-1]:
            if total <= self.max_bytes:
                break
            try:
                os.unlink(path)
                self.segments_deleted += 1
                total -= sz
            except OSError:
                pass

    # --- read -------------------------------------------------------------

    def replay(self, query_id: Optional[str] = None) -> list[dict]:
        return replay_dir(self.directory, query_id)

    def snapshot(self) -> dict:
        segs = _segments(self.directory)
        nbytes = 0
        for _, path in segs:
            try:
                nbytes += os.path.getsize(path)
            except OSError:
                pass
        return {
            "directory": self.directory,
            "segments": len(segs),
            "bytes": nbytes,
            "maxBytes": self.max_bytes,
            "segmentBytes": self.segment_bytes,
            "records": self.records,
            "dropped": self.dropped,
            "segmentsDeleted": self.segments_deleted,
        }


# One recorder per directory per process — lifecycle callers (QueryManager,
# ManagedQuery, HTTP endpoints) share the writer thread and its ordering.
_RECORDERS: dict[str, FlightRecorder] = {}
_RECORDERS_LOCK = threading.Lock()


def get_recorder(
    directory: str,
    max_bytes: int = 16 << 20,
    segment_bytes: int = 1 << 20,
) -> FlightRecorder:
    directory = os.path.abspath(directory)
    with _RECORDERS_LOCK:
        rec = _RECORDERS.get(directory)
        if rec is None or rec._closed:
            rec = _RECORDERS[directory] = FlightRecorder(
                directory, max_bytes=max_bytes, segment_bytes=segment_bytes
            )
        return rec


def replay_known(
    query_id: Optional[str] = None, directory: Optional[str] = None
) -> list[dict]:
    """Replay for the HTTP endpoint. With ``directory`` (the restarted-
    coordinator path: journal on disk, writer process dead) read that
    journal; otherwise flush and replay every recorder this process has
    opened. Blocks on flush — callers must not be loop threads."""
    if directory:
        rec = _RECORDERS.get(os.path.abspath(directory))
        if rec is not None and not rec._closed:
            rec.flush(2.0)
        return replay_dir(directory, query_id)
    with _RECORDERS_LOCK:
        recs = list(_RECORDERS.values())
    out: list[dict] = []
    for rec in recs:
        if not rec._closed:
            rec.flush(2.0)
        out.extend(rec.replay(query_id))
    return out


def for_session(session) -> Optional[FlightRecorder]:
    """The session's recorder per its ``flight_dir`` props ('' = off).
    Best-effort by contract: never raises toward the query path."""
    try:
        directory = str(session.get("flight_dir") or "").strip()
        if not directory:
            return None
        return get_recorder(
            directory,
            max_bytes=int(session.get("flight_max_bytes")),
            segment_bytes=int(session.get("flight_segment_bytes")),
        )
    except Exception:  # noqa: BLE001
        return None
