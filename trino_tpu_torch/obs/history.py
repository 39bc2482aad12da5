"""Persistent query history: per-fingerprint observed execution truth.

Copy of ``trino_tpu/obs/history.py`` with its imports cut over to this
package. :class:`QueryHistoryStore` persists, keyed by the program-cache
fingerprint (``planner/canonicalize.py``), what a finished query already
observed: per-site final capacities with provenance, padding ratio,
overflow retries, compile halvings, the allocator's peak device bytes,
elapsed wall, batch sizes, operator row counts, as EWMA or
bounded-sample aggregates.

Three consumers:

- **seed** — ``exec/fragments.py::_seed_history`` reads an entry's
  ``capacities`` (restart-stable site names like ``join@3#0``), so a
  fresh engine's run of a query an earlier process ran starts its sites
  at the observed sizes (provenance ``history``) with no retry and no
  halving.
- **admit** — ``server/querymanager.py::_history_hbm_gate`` hands the
  entry's observed ``peak_hbm_bytes`` to the device-memory gate
  (``server/resourcegroups.py``, which reads ``torch.cuda.mem_get_info``)
  before the query runs.
- **surface** — ``GET /v1/history`` and ``system.runtime.history`` read
  :meth:`entries`.

The store is one schema-versioned JSON document written tmp +
``os.replace`` (atomic on POSIX), bounded by entries and by bytes (least
recently used first), and tolerant of a corrupt file: a truncated or
garbage file starts the store fresh and counts
``trino_tpu_history_corrupt_recovered_total``. An empty ``path`` keeps
the store in memory. A file written by either package reads in the
other (same schema, same keys).
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import threading
import time
from typing import Any, Optional

SCHEMA_VERSION = 1
# EWMA weight for scalar aggregates: recent runs dominate (matches the
# latency EWMA in the failure detector), but one outlier can't erase the
# regime
_ALPHA = 0.25
# bounded raw elapsed samples per entry — enough for p50/p90 without
# letting a hot fingerprint grow its record unboundedly
_SAMPLE_CAP = 32
_BATCH_CAP = 8


class HistoryHbmRejected(Exception):
    """Admission rejected a query whose fingerprint's OBSERVED peak HBM
    cannot fit the device — classified EXCEEDED_MEMORY_LIMIT /
    INSUFFICIENT_RESOURCES (errors.py), the same class the compile-time
    failure it preempts would have carried."""

    def __init__(self, fingerprint: str, peak_hbm_bytes: int, limit: int):
        self.fingerprint = fingerprint
        self.peak_hbm_bytes = int(peak_hbm_bytes)
        self.limit = int(limit)
        super().__init__(
            f"query rejected at admission: observed peak HBM "
            f"{self.peak_hbm_bytes} bytes for fingerprint {fingerprint} "
            f"exceeds the device limit {self.limit} bytes"
        )


def _ewma(old: Optional[float], new: float) -> float:
    if old is None:
        return float(new)
    return (1.0 - _ALPHA) * float(old) + _ALPHA * float(new)


def _percentile(xs: list, p: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    return float(ys[min(len(ys) - 1, int(p / 100.0 * len(ys)))])


class QueryHistoryStore:
    """Per-fingerprint observed-stats store with atomic persistence.

    Thread-safe; one instance is shared by every query of an engine that
    resolved the same ``history_dir``. Cross-process concurrent writers
    are safe by construction (tmp + rename never tears the file) and
    additive: each record re-reads the file, adopts fingerprints it has
    not seen and flushes under one lock on ``<path>.lock``, so two
    engines recording disjoint workloads into one directory both survive
    (the reference's store holds no such lock and can lose a writer's
    entry to another's flush of an older read).
    """

    def __init__(
        self,
        path: str = "",
        max_entries: int = 256,
        max_bytes: int = 1 << 20,
    ):
        self.path = path or ""
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max(4096, int(max_bytes))
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}
        self._seq = 0
        self.corrupt_recovered = 0
        self.records = 0
        self.evictions = 0
        if self.path:
            with self._lock:
                self._entries = self._read_disk_locked()

    # --- persistence ------------------------------------------------------

    def _read_disk_locked(self) -> dict[str, dict]:
        """Load the on-disk document; corrupt/alien content starts fresh
        (counted) rather than failing the query that touched history."""
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if (
                not isinstance(doc, dict)
                or doc.get("version") != SCHEMA_VERSION
                or not isinstance(doc.get("entries"), dict)
            ):
                raise ValueError("unrecognized history schema")
            entries = {
                str(fp): ent
                for fp, ent in doc["entries"].items()
                if isinstance(ent, dict)
            }
            for ent in entries.values():
                self._seq = max(self._seq, int(ent.get("seq", 0)))
            return entries
        except FileNotFoundError:
            return {}
        except Exception:  # noqa: BLE001 — truncated/garbage/foreign file
            self.corrupt_recovered += 1
            try:
                from trino_tpu_torch.obs.metrics import get_registry

                get_registry().counter(
                    "trino_tpu_history_corrupt_recovered_total"
                ).inc()
            except Exception:  # noqa: BLE001
                pass
            return {}

    def _flush_locked(self) -> None:
        if not self.path:
            return
        doc = {"version": SCHEMA_VERSION, "entries": self._entries}
        tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)  # atomic: readers never see a tear
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    @contextlib.contextmanager
    def _disk_lock(self):
        """An exclusive advisory lock on ``<path>.lock`` from the adopting
        read to the flush: a concurrent writer (another store on the same
        file, in this process or another) waits, instead of replacing the
        file with a copy it read before this record's flush."""
        if not self.path:
            yield
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd = os.open(f"{self.path}.lock", os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # releases the lock

    def _adopt_disk_locked(self) -> None:
        """Concurrent-writer merge: before overwriting the file, adopt
        fingerprints another process flushed since we last read it."""
        if not self.path:
            return
        for fp, ent in self._read_disk_locked().items():
            ours = self._entries.get(fp)
            if ours is None or int(ent.get("count", 0)) > int(
                ours.get("count", 0)
            ):
                self._entries[fp] = ent

    # --- record -----------------------------------------------------------

    def record(self, fingerprint: str, observed: dict) -> None:
        """Fold one finished query's observed stats into the fingerprint's
        aggregate entry and flush. ``observed`` keys (all optional):
        elapsed_ms, rows, overflow_retries, compile_halvings,
        padding_ratio, shuffle_rows, flops, peak_hbm_bytes, batch_size,
        capacities ({stable_site: {value, provenance}}),
        operators ({stable_site: {kind, rows_in, rows_out}})."""
        from trino_tpu_torch.server.eventloop import assert_not_loop_thread

        # record() flushes the JSON document to disk under _lock; callers
        # are query-finalize paths on dispatch workers, never the reactor
        assert_not_loop_thread("QueryHistoryStore.record")
        with self._lock, self._disk_lock():
            self._adopt_disk_locked()
            self._seq += 1
            ent = self._entries.get(fingerprint)
            if ent is None:
                ent = {"count": 0, "capacities": {}, "elapsed_samples": []}
                self._entries[fingerprint] = ent
            ent["count"] = int(ent.get("count", 0)) + 1
            ent["seq"] = self._seq
            ent["last_ts"] = time.time()
            el = observed.get("elapsed_ms")
            if el is not None:
                ent["elapsed_ms"] = _ewma(ent.get("elapsed_ms"), float(el))
                samples = list(ent.get("elapsed_samples") or [])
                samples.append(round(float(el), 3))
                ent["elapsed_samples"] = samples[-_SAMPLE_CAP:]
            for key in ("rows", "overflow_retries", "compile_halvings"):
                v = observed.get(key)
                if v is not None:
                    ent[key] = int(v)
                    mk = f"max_{key}"
                    ent[mk] = max(int(ent.get(mk, 0)), int(v))
            for key in ("padding_ratio", "shuffle_rows"):
                v = observed.get(key)
                if v is not None:
                    ent[key] = round(_ewma(ent.get(key), float(v)), 4)
            v = observed.get("flops")
            if isinstance(v, (int, float)):
                ent["flops"] = float(v)
            v = observed.get("peak_hbm_bytes")
            if isinstance(v, (int, float)) and v > 0:
                ent["peak_hbm_bytes"] = max(
                    int(ent.get("peak_hbm_bytes", 0)), int(v)
                )
            v = observed.get("batch_size")
            if v is not None:
                sizes = list(ent.get("batch_sizes") or [])
                sizes.append(int(v))
                ent["batch_sizes"] = sizes[-_BATCH_CAP:]
            for site, cap in (observed.get("capacities") or {}).items():
                try:
                    val = int(cap.get("value", 0))
                    prov = str(cap.get("provenance", ""))
                except (AttributeError, TypeError, ValueError):
                    continue
                if val <= 0:
                    continue
                old = ent["capacities"].get(site)
                if old is not None and "+halved" not in prov:
                    # growth is monotone truth (the ladder found this
                    # floor); a halved site's smaller value IS the truth —
                    # the bigger shape failed to compile/allocate
                    val = max(val, int(old.get("value", 0)))
                ent["capacities"][site] = {"value": val, "provenance": prov}
            for site, op in (observed.get("operators") or {}).items():
                # per-operator row flow as EWMAs; reduction_ratio on a
                # partial-agg/exchange site is the seed the mid-query
                # adaptive-execution roadmap item (a) consumes
                try:
                    rin = int(op.get("rows_in", 0) or 0)
                    rout = int(op.get("rows_out", 0) or 0)
                    kind = str(op.get("kind", ""))
                except (AttributeError, TypeError, ValueError):
                    continue
                ops = ent.setdefault("operators", {})
                old = ops.get(site) or {}
                rec = {
                    "kind": kind or old.get("kind", ""),
                    "rows_in": round(_ewma(old.get("rows_in"), float(rin)), 1),
                    "rows_out": round(
                        _ewma(old.get("rows_out"), float(rout)), 1
                    ),
                }
                if rin > 0:
                    # significant digits, not decimal places: a 3/60175
                    # partial-agg reduction must not round to 0.0
                    rec["reduction_ratio"] = float(
                        "%.4g" % _ewma(old.get("reduction_ratio"), rout / rin)
                    )
                elif "reduction_ratio" in old:
                    rec["reduction_ratio"] = old["reduction_ratio"]
                ops[site] = rec
            self.records += 1
            self._evict_locked()
            self._flush_locked()
        try:
            from trino_tpu_torch.obs.metrics import get_registry

            get_registry().counter("trino_tpu_history_records_total").inc()
        except Exception:  # noqa: BLE001
            pass

    def _evict_locked(self) -> None:
        evicted = 0
        while len(self._entries) > self.max_entries:
            self._pop_lru_locked()
            evicted += 1
        # byte bound: the serialized document must fit max_bytes, so even
        # a store of few-but-huge entries stays bounded on disk
        while len(self._entries) > 1 and self._doc_bytes_locked() > self.max_bytes:
            self._pop_lru_locked()
            evicted += 1
        if evicted:
            self.evictions += evicted
            try:
                from trino_tpu_torch.obs.metrics import get_registry

                get_registry().counter(
                    "trino_tpu_history_evictions_total"
                ).inc(evicted)
            except Exception:  # noqa: BLE001
                pass

    def _doc_bytes_locked(self) -> int:
        return len(
            json.dumps({"version": SCHEMA_VERSION, "entries": self._entries})
        )

    def _pop_lru_locked(self) -> None:
        lru = min(
            self._entries, key=lambda fp: int(self._entries[fp].get("seq", 0))
        )
        self._entries.pop(lru, None)

    # --- read -------------------------------------------------------------

    def get(self, fingerprint: str, touch: bool = True) -> Optional[dict]:
        """The fingerprint's aggregate entry (a private copy), bumping its
        LRU recency unless ``touch=False`` (admission peeks must not keep
        an entry alive that no query ever re-runs)."""
        with self._lock:
            ent = self._entries.get(fingerprint)
            if ent is None:
                return None
            if touch:
                self._seq += 1
                ent["seq"] = self._seq
            return json.loads(json.dumps(ent))

    def entries(self) -> list[tuple[str, dict]]:
        """(fingerprint, summary) pairs, most-recently-used first, with
        elapsed percentiles computed from the bounded sample window."""
        with self._lock:
            items = sorted(
                self._entries.items(),
                key=lambda kv: -int(kv[1].get("seq", 0)),
            )
            out = []
            for fp, ent in items:
                s = json.loads(json.dumps(ent))
                samples = s.pop("elapsed_samples", []) or []
                s["elapsed_p50_ms"] = round(_percentile(samples, 50), 3)
                s["elapsed_p90_ms"] = round(_percentile(samples, 90), 3)
                out.append((fp, s))
            return out

    def snapshot(self) -> dict:
        """Store-level stats + entries — the ``GET /v1/history`` body."""
        with self._lock:
            nbytes = self._doc_bytes_locked()
        rows = self.entries()
        return {
            "path": self.path,
            "entries": len(rows),
            "bytes": nbytes,
            "maxEntries": self.max_entries,
            "maxBytes": self.max_bytes,
            "records": self.records,
            "evictions": self.evictions,
            "corruptRecovered": self.corrupt_recovered,
            "fingerprints": [
                dict(fingerprint=fp, **ent) for fp, ent in rows
            ],
        }
