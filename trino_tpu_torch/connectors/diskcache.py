"""Shared on-disk split cache for generated (dbgen) connector data.

dbgen output is a pure function of (schema, table, columns, split), so a
split batch generated by one process is bit-identical in every other:
cold benchmark subprocesses and fresh test sessions can read back the
bytes a previous run wrote instead of regenerating them (SF1 lineitem
generation dominates cold-start wall time otherwise).

Entry format: one ``.npz`` archive (plain arrays, ``allow_pickle=False``)
whose ``hdr`` member is a JSON header — column types round-trip through
``str(type)`` / ``T.parse_type`` like the plan serde, dictionary values
ride as JSON strings. Writes are atomic (tmp + ``os.replace``, the
``dbgen.text_pool`` idiom), so concurrent processes race benignly: last
writer wins with identical bytes, readers never see a torn file.

The directory is size-bounded (oldest-mtime eviction after each write).
Environment knobs, the reference's:

- ``TRINO_TPU_DBGEN_CACHE``: ``0``/``off`` disables the cache.
- ``TRINO_TPU_DBGEN_CACHE_BYTES``: size bound (default 1 GiB).

A copy of ``trino_tpu/connectors/diskcache.py`` on host tensors. The
directory is the port's own, ``<repo>/.cache/dbgen_torch``, never the
reference's ``.cache/dbgen`` (a directory named in
``TRINO_TPU_DBGEN_CACHE`` is the reference's, and the port ignores it).
Hits and misses are counted on the cache object, which the tpch and
tpcds connectors expose (``disk_cache_stats``).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Optional

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, Dictionary, as_tensor

_FORMAT_VERSION = 1
_DEFAULT_LIMIT = 1 << 30


def _count(name: str) -> None:
    """An ingest-tier counter, best-effort (the cache works while a test
    resets the metrics registry)."""
    try:
        from trino_tpu_torch.obs.metrics import get_registry

        get_registry().counter(name).inc()
    except Exception:  # noqa: BLE001
        pass


def _cache_dir() -> Optional[str]:
    env = os.environ.get("TRINO_TPU_DBGEN_CACHE")
    if env is not None and env.strip().lower() in ("", "0", "off", "false", "none"):
        return None
    return os.path.join(
        os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        ),
        ".cache",
        "dbgen_torch",
    )


def _cache_limit() -> int:
    try:
        return int(
            os.environ.get("TRINO_TPU_DBGEN_CACHE_BYTES", _DEFAULT_LIMIT)
        )
    except (TypeError, ValueError):
        return _DEFAULT_LIMIT


class DbgenDiskCache:
    """Size-bounded directory of serialized split batches, shared across
    processes. All methods are best-effort: any I/O or format problem
    degrades to a miss (the caller regenerates), never an error."""

    def __init__(
        self, directory: Optional[str] = None, max_bytes: Optional[int] = None
    ):
        self.directory = directory if directory is not None else _cache_dir()
        self.max_bytes = max_bytes if max_bytes is not None else _cache_limit()
        self.hits = 0
        self.misses = 0

    @property
    def enabled(self) -> bool:
        return self.directory is not None

    def _path(self, key: tuple) -> str:
        digest = hashlib.sha256(
            json.dumps([_FORMAT_VERSION, list(key)], default=str).encode()
        ).hexdigest()[:24]
        # a human-greppable prefix (connector.schema.table) aids debugging
        prefix = ".".join(str(k) for k in key[:3])[:48]
        safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in prefix)
        return os.path.join(self.directory, f"{safe}.{digest}.npz")

    # --- read -------------------------------------------------------------

    def get(self, key: tuple) -> Optional[Batch]:
        if not self.enabled:
            return None
        path = self._path(key)
        try:
            with np.load(path, allow_pickle=False) as z:
                hdr = json.loads(bytes(z["hdr"]).decode())
                cols = []
                for i, c in enumerate(hdr["cols"]):
                    cols.append(
                        Column(
                            T.parse_type(c["t"]),
                            as_tensor(z[f"d{i}"]),
                            as_tensor(z[f"v{i}"]) if c["valid"] else None,
                            Dictionary(c["dict"])
                            if c["dict"] is not None
                            else None,
                        )
                    )
            os.utime(path)  # LRU-ish: refresh mtime so eviction spares it
        except (OSError, KeyError, ValueError, json.JSONDecodeError):
            self.misses += 1
            _count("trino_tpu_ingest_disk_cache_misses_total")
            return None
        self.hits += 1
        _count("trino_tpu_ingest_disk_cache_hits_total")
        return Batch(cols, hdr["num_rows"])

    # --- write ------------------------------------------------------------

    def put(self, key: tuple, batch: Batch) -> None:
        if not self.enabled:
            return
        hdr = {"num_rows": int(batch.num_rows), "cols": []}
        arrays: dict[str, np.ndarray] = {}
        for i, c in enumerate(batch.columns):
            data = c.data.cpu().numpy()
            arrays[f"d{i}"] = data
            if c.valid is not None:
                arrays[f"v{i}"] = c.valid.cpu().numpy()
            hdr["cols"].append(
                {
                    "t": str(c.type),
                    "valid": c.valid is not None,
                    "dict": (
                        list(c.dictionary.values)
                        if c.dictionary is not None
                        else None
                    ),
                }
            )
        try:
            os.makedirs(self.directory, exist_ok=True)
            path = self._path(key)
            buf = io.BytesIO()
            np.savez(
                buf,
                hdr=np.frombuffer(json.dumps(hdr).encode(), dtype=np.uint8),
                **arrays,
            )
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(buf.getvalue())
            os.replace(tmp, path)
            self._evict()
        except OSError:
            return  # read-only filesystem, disk full, …: cache stays cold

    def stats(self) -> dict:
        return {"enabled": self.enabled, "hits": self.hits, "misses": self.misses}

    def _evict(self) -> None:
        """Drop oldest-mtime entries until the directory fits the bound."""
        try:
            entries = []
            with os.scandir(self.directory) as it:
                for e in it:
                    if e.name.endswith(".npz"):
                        st = e.stat()
                        entries.append((st.st_mtime, st.st_size, e.path))
            total = sum(s for _, s, _ in entries)
            if total <= self.max_bytes:
                return
            for _, size, path in sorted(entries):
                try:
                    os.remove(path)
                except OSError:
                    continue
                total -= size
                if total <= self.max_bytes:
                    return
        except OSError:
            return
