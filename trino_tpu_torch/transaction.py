"""Transaction management.

Reference: ``core/trino-main/.../transaction/InMemoryTransactionManager.java``
— per-connector ``ConnectorTransactionHandle``s coordinated by a
transaction id; autocommit wraps single statements; explicit transactions
span statements and abort on access conflicts.

v1 scope matches the engine's connector surface: the memory connector is
the only writable store, so commit/rollback snapshot-and-restore its
table data; read-only connectors participate trivially (their handle is a
marker). Isolation is snapshot-at-begin for writes (READ COMMITTED-ish,
single-writer — the reference's default is also READ UNCOMMITTED-adjacent
per connector capability). The port's copy of ``trino_tpu/transaction.py``;
the memory connector's ``snapshot_state``/``restore_state`` bump its data
version, so a rollback also retires the device table cache's entries and
the staged device slabs of the rolled-back tables."""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Optional

_txn_counter = itertools.count(1)


class TransactionError(Exception):
    pass


@dataclasses.dataclass
class TransactionInfo:
    transaction_id: str
    create_time: float
    autocommit: bool
    snapshots: dict[str, Any] = dataclasses.field(default_factory=dict)
    state: str = "ACTIVE"  # ACTIVE | COMMITTED | ABORTED
    last_access: float = 0.0
    busy: int = 0  # statements currently executing in this transaction


class TransactionManager:
    """Registry + 2-phase-ish commit over snapshot-capable connectors."""

    def __init__(self, catalogs, idle_timeout: float = 300.0):
        self.catalogs = catalogs
        # reference expires idle transactions (transaction.idle-timeout);
        # without this a client that BEGINs and disconnects holds the
        # write lock forever
        self.idle_timeout = idle_timeout
        self._lock = threading.Lock()
        self._transactions: dict[str, TransactionInfo] = {}
        # single-writer enforcement: an explicit transaction holds this for
        # its whole lifetime; autocommit writes take it per statement. This
        # is what makes snapshot-at-begin rollback sound — no concurrent
        # committed write can be erased because none can start.
        # (threading.Lock may be released from a different thread than the
        # acquirer — required: HTTP requests hop threads.)
        self.write_lock = threading.Lock()

    def begin(self, autocommit: bool = False) -> str:
        self.expire_idle()
        if not self.write_lock.acquire(timeout=60):
            raise TransactionError("timed out waiting for the write lock")
        now = time.time()
        txn = TransactionInfo(
            f"txn_{next(_txn_counter)}", now, autocommit, last_access=now
        )
        with self._lock:
            self._transactions[txn.transaction_id] = txn
        # snapshot writable connectors (memory): rollback restores
        for name in self.catalogs.names():
            conn = self.catalogs.get(name)
            snap = getattr(conn, "snapshot_state", None)
            if snap is not None:
                txn.snapshots[name] = snap()
        return txn.transaction_id

    def get(self, txn_id: str) -> TransactionInfo:
        with self._lock:
            txn = self._transactions.get(txn_id)
        if txn is None:
            raise TransactionError(f"unknown transaction: {txn_id}")
        txn.last_access = time.time()
        return txn

    def expire_idle(self) -> None:
        """Roll back ACTIVE transactions idle beyond ``idle_timeout`` so an
        abandoned BEGIN eventually releases the write lock. Transactions
        with a statement mid-flight (busy > 0) are never expired."""
        now = time.time()
        for t in self.active_transactions():
            if t.busy == 0 and now - max(t.last_access, t.create_time) > self.idle_timeout:
                try:
                    self.rollback(t.transaction_id)
                except TransactionError:
                    pass  # raced with a concurrent commit/rollback

    def _transition(self, txn_id: str, new_state: str) -> TransactionInfo:
        """Atomically move an ACTIVE transaction to a terminal state. Exactly
        one caller wins (commit vs concurrent expire-rollback race); losers
        get TransactionError and must NOT touch snapshots or the lock."""
        with self._lock:
            txn = self._transactions.get(txn_id)
            if txn is None:
                raise TransactionError(f"unknown transaction: {txn_id}")
            if txn.state != "ACTIVE":
                raise TransactionError(f"transaction {txn_id} is {txn.state}")
            txn.state = new_state
        return txn

    def commit(self, txn_id: str) -> None:
        txn = self._transition(txn_id, "COMMITTED")
        txn.snapshots.clear()
        self._finish(txn_id)

    def rollback(self, txn_id: str) -> None:
        txn = self._transition(txn_id, "ABORTED")
        for name, snap in txn.snapshots.items():
            conn = self.catalogs.get(name)
            restore = getattr(conn, "restore_state", None)
            if restore is not None:
                restore(snap)
        txn.snapshots.clear()
        self._finish(txn_id)

    def _finish(self, txn_id: str) -> None:
        # only ever reached by the thread that won _transition, so the
        # write_lock is released exactly once per transaction
        with self._lock:
            self._transactions.pop(txn_id, None)  # no unbounded history
        try:
            self.write_lock.release()
        except RuntimeError:
            pass

    def active_transactions(self) -> list[TransactionInfo]:
        with self._lock:
            return [t for t in self._transactions.values() if t.state == "ACTIVE"]
