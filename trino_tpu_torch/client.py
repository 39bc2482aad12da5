"""Client protocol library + statement client.

Reference: ``client/trino-client/src/main/java/io/trino/client/StatementClientV1.java:62,125,324``
— POST /v1/statement, then follow ``nextUri`` until absent; typed results
via ``columns``; session mutations via ``X-Trino-Set-Session`` headers.
Stdlib ``urllib`` only (the reference uses OkHttp).

A copy of ``trino_tpu/client.py``: the port's server speaks the same
protocol, so either client talks to either server.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.error
import urllib.parse
import urllib.request
from decimal import Decimal
from typing import Any, Iterator, Optional

HEADER = "X-Trino"


class QueryFailure(Exception):
    def __init__(self, error: dict):
        self.error = error
        super().__init__(
            f"{error.get('errorName', 'ERROR')}: {error.get('message', '')}"
        )


@dataclasses.dataclass
class Column:
    name: str
    type: str


class StatementClient:
    """Drives one statement through the paged protocol."""

    def __init__(self, base_uri: str, sql: str, session: "ClientSession"):
        self.base_uri = base_uri.rstrip("/")
        self.sql = sql
        self.session = session
        self.columns: Optional[list[Column]] = None
        self.update_type: Optional[str] = None
        self.update_count: Optional[int] = None
        self.stats: dict = {}
        self.query_id: Optional[str] = None
        self._next_uri: Optional[str] = None
        self._current_data: list[list[Any]] = []
        self._started = False

    # --- protocol ---------------------------------------------------------

    def _headers(self) -> dict[str, str]:
        h = {
            f"{HEADER}-User": self.session.user,
            f"{HEADER}-Source": "trino-tpu-client",
        }
        if self.session.catalog:
            h[f"{HEADER}-Catalog"] = self.session.catalog
        if self.session.schema:
            h[f"{HEADER}-Schema"] = self.session.schema
        if self.session.properties:
            h[f"{HEADER}-Session"] = ",".join(
                f"{k}={urllib.parse.quote(str(v))}"
                for k, v in self.session.properties.items()
            )
        if self.session.prepared_statements:
            h[f"{HEADER}-Prepared-Statement"] = ",".join(
                f"{k}={urllib.parse.quote(v)}"
                for k, v in self.session.prepared_statements.items()
            )
        if self.session.transaction_id:
            h[f"{HEADER}-Transaction-Id"] = self.session.transaction_id
        return h

    def _request(self, method: str, uri: str, body: Optional[bytes] = None) -> dict:
        """One protocol round trip, honoring 503 + Retry-After shedding.

        A shed response (503 carrying Retry-After) means the server is
        overloaded, not failing: back off (jittered, deterministic —
        ``ft.retry.Backoff``, floored at the server's hint) and retry a
        bounded number of times. A 503 without Retry-After (draining
        server) is not retried — that server is going away."""
        attempts = max(1, int(self.session.shed_retry_attempts))
        for attempt in range(1, attempts + 1):
            try:
                return self._request_once(method, uri, body)
            except urllib.error.HTTPError as e:
                retry_after = e.headers.get("Retry-After") if e.headers else None
                if e.code != 503 or retry_after is None or attempt >= attempts:
                    raise
                _sleep_for_retry(retry_after, attempt)
        raise AssertionError("unreachable")

    def _request_once(self, method: str, uri: str, body: Optional[bytes] = None) -> dict:
        req = urllib.request.Request(uri, data=body, method=method)
        for k, v in self._headers().items():
            req.add_header(k, v)
        with urllib.request.urlopen(
            req, timeout=self.session.request_timeout
        ) as resp:
            set_session = resp.headers.get(f"{HEADER}-Set-Session")
            if set_session and "=" in set_session:
                k, v = set_session.split("=", 1)
                self.session.properties[k] = urllib.parse.unquote(v)
            added = resp.headers.get(f"{HEADER}-Added-Prepare")
            if added and "=" in added:
                k, v = added.split("=", 1)
                self.session.prepared_statements[k] = urllib.parse.unquote(v)
            dealloc = resp.headers.get(f"{HEADER}-Deallocated-Prepare")
            if dealloc:
                self.session.prepared_statements.pop(dealloc, None)
            started = resp.headers.get(f"{HEADER}-Started-Transaction-Id")
            if started:
                self.session.transaction_id = started
            if resp.headers.get(f"{HEADER}-Clear-Transaction-Id"):
                self.session.transaction_id = None
            return json.loads(resp.read().decode())

    def _advance_state(self, payload: dict) -> None:
        self.query_id = payload.get("id", self.query_id)
        self.stats = payload.get("stats", self.stats)
        if "columns" in payload and self.columns is None:
            self.columns = [
                Column(c["name"], c["type"]) for c in payload["columns"]
            ]
        self.update_type = payload.get("updateType", self.update_type)
        if "updateCount" in payload:
            self.update_count = payload["updateCount"]
        if payload.get("error"):
            raise QueryFailure(payload["error"])
        self._current_data = payload.get("data", [])
        self._next_uri = payload.get("nextUri")

    def advance(self) -> bool:
        """POST on first call, then follow nextUri (StatementClientV1.advance)."""
        if not self._started:
            self._started = True
            payload = self._request(
                "POST", f"{self.base_uri}/v1/statement", self.sql.encode()
            )
            self._advance_state(payload)
            return True
        if self._next_uri is None:
            return False
        self._advance_state(self._request("GET", self._next_uri))
        return True

    def cancel(self) -> None:
        if self._next_uri is not None:
            try:
                self._request("DELETE", self._next_uri)
            except urllib.error.HTTPError:
                pass
        self._next_uri = None

    # --- results ----------------------------------------------------------

    def rows(self) -> Iterator[tuple]:
        """All rows, typed (decimal strings -> Decimal)."""
        while self.advance():
            types = [c.type for c in self.columns] if self.columns else []
            # _decode_value changes only DECIMAL columns' values
            decimals = [i for i, t in enumerate(types) if t.startswith("decimal")]
            for row in self._current_data:
                for i in decimals:
                    row[i] = _decode_value(row[i], types[i])
                yield tuple(row)


def _sleep_for_retry(retry_after: str, attempt: int) -> None:
    import time

    from trino_tpu_torch.ft.retry import Backoff

    base_ms = 100.0
    try:
        base_ms = max(base_ms, float(retry_after) * 1000.0)
    except (TypeError, ValueError):
        pass
    delay = Backoff(
        initial_ms=base_ms, max_ms=max(4 * base_ms, 5000.0), seed=0
    ).delay(attempt)
    time.sleep(delay)


def _decode_value(v: Any, type_: str) -> Any:
    if v is None:
        return None
    if type_.startswith("decimal"):
        return Decimal(v)
    return v


@dataclasses.dataclass
class ClientSession:
    user: str = "user"
    catalog: Optional[str] = "tpch"
    schema: Optional[str] = "tiny"
    properties: dict[str, Any] = dataclasses.field(default_factory=dict)
    # name -> SQL text, mirrored via X-Trino-*-Prepare headers
    prepared_statements: dict[str, str] = dataclasses.field(default_factory=dict)
    # explicit transaction id (X-Trino-Transaction-Id roundtrip)
    transaction_id: Optional[str] = None
    # per-request socket timeout (seconds) for the statement protocol
    # (OkHttp client timeout analog; chaos tests shrink it)
    request_timeout: float = 120.0
    # total tries for a request shed with 503 + Retry-After (overload);
    # 1 disables retries entirely
    shed_retry_attempts: int = 3


class Connection:
    """DB-API-flavored convenience wrapper (the trino-jdbc analog tier)."""

    def __init__(self, base_uri: str, session: Optional[ClientSession] = None):
        self.base_uri = base_uri
        self.session = session or ClientSession()

    def execute(self, sql: str) -> tuple[list[tuple], list[str]]:
        client = StatementClient(self.base_uri, sql, self.session)
        rows = list(client.rows())
        names = [c.name for c in client.columns] if client.columns else []
        return rows, names

    # --- server introspection -------------------------------------------

    def server_info(self) -> dict:
        with urllib.request.urlopen(f"{self.base_uri}/v1/info", timeout=10) as r:
            return json.loads(r.read().decode())

    def list_queries(self) -> list[dict]:
        with urllib.request.urlopen(f"{self.base_uri}/v1/query", timeout=10) as r:
            return json.loads(r.read().decode())
