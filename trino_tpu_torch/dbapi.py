"""DB-API 2.0 (PEP 249) module over the statement protocol.

Reference tier: ``client/trino-jdbc/.../TrinoConnection.java`` /
``TrinoResultSet.java`` — the standard-interface client wrapped around the
protocol client (our :mod:`trino_tpu_torch.client`). JDBC's java.sql surface maps
to Python's DB-API: Connection/Cursor, ``description``, ``rowcount``,
``fetch*``, qmark parameter binding, and the standard exception hierarchy.

A copy of ``trino_tpu/dbapi.py`` over the port's client.
"""

from __future__ import annotations

import datetime
from decimal import Decimal
from typing import Any, Iterator, Optional, Sequence

from trino_tpu_torch.client import ClientSession, QueryFailure, StatementClient

apilevel = "2.0"
threadsafety = 1  # threads may share the module, not connections
paramstyle = "qmark"


# --- PEP 249 exception hierarchy -------------------------------------------


class Warning(Exception):  # noqa: A001 (PEP 249 name)
    pass


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class DataError(DatabaseError):
    pass


class OperationalError(DatabaseError):
    pass


class IntegrityError(DatabaseError):
    pass


class InternalError(DatabaseError):
    pass


class ProgrammingError(DatabaseError):
    pass


class NotSupportedError(DatabaseError):
    pass


# --- type singletons (PEP 249 §Type Objects) --------------------------------


class _DBAPIType:
    def __init__(self, *names: str):
        self.names = frozenset(names)

    def __eq__(self, other):  # type: ignore[override]
        base = str(other).split("(")[0].lower()
        return base in self.names

    def __hash__(self):
        return hash(self.names)


STRING = _DBAPIType("varchar", "char", "json")
BINARY = _DBAPIType("varbinary")
NUMBER = _DBAPIType(
    "tinyint", "smallint", "integer", "bigint", "real", "double", "decimal"
)
DATETIME = _DBAPIType("date", "time", "timestamp")
ROWID = _DBAPIType()

Date = datetime.date
Time = datetime.time
Timestamp = datetime.datetime
Binary = bytes


def DateFromTicks(ticks: float) -> datetime.date:
    return datetime.date.fromtimestamp(ticks)


def TimeFromTicks(ticks: float) -> datetime.time:
    return datetime.datetime.fromtimestamp(ticks).time()


def TimestampFromTicks(ticks: float) -> datetime.datetime:
    return datetime.datetime.fromtimestamp(ticks)


# --- literal binding (qmark) -------------------------------------------------


def _quote_literal(v: Any) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, Decimal):
        return f"DECIMAL '{v}'"
    if isinstance(v, datetime.datetime):
        return f"TIMESTAMP '{v.strftime('%Y-%m-%d %H:%M:%S.%f')[:-3]}'"
    if isinstance(v, datetime.date):
        return f"DATE '{v.isoformat()}'"
    if isinstance(v, datetime.time):
        return f"TIME '{v.isoformat()}'"
    if isinstance(v, (bytes, bytearray)):
        return "X'" + v.hex() + "'"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise ProgrammingError(f"cannot bind parameter of type {type(v).__name__}")


def _bind(sql: str, params: Optional[Sequence[Any]]) -> str:
    """Substitute ``?`` placeholders outside string literals/comments."""
    if not params:
        return sql
    out = []
    it = iter(params)
    i, n = 0, len(sql)
    used = 0
    while i < n:
        ch = sql[i]
        if ch == "'":
            j = i + 1
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    j += 2
                    continue
                if sql[j] == "'":
                    break
                j += 1
            out.append(sql[i : j + 1])
            i = j + 1
        elif ch == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)
            j = n if j < 0 else j
            out.append(sql[i:j])
            i = j
        elif ch == "?":
            try:
                out.append(_quote_literal(next(it)))
            except StopIteration:
                raise ProgrammingError("not enough parameters for placeholders")
            used += 1
            i += 1
        else:
            out.append(ch)
            i += 1
    if used != len(params):
        raise ProgrammingError(
            f"statement has {used} placeholders but {len(params)} parameters given"
        )
    return "".join(out)


# --- Cursor / Connection -----------------------------------------------------


class Cursor:
    arraysize = 1

    def __init__(self, connection: "Connection"):
        self.connection = connection
        self.description: Optional[list[tuple]] = None
        self.rowcount = -1
        self._rows: Optional[Iterator[tuple]] = None
        self._client: Optional[StatementClient] = None
        self._closed = False

    # -- execution --

    def execute(self, operation: str, parameters: Optional[Sequence[Any]] = None):
        self._check_open()
        sql = _bind(operation, parameters)
        client = StatementClient(
            self.connection._base_uri, sql, self.connection._session
        )
        self._client = client
        try:
            rows_iter = client.rows()
            first = next(rows_iter, _SENTINEL)
        except QueryFailure as e:
            raise _map_failure(e) from e
        except OSError as e:
            raise OperationalError(str(e)) from e
        self.description = (
            [
                (c.name, c.type, None, None, None, None, None)
                for c in client.columns
            ]
            if client.columns
            else None
        )
        if client.update_count is not None:
            self.rowcount = client.update_count
            self._rows = iter(())
        else:
            self.rowcount = -1
            self._rows = (
                iter(()) if first is _SENTINEL else _chain_first(first, rows_iter)
            )
        return self

    def executemany(self, operation: str, seq_of_parameters: Sequence[Sequence[Any]]):
        total = 0
        for params in seq_of_parameters:
            self.execute(operation, params)
            if self.rowcount > 0:
                total += self.rowcount
        self.rowcount = total
        return self

    # -- fetch --

    def fetchone(self) -> Optional[tuple]:
        self._check_results()
        try:
            return next(self._rows)  # type: ignore[arg-type]
        except StopIteration:
            return None
        except QueryFailure as e:
            raise _map_failure(e) from e

    def fetchmany(self, size: Optional[int] = None) -> list[tuple]:
        size = size or self.arraysize
        out = []
        for _ in range(size):
            row = self.fetchone()
            if row is None:
                break
            out.append(row)
        return out

    def fetchall(self) -> list[tuple]:
        self._check_results()
        try:
            return list(self._rows)  # type: ignore[arg-type]
        except QueryFailure as e:
            raise _map_failure(e) from e

    def __iter__(self):
        self._check_results()
        return self._rows

    # -- misc --

    def setinputsizes(self, sizes):
        pass

    def setoutputsize(self, size, column=None):
        pass

    def cancel(self):
        if self._client is not None:
            self._client.cancel()

    def close(self):
        self.cancel()
        self._closed = True
        self._rows = None

    def _check_open(self):
        if self._closed or self.connection._closed:
            raise InterfaceError("cursor is closed")

    def _check_results(self):
        self._check_open()
        if self._rows is None:
            raise ProgrammingError("no query has been executed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_SENTINEL = object()


def _chain_first(first: tuple, rest: Iterator[tuple]) -> Iterator[tuple]:
    yield first
    yield from rest


def _map_failure(e: QueryFailure) -> DatabaseError:
    name = (e.error or {}).get("errorName", "")
    if "SYNTAX" in name or "COLUMN_NOT_FOUND" in name or "SEMANTIC" in name:
        return ProgrammingError(str(e))
    return OperationalError(str(e))


class Connection:
    def __init__(
        self,
        host: str = "localhost",
        port: int = 8080,
        user: str = "user",
        catalog: Optional[str] = "tpch",
        schema: Optional[str] = "tiny",
        session_properties: Optional[dict] = None,
        base_uri: Optional[str] = None,
    ):
        self._base_uri = base_uri or f"http://{host}:{port}"
        self._session = ClientSession(
            user=user,
            catalog=catalog,
            schema=schema,
            properties=dict(session_properties or {}),
        )
        self._closed = False

    def cursor(self) -> Cursor:
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def _run(self, sql: str) -> None:
        cur = self.cursor()
        cur.execute(sql)
        cur.fetchall()

    def commit(self) -> None:
        # autocommit unless an explicit transaction was started via
        # cursor.execute("START TRANSACTION") — COMMIT then rides the
        # X-Trino-Transaction-Id header kept in the shared ClientSession
        if self._session.transaction_id:
            self._run("COMMIT")

    def rollback(self) -> None:
        if self._session.transaction_id:
            self._run("ROLLBACK")

    def close(self) -> None:
        if not self._closed and self._session.transaction_id:
            try:
                self._run("ROLLBACK")
            except Exception:  # noqa: BLE001
                pass
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            try:
                self.commit()
            finally:
                self.close()
        else:
            self.close()


def connect(*args, **kwargs) -> Connection:
    return Connection(*args, **kwargs)
