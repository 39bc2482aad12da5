"""Non-blocking event-loop HTTP tier for the trino-tpu front door.

The coordinator's serving edge must survive thousands of idle ``nextUri``
pollers without spending an OS thread per connection.  This module provides
the stdlib-only (``selectors``) machinery the server builds on:

- :class:`EventLoop` — a single-threaded reactor with thread-safe
  ``call_soon`` and heap-scheduled ``call_later`` timers.
- :class:`HttpConnection` — a per-connection state machine
  (read head -> read body -> handle -> write -> keep-alive) over a
  non-blocking socket.  Long-poll handlers park a :class:`Responder`
  instead of a thread; completions marshal back onto the loop.
- :class:`EventLoopHttpServer` — accept loop, connection registry and a
  periodic sweep enforcing read/idle/write timeouts (slowloris defence).
- :class:`TokenBucket` / :class:`TenantRateLimiter` — per-tenant QPS
  shedding for the robustness layer.
- :func:`parse_max_wait` — the one shared parse/clamp/NaN-guard for every
  ``maxWait``-style knob (previously duplicated across handler paths).

Nothing in this module knows about Trino routes; ``server/http.py`` wires
the actual protocol on top.

A copy of ``trino_tpu/server/eventloop.py``, except that the loop
registers its thread with no lock checker of its own: it tells the
callables in :data:`LOOP_THREAD_HOOKS` instead.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import json
import os
import selectors
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "EventLoop",
    "EventLoopHttpServer",
    "Headers",
    "HttpConnection",
    "LOOP_THREAD_HOOKS",
    "Request",
    "Responder",
    "Response",
    "TenantRateLimiter",
    "TokenBucket",
    "assert_not_loop_thread",
    "current_thread_in_loop",
    "json_response",
    "parse_max_wait",
]

# --- loop-thread discipline helpers ----------------------------------------
#
# Idents of threads currently running an EventLoop (there can be several in
# tests). Blocking code paths — dispatch-pool workers, ManagedQuery.run —
# assert they are NOT on one of these; loop-only paths (send_response)
# assert they ARE. Misuse raises under pytest / TT_LOOP_ASSERTS=raise and
# only bumps the trino_tpu_loop_thread_violations_total counter in
# production, so a discipline bug degrades observability, not the service.

_LOOP_THREAD_IDS: set[int] = set()


# Callables ``hook(ident, running)`` told when a loop thread starts
# (``running`` True) and when it ends: how a lock-order checker learns
# which threads must never block (the package has no checker of its own).
LOOP_THREAD_HOOKS: list[Callable[[int, bool], None]] = []


def _notify_loop_thread(ident: int, running: bool) -> None:
    for hook in list(LOOP_THREAD_HOOKS):
        try:
            hook(ident, running)
        except Exception:  # noqa: BLE001 — a hook must not stop the loop
            pass


def current_thread_in_loop() -> bool:
    """True when the calling thread is running any EventLoop."""
    return threading.get_ident() in _LOOP_THREAD_IDS


def _strict_thread_asserts() -> bool:
    mode = os.environ.get("TT_LOOP_ASSERTS", "")
    if mode == "raise":
        return True
    if mode == "count":
        return False
    return "PYTEST_CURRENT_TEST" in os.environ


def _loop_thread_violation(what: str) -> None:
    if _strict_thread_asserts():
        raise RuntimeError(f"loop-thread discipline violation: {what}")
    try:
        from trino_tpu_torch.obs.metrics import get_registry

        get_registry().counter(
            "trino_tpu_loop_thread_violations_total"
        ).inc()
    except Exception:  # noqa: BLE001 — observability must not break serving
        pass


def assert_not_loop_thread(what: str = "blocking call") -> bool:
    """Guard for code that may block: must not run on any loop thread."""
    if not current_thread_in_loop():
        return True
    _loop_thread_violation(f"{what} on an event-loop thread")
    return False

# Hard framing limits; requests beyond these are refused outright.
MAX_HEADER_BYTES = 64 << 10
MAX_BODY_BYTES = 512 << 20  # spool pages can be large, but not unbounded
RECV_CHUNK = 64 << 10

_STATUS_REASONS = {
    200: "OK",
    204: "No Content",
    400: "Bad Request",
    401: "Unauthorized",
    404: "Not Found",
    405: "Method Not Allowed",
    408: "Request Timeout",
    413: "Payload Too Large",
    429: "Too Many Requests",
    500: "Internal Server Error",
    501: "Not Implemented",
    503: "Service Unavailable",
}


def parse_max_wait(
    raw: Any,
    default: float = 1.0,
    lo: float = 0.0,
    hi: float = 30.0,
) -> float:
    """Parse a ``maxWait``-style value and clamp it to ``[lo, hi]``.

    Accepts a float, an int, or a numeric string.  ``None``, garbage, NaN
    and infinities all fall back to ``default`` (itself clamped), so a
    malicious ``maxWait=nan`` can never wedge a poll loop.
    """
    value = default
    if raw is not None:
        try:
            value = float(raw)
        except (TypeError, ValueError):
            value = default
    if value != value or value in (float("inf"), float("-inf")):  # NaN/inf guard
        value = default
    if value != value:  # default itself was NaN
        value = lo
    return min(max(value, lo), hi)


# ---------------------------------------------------------------------------
# Request / response primitives
# ---------------------------------------------------------------------------


class Headers:
    """Case-insensitive header multimap (last value wins, like http.client)."""

    __slots__ = ("_items",)

    def __init__(self) -> None:
        self._items: Dict[str, str] = {}

    def add(self, name: str, value: str) -> None:
        self._items[name.lower()] = value

    def get(self, name: str, default: Optional[str] = None) -> Optional[str]:
        return self._items.get(name.lower(), default)

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._items

    def items(self):
        return self._items.items()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Headers({self._items!r})"


class Request:
    """A fully-framed HTTP request as parsed off the wire."""

    __slots__ = ("method", "target", "headers", "body", "version")

    def __init__(self, method: str, target: str, version: str, headers: Headers) -> None:
        self.method = method
        self.target = target
        self.version = version
        self.headers = headers
        self.body = b""


class Response:
    """An HTTP response to be serialized by the connection."""

    __slots__ = ("status", "body", "content_type", "headers")

    def __init__(
        self,
        status: int = 200,
        body: bytes = b"",
        content_type: str = "application/json",
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}


def json_response(
    payload: Any,
    status: int = 200,
    headers: Optional[Dict[str, str]] = None,
) -> Response:
    body = json.dumps(payload).encode("utf-8")
    return Response(status, body, "application/json", headers)


class Responder:
    """One-shot, thread-safe completion handle for an in-flight request.

    Handlers may respond inline (on the loop) or from a pool thread later;
    either way the response is marshalled onto the event loop and written
    from there.  ``respond`` returns ``False`` if something already
    responded (e.g. a long-poll timer racing its wakeup listener).
    """

    __slots__ = ("_conn", "_done", "_lock")

    def __init__(self, conn: "HttpConnection") -> None:
        self._conn = conn
        self._done = False
        self._lock = threading.Lock()

    @property
    def done(self) -> bool:
        return self._done

    @property
    def connected(self) -> bool:
        return not self._conn.closed

    def respond(self, response: Response) -> bool:
        with self._lock:
            if self._done:
                return False
            self._done = True
        conn = self._conn
        conn.loop.call_soon(conn.send_response, self, response)
        return True


# ---------------------------------------------------------------------------
# Event loop
# ---------------------------------------------------------------------------


class Timer:
    """Cancellable handle returned by :meth:`EventLoop.call_later`."""

    __slots__ = ("when", "fn", "args", "cancelled")

    def __init__(self, when: float, fn: Callable, args: tuple) -> None:
        self.when = when
        self.fn = fn
        self.args = args
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class EventLoop:
    """Single-threaded selector reactor with timers and a wakeup pipe."""

    def __init__(self) -> None:
        self._selector = selectors.DefaultSelector()
        self._ready: "collections.deque[Tuple[Callable, tuple]]" = collections.deque()
        self._timers: List[Tuple[float, int, Timer]] = []
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._closed = False
        # Self-pipe so call_soon from foreign threads interrupts select().
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._woken = False
        self._selector.register(self._wake_r, selectors.EVENT_READ, self._drain_wakeup)

    # -- registration -----------------------------------------------------

    def register(self, sock: socket.socket, events: int, callback: Callable[[int], None]) -> None:
        self._selector.register(sock, events, callback)

    def modify(self, sock: socket.socket, events: int, callback: Callable[[int], None]) -> None:
        self._selector.modify(sock, events, callback)

    def unregister(self, sock: socket.socket) -> None:
        try:
            self._selector.unregister(sock)
        except (KeyError, ValueError):
            pass

    # -- scheduling -------------------------------------------------------

    def call_soon(self, fn: Callable, *args: Any) -> None:
        with self._lock:
            if self._closed:
                return
            self._ready.append((fn, args))
            wake = not self._woken
            self._woken = True
        if wake and threading.current_thread() is not self._thread:
            try:
                self._wake_w.send(b"\x00")
            except OSError:
                pass

    def call_later(self, delay: float, fn: Callable, *args: Any) -> Timer:
        timer = Timer(time.monotonic() + max(0.0, delay), fn, args)

        def _add() -> None:
            heapq.heappush(self._timers, (timer.when, next(self._seq), timer))

        if threading.current_thread() is self._thread:
            _add()
        else:
            self.call_soon(_add)
        return timer

    def in_loop(self) -> bool:
        return threading.current_thread() is self._thread

    def assert_loop_thread(self, what: str = "loop-only call") -> bool:
        """Guard for loop-affine code (connection I/O, timer wheel)."""
        if self.in_loop():
            return True
        _loop_thread_violation(f"{what} off the loop thread")
        return False

    def assert_not_loop_thread(self, what: str = "blocking call") -> bool:
        """Guard for blocking code handed off from this loop."""
        if not self.in_loop():
            return True
        _loop_thread_violation(f"{what} on the loop thread")
        return False

    # -- run / stop -------------------------------------------------------

    def run(self) -> None:
        self._thread = threading.current_thread()
        self._running = True
        ident = threading.get_ident()
        _LOOP_THREAD_IDS.add(ident)
        _notify_loop_thread(ident, True)
        try:
            self._run()
        finally:
            _LOOP_THREAD_IDS.discard(ident)
            _notify_loop_thread(ident, False)

    def _run(self) -> None:
        while self._running:
            timeout = self._next_timeout()
            try:
                events = self._selector.select(timeout)
            except OSError:
                # A socket was closed underneath the selector; callbacks
                # unregister as they close, so just retry.
                events = []
            for key, mask in events:
                if not self._running:
                    break
                try:
                    key.data(mask)
                except Exception:
                    pass
            self._run_timers()
            self._run_ready()

    def stop(self) -> None:
        """Stop the loop from any thread (idempotent)."""
        def _halt() -> None:
            self._running = False

        self.call_soon(_halt)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._ready.clear()
        for sock in (self._wake_r, self._wake_w):
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._selector.close()
        except OSError:
            pass

    # -- internals --------------------------------------------------------

    def _drain_wakeup(self, mask: int) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def _next_timeout(self) -> Optional[float]:
        with self._lock:
            if self._ready:
                return 0.0
        while self._timers and self._timers[0][2].cancelled:
            heapq.heappop(self._timers)
        if not self._timers:
            return 1.0  # re-check _running periodically
        return max(0.0, self._timers[0][0] - time.monotonic())

    def _run_timers(self) -> None:
        now = time.monotonic()
        while self._timers and self._timers[0][0] <= now:
            _, _, timer = heapq.heappop(self._timers)
            if timer.cancelled:
                continue
            try:
                timer.fn(*timer.args)
            except Exception:
                pass

    def _run_ready(self) -> None:
        with self._lock:
            batch = list(self._ready)
            self._ready.clear()
            self._woken = False
        for fn, args in batch:
            try:
                fn(*args)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# HTTP connection state machine
# ---------------------------------------------------------------------------

_IDLE = "idle"        # keep-alive, waiting for the next request's first byte
_HEAD = "head"        # reading the request head
_BODY = "body"        # reading the request body
_HANDLING = "handling"  # request dispatched, awaiting a Responder
_WRITING = "writing"  # flushing the serialized response
_CLOSED = "closed"


class HttpConnection:
    """One client connection driven entirely by the event loop."""

    def __init__(self, server: "EventLoopHttpServer", sock: socket.socket) -> None:
        self.server = server
        self.loop = server.loop
        self.sock = sock
        self.state = _IDLE
        self.closed = False
        self._in = bytearray()
        self._out = bytearray()
        self._need_body = 0
        self._request: Optional[Request] = None
        self._keep_alive = True
        now = time.monotonic()
        self.last_activity = now          # any byte in or out
        self.request_started: Optional[float] = None  # first byte of current head
        self.write_stalled_since: Optional[float] = None
        self._events = selectors.EVENT_READ
        self.loop.register(sock, self._events, self._on_event)

    # -- selector callback ------------------------------------------------

    def _on_event(self, mask: int) -> None:
        if self.closed:
            return
        if mask & selectors.EVENT_WRITE:
            self._flush()
        if self.closed:
            return
        if mask & selectors.EVENT_READ:
            self._on_readable()

    def _on_readable(self) -> None:
        while True:
            try:
                chunk = self.sock.recv(RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self.close()
                return
            if not chunk:
                # Peer closed.  A parked long-poll responder becomes a no-op.
                self.close()
                return
            self.last_activity = time.monotonic()
            self._in += chunk
            if len(chunk) < RECV_CHUNK:
                break
        if self.state in (_IDLE, _HEAD, _BODY):
            self._parse()

    # -- request framing --------------------------------------------------

    def _parse(self) -> None:
        while True:
            if self.state in (_IDLE, _HEAD):
                if self.state == _IDLE and self._in:
                    self.state = _HEAD
                    self.request_started = time.monotonic()
                end = self._in.find(b"\r\n\r\n")
                if end < 0:
                    if len(self._in) > MAX_HEADER_BYTES:
                        self._fail(400, "request head too large")
                    return
                head = bytes(self._in[: end])
                del self._in[: end + 4]
                if not self._parse_head(head):
                    return
            if self.state == _BODY:
                if len(self._in) < self._need_body:
                    return
                assert self._request is not None
                self._request.body = bytes(self._in[: self._need_body])
                del self._in[: self._need_body]
                self.state = _HANDLING
                self.request_started = None
                self._dispatch(self._request)
                # Pipelined bytes (rare) stay buffered until the response
                # is flushed; _finish_response resumes parsing.
                return
            if self.state != _HEAD:
                return

    def _parse_head(self, head: bytes) -> bool:
        try:
            text = head.decode("iso-8859-1")
            lines = text.split("\r\n")
            method, target, version = lines[0].split(" ", 2)
        except (UnicodeDecodeError, ValueError):
            self._fail(400, "malformed request line")
            return False
        headers = Headers()
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if not sep:
                self._fail(400, "malformed header")
                return False
            headers.add(name.strip(), value.strip())
        try:
            length = int(headers.get("Content-Length", "0") or "0")
        except ValueError:
            self._fail(400, "bad Content-Length")
            return False
        if length < 0 or length > MAX_BODY_BYTES:
            self._fail(413, "body too large")
            return False
        if headers.get("Transfer-Encoding"):
            self._fail(400, "chunked bodies unsupported")
            return False
        self._request = Request(method, target, version, headers)
        self._keep_alive = version != "HTTP/1.0" and (
            (headers.get("Connection") or "").lower() != "close"
        )
        self._need_body = length
        self.state = _BODY
        return True

    # -- dispatch / response ----------------------------------------------

    def _dispatch(self, request: Request) -> None:
        responder = Responder(self)
        try:
            self.server.handler(request, responder)
        except Exception as exc:
            responder.respond(
                json_response({"error": f"internal error: {exc}"}, 500)
            )

    def _fail(self, status: int, message: str) -> None:
        self.state = _HANDLING
        self._keep_alive = False
        Responder(self).respond(json_response({"error": message}, status))

    def send_response(self, responder: Responder, response: Response) -> None:
        """Loop-thread only (marshalled by Responder.respond)."""
        self.loop.assert_loop_thread("HttpConnection.send_response")
        if self.closed:
            return
        keep = self._keep_alive and response.status != 408
        reason = _STATUS_REASONS.get(response.status, "Unknown")
        lines = [f"HTTP/1.1 {response.status} {reason}"]
        if response.status != 204:
            lines.append(f"Content-Type: {response.content_type}")
            lines.append(f"Content-Length: {len(response.body)}")
        for name, value in response.headers.items():
            lines.append(f"{name}: {value}")
        lines.append(f"Connection: {'keep-alive' if keep else 'close'}")
        payload = ("\r\n".join(lines) + "\r\n\r\n").encode("iso-8859-1")
        if response.status != 204:
            payload += response.body
        self._keep_alive = keep
        self._out += payload
        self.state = _WRITING
        self._flush()

    def _flush(self) -> None:
        while self._out:
            try:
                sent = self.sock.send(self._out)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self.close()
                return
            if sent <= 0:
                break
            del self._out[: sent]
            self.last_activity = time.monotonic()
        if self._out:
            if self.write_stalled_since is None:
                self.write_stalled_since = time.monotonic()
            self._want(selectors.EVENT_READ | selectors.EVENT_WRITE)
            return
        self.write_stalled_since = None
        self._want(selectors.EVENT_READ)
        if self.state == _WRITING:
            self._finish_response()

    def _finish_response(self) -> None:
        if not self._keep_alive:
            self.close()
            return
        self.state = _IDLE
        self._request = None
        self.last_activity = time.monotonic()
        if self._in:
            self._parse()

    def _want(self, events: int) -> None:
        if self.closed or events == self._events:
            return
        self._events = events
        try:
            self.loop.modify(self.sock, events, self._on_event)
        except (KeyError, ValueError, OSError):
            self.close()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.state = _CLOSED
        self.loop.unregister(self.sock)
        try:
            self.sock.close()
        except OSError:
            pass
        self.server._conns.discard(self)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class EventLoopHttpServer:
    """Accepts connections and runs them on a single :class:`EventLoop`.

    ``handler(request, responder)`` is invoked on the loop thread for every
    framed request; it must never block (offload to a pool and respond via
    the responder).
    """

    def __init__(
        self,
        host: str,
        port: int,
        handler: Callable[[Request, Responder], None],
        *,
        max_connections: int = 4096,
        read_timeout_s: float = 30.0,
        idle_timeout_s: float = 300.0,
        write_timeout_s: float = 60.0,
        on_shed: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.handler = handler
        self.max_connections = max_connections
        self.read_timeout_s = read_timeout_s
        self.idle_timeout_s = idle_timeout_s
        self.write_timeout_s = write_timeout_s
        self.on_shed = on_shed
        self.loop = EventLoop()
        self._conns: "set[HttpConnection]" = set()
        self._thread: Optional[threading.Thread] = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(256)
        self._sock.setblocking(False)
        self.server_address = self._sock.getsockname()
        self._closed = False

    @property
    def connection_count(self) -> int:
        return len(self._conns)

    def start(self) -> None:
        self.loop.register(self._sock, selectors.EVENT_READ, self._on_accept)
        self._thread = threading.Thread(
            target=self.loop.run, name="http-event-loop", daemon=True
        )
        self._thread.start()
        self._schedule_sweep()

    def close(self) -> None:
        """Stop the loop, close every connection and the listener."""
        if self._closed:
            return
        self._closed = True

        def _teardown() -> None:
            for conn in list(self._conns):
                conn.close()
            self.loop.unregister(self._sock)
            self.loop.stop()

        self.loop.call_soon(_teardown)
        if self._thread is not None and not self.loop.in_loop():
            self._thread.join(timeout=5.0)
        try:
            self._sock.close()
        except OSError:
            pass
        self.loop.close()

    # -- loop-side --------------------------------------------------------

    def _on_accept(self, mask: int) -> None:
        while True:
            try:
                csock, _addr = self._sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            try:
                csock.setblocking(False)
                csock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                csock.close()
                continue
            if len(self._conns) >= self.max_connections:
                # Shed at the door with a minimal, pre-baked 503.
                body = b'{"error": "too many connections"}'
                head = (
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: %d\r\nRetry-After: 1\r\n"
                    b"Connection: close\r\n\r\n" % len(body)
                )
                try:
                    csock.send(head + body)
                except OSError:
                    pass
                csock.close()
                if self.on_shed is not None:
                    self.on_shed("connections")
                continue
            self._conns.add(HttpConnection(self, csock))

    def _schedule_sweep(self) -> None:
        interval = min(
            1.0,
            max(0.05, min(self.read_timeout_s, self.idle_timeout_s, self.write_timeout_s) / 4.0),
        )
        self.loop.call_later(interval, self._sweep)

    def _sweep(self) -> None:
        if self._closed:
            return
        now = time.monotonic()
        for conn in list(self._conns):
            if conn.closed:
                self._conns.discard(conn)
                continue
            # Slowloris: a request head/body trickling in too slowly.
            if (
                conn.state in (_HEAD, _BODY)
                and conn.request_started is not None
                and now - conn.request_started > self.read_timeout_s
            ):
                conn._fail(408, "request read timeout")
                continue
            # Write stall: peer stopped draining our response.
            if (
                conn.write_stalled_since is not None
                and now - conn.write_stalled_since > self.write_timeout_s
            ):
                conn.close()
                continue
            # Idle keep-alive past its welcome.
            if conn.state == _IDLE and now - conn.last_activity > self.idle_timeout_s:
                conn.close()
        self._schedule_sweep()


# ---------------------------------------------------------------------------
# Rate limiting
# ---------------------------------------------------------------------------


class TokenBucket:
    """Classic token bucket over a monotonic clock."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = max(1e-9, float(rate))
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.stamp = time.monotonic()

    def try_acquire(self, now: Optional[float] = None) -> float:
        """Take one token.  Returns 0.0 on success, else seconds until
        the next token would be available (a Retry-After hint)."""
        if now is None:
            now = time.monotonic()
        elapsed = max(0.0, now - self.stamp)
        self.stamp = now
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


class TenantRateLimiter:
    """Per-tenant token buckets with bounded LRU occupancy."""

    def __init__(self, qps: float, burst: float, max_tenants: int = 10_000) -> None:
        self.qps = float(qps)
        self.burst = float(burst)
        self.max_tenants = max_tenants
        self._buckets: "collections.OrderedDict[str, TokenBucket]" = collections.OrderedDict()
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.qps > 0.0

    def try_acquire(self, tenant: str) -> float:
        """0.0 when admitted; otherwise a Retry-After hint in seconds."""
        if not self.enabled:
            return 0.0
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = TokenBucket(self.qps, self.burst)
                self._buckets[tenant] = bucket
                while len(self._buckets) > self.max_tenants:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(tenant)
            return bucket.try_acquire()
