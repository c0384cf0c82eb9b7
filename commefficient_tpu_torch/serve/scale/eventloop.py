"""Event-loop ingest transport: a selectors reactor, the default socket
engine (``--serve_transport eventloop``; the port's copy of the JAX
package's ``serve/scale/eventloop.py``).

One reactor thread multiplexes every connection through
``selectors.DefaultSelector`` (epoll where the OS has it), with

- non-blocking accept: an accept burst drains in one wakeup; past
  ``max_conns`` (default 8192) connections are refused and counted;
- incremental frame reassembly: each connection owns one append-only
  ``bytearray`` consumed by offset; complete newline frames go through the
  shared ``LineProtocol`` (``serve/transport.py``), so the admission
  decisions, chunk-sequence bounds and MALFORMED verdicts are the threaded
  engine's, byte for byte;
- read deadlines: the selector wait is capped at the nearest
  per-connection deadline, and a silent peer is reaped when it lapses;
- the max-frame cap: an unterminated tail past the cap is the byte-flood
  rejection;
- write backpressure: replies that would block park on the connection's
  out-buffer and flush when the socket turns writable.

Nothing reachable from the loop blocks beyond the selector wait. The
reference's sharded reactors and batched-validation deferral are not
ported.
"""

from __future__ import annotations

import json
import selectors
import socket
import sys
import threading
import time

from ...obs import registry as obreg
from ...obs import trace as obtrace
from ..ingest import IngestQueue
from ..transport import DEFAULT_MAX_FRAME_BYTES, LineProtocol, _malformed, submit_over_socket

# connection cap of one reactor (each connection is one fd and a buffer)
DEFAULT_MAX_CONNS_EVENTLOOP = 8192
# compact a connection's receive buffer once this many consumed bytes
# accumulate at its head
_COMPACT_AT = 1 << 16


class _Conn:
    """Per-connection state: the socket, the offset-consumed receive buffer,
    the pending out-buffer, the read deadline and the open chunk
    sequences."""

    __slots__ = ("sock", "buf", "off", "out", "deadline", "sequences", "closing")

    def __init__(self, sock: socket.socket, deadline: float):
        self.sock = sock
        self.buf = bytearray()
        self.off = 0  # bytes of ``buf`` already consumed
        self.out = bytearray()  # pending reply bytes
        self.deadline = deadline
        self.sequences: dict = {}
        self.closing = False  # flush the out-buffer, then close


class EventLoopTransport(LineProtocol):
    """Selectors-based single-threaded ingest reactor (see module doc)."""

    def __init__(self, queue: IngestQueue, host: str = "127.0.0.1", port: int = 0,
                 read_deadline_s: float = 30.0,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 max_conns: int = DEFAULT_MAX_CONNS_EVENTLOOP):
        if read_deadline_s <= 0:
            raise ValueError(f"read_deadline_s must be > 0, got {read_deadline_s}")
        if max_frame_bytes < 1024:
            raise ValueError(f"max_frame_bytes must be >= 1024, got {max_frame_bytes}")
        if max_conns < 1:
            raise ValueError(f"max_conns must be >= 1, got {max_conns}")
        self.queue = queue
        self.max_frame_bytes = max_frame_bytes
        self.max_conns = max_conns
        self.read_deadline_s = read_deadline_s
        self._host, self._port = host, port
        self._sock: socket.socket | None = None
        self._sel: selectors.BaseSelector | None = None
        self._thread: threading.Thread | None = None
        self._conns: dict[socket.socket, _Conn] = {}
        self._stop = threading.Event()
        # self-pipe: stop() writes one byte to wake the selector at once
        self._wake_r: socket.socket | None = None
        self._wake_w: socket.socket | None = None

    @property
    def address(self) -> tuple[str, int] | None:
        return self._sock.getsockname() if self._sock is not None else None

    def start(self) -> None:
        if self._sock is not None:
            return
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(1024)
        s.setblocking(False)
        self._sock = s
        self._sel = selectors.DefaultSelector()
        self._sel.register(s, selectors.EVENT_READ, "accept")
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="serve-reactor", daemon=True)
        self._thread.start()

    def stop(self, join_deadline_s: float = 5.0) -> None:
        self._stop.set()
        if self._wake_w is not None:
            try:
                self._wake_w.send(b"x")
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=join_deadline_s)
            if self._thread.is_alive():
                print("serve: WARNING: reactor thread still alive past the stop deadline",
                      file=sys.stderr, flush=True)
            self._thread = None
        # the reactor closes everything on its way out; these cover a
        # thread that never ran
        for sock in (self._wake_w, self._wake_r, self._sock):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        self._wake_r = self._wake_w = None
        self._sock = None
        self._sel = None
        self._conns.clear()

    def submit(self, sub) -> str:
        """Client-side round trip (a test's or the traffic's convenience)."""
        addr = self.address
        if addr is None:
            raise RuntimeError("EventLoopTransport not started")
        return submit_over_socket(addr, sub)

    # -- the reactor ----------------------------------------------------

    def _loop(self) -> None:
        assert self._sel is not None
        while not self._stop.is_set():
            for key, events in self._select(self._next_timeout()):
                if key.data == "wake":
                    self._drain_wake()
                elif key.data == "accept":
                    self._accept_burst()
                else:
                    conn: _Conn = key.data
                    if events & selectors.EVENT_WRITE:
                        self._flush_out(conn)
                    if events & selectors.EVENT_READ and not conn.closing:
                        self._on_readable(conn)
            self._reap_deadlines()
        # exit: close every connection (partial chunk sequences count
        # MALFORMED, as a threaded handler's death does)
        for conn in list(self._conns.values()):
            self._close_conn(conn, count_sequences=True)
        for sock in (self._wake_r, self._wake_w, self._sock):
            if sock is not None:
                try:
                    self._sel.unregister(sock)
                except (KeyError, ValueError):
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
        self._sel.close()

    def _select(self, timeout: float):
        try:
            return self._sel.select(timeout)
        except OSError:
            return []

    def _next_timeout(self) -> float:
        if not self._conns:
            return 0.5
        nearest = min(c.deadline for c in self._conns.values())
        return min(max(nearest - time.monotonic(), 0.0), 0.5)

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _accept_burst(self) -> None:
        while True:
            try:
                sock, _ = self._sock.accept()
            except (BlockingIOError, OSError):
                return
            if len(self._conns) >= self.max_conns:
                obreg.default().counter("serve_conn_refused_total").inc()
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sock.setblocking(False)
            conn = _Conn(sock, time.monotonic() + self.read_deadline_s)
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _on_readable(self, conn: _Conn) -> None:
        try:
            chunk = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn, count_sequences=True)
            return
        if not chunk:
            self._close_conn(conn, count_sequences=True)
            return
        conn.deadline = time.monotonic() + self.read_deadline_s
        conn.buf += chunk
        self._consume_frames(conn)

    def _consume_frames(self, conn: _Conn) -> None:
        """Slice the complete newline frames out of the offset-consumed
        buffer and dispatch them through the shared LineProtocol; an
        unterminated tail past the frame cap is the byte-flood
        rejection."""
        buf = conn.buf
        view = memoryview(buf)
        while True:
            nl = buf.find(b"\n", conn.off)
            if nl < 0:
                break
            line = bytes(view[conn.off:nl])
            conn.off = nl + 1
            if not line.strip():
                continue
            reply = self._handle_line(line, conn.sequences, len(line))
            if reply is None:
                continue  # mid-sequence chunk
            self._queue_reply(conn, reply)
            if reply.get("detail") == "frame too large":
                view.release()
                self._close_conn(conn, count_sequences=True, flush=True)
                return
        pending = len(buf) - conn.off
        if pending > self.max_frame_bytes:
            obtrace.instant("serve-ingest", "conn:frame_too_big", bytes=pending)
            self._queue_reply(conn, _malformed(self.queue, "frame too large"))
            view.release()
            self._close_conn(conn, count_sequences=True, flush=True)
            return
        view.release()
        if conn.off >= _COMPACT_AT:
            del buf[:conn.off]
            conn.off = 0

    def _queue_reply(self, conn: _Conn, reply: dict) -> None:
        conn.out += json.dumps(reply).encode() + b"\n"
        self._flush_out(conn)

    def _flush_out(self, conn: _Conn) -> None:
        try:
            while conn.out:
                n = conn.sock.send(conn.out)
                del conn.out[:n]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close_conn(conn, count_sequences=True)
            return
        self._update_events(conn)
        if conn.closing and not conn.out:
            self._close_conn(conn)

    def _update_events(self, conn: _Conn) -> None:
        if conn.sock not in self._conns:
            return
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if conn.out else 0)
        try:
            self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _reap_deadlines(self) -> None:
        now = time.monotonic()
        for conn in [c for c in self._conns.values() if c.deadline <= now]:
            obreg.default().counter("serve_conn_deadline_total").inc()
            obtrace.instant("serve-ingest", "conn:deadline")
            self._close_conn(conn, count_sequences=True)

    def _close_conn(self, conn: _Conn, count_sequences: bool = False,
                    flush: bool = False) -> None:
        """Tear a connection down; ``flush=True`` keeps it just long
        enough to drain the pending reply (the deadline still bounds a
        peer that never reads it)."""
        if count_sequences:
            self._abandoned_sequences(conn.sequences)
            conn.sequences = {}
        if flush and conn.out:
            conn.closing = True
            self._update_events(conn)
            return
        self._conns.pop(conn.sock, None)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
