"""Submission transports: in-process and local socket (the port's copy of
the JAX package's ``serve/transport.py``).

Every transport presents ``submit(Submission) -> str`` (the admission
decision, ``serve/ingest.py``) plus start/stop, so the service, the
traffic generator and the tests are transport-agnostic.

- ``InProcessTransport``: a direct call into the ingest queue; sketch
  payloads ride as raw ndarrays.
- ``SocketTransport``: newline-delimited JSON over a loopback TCP socket,
  one accept thread and one thread per connection (capped at
  ``max_conns`` live connections; past the cap new connections are
  refused and counted). The selectors reactor (``serve/scale/eventloop.py``,
  the default socket engine) speaks the same ``LineProtocol``, so the two
  engines cannot differ on an admission decision. A request
  ``{"client_id": int, "round": int, "latency_s": float?, "payload":
  frame?}`` is answered with ``{"status": "<decision>"}`` (plus
  ``retry_after_s`` on SHEDDING).

  A table bigger than one frame line crosses as chunk lines
  ``{"client_id", "round", "latency_s", "chunk": frame_i}``: the handler
  collects the sequence without decoding it and hands the frame list to
  the ingest validation, where reassembly and every integrity check live.
  One reply per submission, after the last chunk; a connection that dies
  mid-sequence counts the partial sequence MALFORMED and admits nothing.

Against a hostile wire: a per-connection read deadline (a silent peer is
disconnected), a max frame size (a newline-less byte flood is cut off with
MALFORMED), and live connections force-closed on stop so every handler
thread joins.

Client helpers: ``submit_over_socket`` (one round trip),
``abort_over_socket`` (a connection that dies mid-send) and
``submit_with_retries`` (bounded retries with deterministic jittered
backoff).
"""

from __future__ import annotations

import json
import socket
import sys
import threading
import time

import numpy as np

from ..obs import registry as obreg
from ..obs import trace as obtrace
from ..sketch.payload import MAX_CHUNKS
from .ingest import SHEDDING, IngestQueue, Submission

# the socket transport's per-line byte cap, and the chunking threshold the
# client helpers frame against (one knob, both sides)
DEFAULT_MAX_FRAME_BYTES = 1 << 20
# chunk sequences one connection may hold open at once
_MAX_SEQUENCES_PER_CONN = 4
# connection cap of the thread-per-connection transport (every connection
# is an OS thread)
DEFAULT_MAX_CONNS_THREADED = 128


class InProcessTransport:
    """Direct-call transport: submit() is queue.submit()."""

    def __init__(self, queue: IngestQueue):
        self.queue = queue

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def submit(self, sub: Submission) -> str:
        return self.queue.submit(sub)

    @property
    def address(self) -> None:
        return None


def _malformed(queue: IngestQueue, detail: str) -> dict:
    obreg.default().counter("serve_rejected_malformed_total").inc()
    queue.note_wire_malformed()
    return {"status": "MALFORMED", "detail": detail}


class LineProtocol:
    """The newline-JSON ingest wire: one request line (or chunk line) in,
    one admission-decision reply out (None mid-sequence). Both socket
    engines speak exactly this through these methods. Subclasses provide
    ``self.queue`` and ``self.max_frame_bytes``."""

    queue: IngestQueue
    max_frame_bytes: int

    def _handle_line(self, line: bytes, sequences: dict | None = None,
                     line_bytes: int | None = None) -> dict | None:
        if len(line) > self.max_frame_bytes:
            return _malformed(self.queue, "frame too large")
        try:
            req = json.loads(line)
            if "chunk" in req:
                return self._handle_chunk(req, sequences if sequences is not None else {},
                                          len(line) if line_bytes is None else line_bytes)
            payload = req.get("payload")
            sub = Submission(
                client_id=int(req["client_id"]),
                round=int(req["round"]),
                latency_s=float(req.get("latency_s", 0.0)),
                payload_bytes=(int(payload.get("nbytes", 0)) if isinstance(payload, dict)
                               else len(payload or "")),
                # the frame passes through undecoded: validate_payload is
                # the one place wire bytes are decoded
                payload=payload,
            )
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            print(f"serve: malformed submission rejected ({type(e).__name__}: {e})",
                  file=sys.stderr, flush=True)
            return _malformed(self.queue, type(e).__name__)
        return self._reply_for(self.queue.submit(sub))

    def _sequence_byte_budget(self) -> int:
        """Upper bound on the wire bytes one chunk sequence may buffer: a
        little past one legitimate table's encoded size (one frame on an
        announce server, which expects no payload)."""
        p = self.queue.payload_policy
        if p is None:
            return self.max_frame_bytes
        return p.nbytes * 4 // 3 + self.max_frame_bytes

    def _handle_chunk(self, req: dict, sequences: dict, line_bytes: int) -> dict | None:
        """Collect one chunk line. The transport bounds only what it must
        (sequences per connection, chunks and wire bytes per sequence);
        every content verdict is the validation's."""
        try:
            key = (int(req["client_id"]), int(req["round"]))
            frame = req["chunk"]
            total = int(frame["total"])
            latency = float(req.get("latency_s", 0.0))
        except (ValueError, KeyError, TypeError):
            return _malformed(self.queue, "bad chunk line")
        if not 1 <= total <= MAX_CHUNKS:
            return _malformed(self.queue, f"chunk total {total} out of bounds")
        if key not in sequences and len(sequences) >= _MAX_SEQUENCES_PER_CONN:
            return _malformed(self.queue, "too many concurrent chunk sequences")
        seq = sequences.setdefault(key, {"frames": [], "bytes": 0})
        seq["frames"].append(frame)
        seq["bytes"] += line_bytes
        if seq["bytes"] > self._sequence_byte_budget():
            buffered = seq["bytes"]
            del sequences[key]
            return _malformed(self.queue, f"chunk sequence exceeds {buffered} bytes")
        if len(seq["frames"]) < total:
            return None  # mid-sequence: the reply comes with the last chunk
        frames = sequences.pop(key)["frames"]
        return self._reply_for(self.queue.submit(Submission(
            client_id=key[0], round=key[1], latency_s=latency,
            payload_bytes=sum(len(str(f.get("data", ""))) for f in frames), payload=frames)))

    def _reply_for(self, status: str) -> dict:
        reply = {"status": status}
        if status == SHEDDING:
            # a shed client is told when to come back
            reply["retry_after_s"] = self.queue.shed_retry_after_s
        return reply

    def _abandoned_sequences(self, sequences: dict) -> None:
        """A peer died with chunk sequences open: each partial sequence is
        a MALFORMED submission that admitted nothing."""
        if not sequences:
            return
        for _ in sequences:
            obreg.default().counter("serve_rejected_malformed_total").inc()
            self.queue.note_wire_malformed()
        obtrace.instant("serve-ingest", "conn:partial_sequence", sequences=len(sequences))


class SocketTransport(LineProtocol):
    """Loopback-TCP ingest, one thread per connection."""

    def __init__(self, queue: IngestQueue, host: str = "127.0.0.1", port: int = 0,
                 read_deadline_s: float = 30.0,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 max_conns: int = DEFAULT_MAX_CONNS_THREADED):
        if read_deadline_s <= 0:
            raise ValueError(f"read_deadline_s must be > 0, got {read_deadline_s}")
        if max_frame_bytes < 1024:
            raise ValueError(f"max_frame_bytes must be >= 1024, got {max_frame_bytes}")
        if max_conns < 1:
            raise ValueError(f"max_conns must be >= 1, got {max_conns}")
        self.max_conns = max_conns
        self.queue = queue
        self._host = host
        self._port = port
        self.read_deadline_s = read_deadline_s
        self.max_frame_bytes = max_frame_bytes
        self._sock: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._conn_threads: list[threading.Thread] = []
        # live connections, force-closed on stop()
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()

    @property
    def address(self) -> tuple[str, int] | None:
        """(host, port) once started (the port resolved for port=0)."""
        return self._sock.getsockname() if self._sock is not None else None

    def start(self) -> None:
        if self._sock is not None:
            return
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(64)
        # the accept loop wakes every half second to check the stop flag
        s.settimeout(0.5)
        self._sock = s
        self._stop.clear()
        self._accept_thread = threading.Thread(target=self._accept_loop, name="serve-accept",
                                               daemon=True)
        self._accept_thread.start()

    def stop(self, join_deadline_s: float = 5.0) -> None:
        """Stop accepting, force-close live connections and join every
        handler thread against one deadline."""
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        with self._conns_lock:
            live = list(self._conns)
        for conn in live:
            for close in (lambda: conn.shutdown(socket.SHUT_RDWR), conn.close):
                try:
                    close()
                except OSError:
                    pass
        deadline = time.monotonic() + join_deadline_s
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=max(deadline - time.monotonic(), 0.1))
        with self._conns_lock:
            joinable = list(self._conn_threads)
        for t in joinable:
            t.join(timeout=max(deadline - time.monotonic(), 0.1))
        leaked = [t.name for t in joinable if t.is_alive()]
        if leaked:
            print(f"serve: WARNING: {len(leaked)} connection thread(s) still alive past the "
                  f"stop deadline: {leaked}", file=sys.stderr, flush=True)
        with self._conns_lock:
            self._conn_threads = [t for t in self._conn_threads if t.is_alive()]
        self._sock = None

    def submit(self, sub: Submission) -> str:
        """Round-trip one submission over the wire (client side)."""
        addr = self.address
        if addr is None:
            raise RuntimeError("SocketTransport not started")
        return submit_over_socket(addr, sub)

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:  # closed by stop()
                return
            with self._conns_lock:
                self._conn_threads = [x for x in self._conn_threads if x.is_alive()]
                live = len(self._conn_threads)
            if live >= self.max_conns:
                obreg.default().counter("serve_conn_refused_total").inc()
                obtrace.instant("serve-ingest", "conn:refused", live=live)
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            conn.settimeout(None)
            t = threading.Thread(target=self._serve_conn, args=(conn,), name="serve-conn",
                                 daemon=True)
            t.start()
            with self._conns_lock:
                self._conn_threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        with self._conns_lock:
            self._conns.add(conn)
        # open chunk sequences on this connection: (client_id, round) ->
        # frames in receive order, collected, never decoded here
        sequences: dict[tuple[int, int], dict] = {}
        try:
            conn.settimeout(self.read_deadline_s)
            with conn:
                buf = b""
                while not self._stop.is_set():
                    try:
                        chunk = conn.recv(65536)
                    except socket.timeout:
                        obreg.default().counter("serve_conn_deadline_total").inc()
                        obtrace.instant("serve-ingest", "conn:deadline")
                        return
                    except OSError:
                        return
                    if not chunk:
                        return
                    buf += chunk
                    if len(buf) > self.max_frame_bytes and b"\n" not in buf:
                        # newline-less byte flood: cut off at the cap
                        obtrace.instant("serve-ingest", "conn:frame_too_big", bytes=len(buf))
                        self._reply(conn, _malformed(self.queue, "frame too large"))
                        return
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        if not line.strip():
                            continue
                        reply = self._handle_line(line, sequences, len(line))
                        if reply is None:
                            continue  # mid-sequence chunk
                        if not self._reply(conn, reply):
                            return
        finally:
            self._abandoned_sequences(sequences)
            with self._conns_lock:
                self._conns.discard(conn)

    @staticmethod
    def _reply(conn: socket.socket, reply: dict) -> bool:
        try:
            conn.sendall(json.dumps(reply).encode() + b"\n")
            return True
        except OSError:
            return False


def submit_over_socket(addr: tuple[str, int], sub: Submission, timeout_s: float = 5.0,
                       max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> str:
    """One submission over a fresh connection; returns the admission
    decision (raises on a transport failure; rejections are not
    exceptions). A table bigger than ``max_frame_bytes`` ships as chunk
    lines with one reply after the last."""
    return _roundtrip(addr, sub, timeout_s, max_frame_bytes)["status"]


def _wire_bytes(sub: Submission, max_frame_bytes: int) -> bytes:
    """The exact bytes a submission crosses the wire as, shared by the
    round trip and the mid-send abort."""
    return b"".join(json.dumps(ln).encode() + b"\n" for ln in _wire_lines(sub, max_frame_bytes))


def _wire_lines(sub: Submission, max_frame_bytes: int) -> list[dict]:
    """The request lines of a submission: one ``payload`` line for a table
    or frame that fits the frame cap (or any non-table payload), ``total``
    chunk lines for one that does not. A frame the client already built (a
    wire fault's damaged one) is chunked as it stands, so that the server's
    checks judge it rather than its frame cap. max_frame_bytes=0 never
    chunks."""
    from ..sketch.payload import chunk_frame, encode_frame

    head = {"client_id": sub.client_id, "round": sub.round, "latency_s": sub.latency_s}
    if sub.payload is None:
        if sub.payload_bytes:
            return [{**head, "payload": "x" * sub.payload_bytes}]
        return [head]
    p = sub.payload
    if isinstance(p, np.ndarray):
        p = encode_frame(p, max_frame_bytes=max_frame_bytes)
    elif (isinstance(p, dict) and isinstance(p.get("data"), str) and "schema" in p
          and p.get("total", 1) == 1):
        p = chunk_frame(p, max_frame_bytes)
    if isinstance(p, list):
        return [{**head, "chunk": f} for f in p]
    return [{**head, "payload": p}]


def _roundtrip(addr: tuple[str, int], sub: Submission, timeout_s: float = 5.0,
               max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> dict:
    data = _wire_bytes(sub, max_frame_bytes)
    # the bytes clients put on the wire (a send the server cuts off counts
    # whole: they were framed for it)
    obreg.default().counter("serve_client_wire_bytes_total").inc(len(data))
    with socket.create_connection(addr, timeout=timeout_s) as s:
        s.sendall(data)
        buf = b""
        while b"\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError("serve: connection closed mid-reply")
            buf += chunk
    return json.loads(buf.split(b"\n", 1)[0])


def abort_over_socket(addr: tuple[str, int], sub: Submission, timeout_s: float = 5.0,
                      max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> None:
    """A connection that dies mid-send (conn_drop): send half of the bytes
    the real submission would and close. The server sees a no-show: the
    partial frame or sequence never admits."""
    data = _wire_bytes(sub, max_frame_bytes)
    with socket.create_connection(addr, timeout=timeout_s) as s:
        s.sendall(data[:max(len(data) // 2, 1)])


def submit_with_retries(addr: tuple[str, int], sub: Submission, max_retries: int = 3,
                        base_backoff_s: float = 0.05, max_backoff_s: float = 2.0,
                        timeout_s: float = 5.0, sleep=time.sleep) -> str:
    """At-least-once client: bounded retries with jittered exponential
    backoff around the single round trip. Transport failures and SHEDDING
    retry (SHEDDING's retry_after_s floors the backoff); every other
    decision returns at once (a DUPLICATE on a retry is success). The
    jitter is a pure function of (client, round, attempt), so a test can
    replay the schedule."""
    from .clients import uniform01

    attempt = 0
    while True:
        try:
            reply = _roundtrip(addr, sub, timeout_s)
            status = reply["status"]
        except (OSError, ValueError) as e:
            status, reply = None, {}
            err = f"{type(e).__name__}: {e}"
        if status is not None and status != SHEDDING:
            return status
        if attempt >= max_retries:
            return status if status is not None else "CONN_FAILED"
        jitter = 0.5 + float(uniform01(0xB0FF, int(sub.client_id), int(sub.round), attempt))
        delay = min(base_backoff_s * (2 ** attempt), max_backoff_s) * jitter
        delay = max(delay, float(reply.get("retry_after_s", 0.0)))
        obreg.default().counter("serve_client_retries_total").inc()
        obtrace.instant("serve-ingest", "client:retry", client=int(sub.client_id),
                        round=int(sub.round), attempt=attempt + 1, why=(status or err),
                        backoff_s=round(delay, 4))
        sleep(delay)
        attempt += 1
