"""Client-side wire payload: frame a Count-Sketch table for transmission.
The port's copy of the JAX package's ``sketch/payload.py``.

The wire-payload round (``--serve_payload sketch``) ships each client's
[r, c] table to the aggregator. This module is the client half of that
wire: frame a table (``encode_frame``), and split a frame that is over a
transport's cap into chunks (``chunk_frame``). The tables themselves come
from the engine's client step (``engine.make_payload_round_steps``), which
sketches each update on the device and copies only the finished stack.

Frame format (schema version 2), the ``payload`` field of a submission
line:

    schema   int      wire schema version (a server refuses others with
                      STALE_SCHEMA)
    dtype    str      "<f4": little-endian float32
    shape    [r, c]   table dims (the server checks them against its spec)
    nbytes   int      byte length of the whole decoded payload
    crc32    int      zlib.crc32 of the whole raw byte string
    seq      int      this frame's position in the chunk sequence
    total    int      frames the payload spans (1 = unchunked)
    data     str      base64 of this frame's slice of the raw table bytes

A table bigger than a transport's ``max_frame_bytes`` is split across
``total`` frames: frame 0 carries the full header, continuation frames
repeat schema/seq/total with their data slice. Decoding, chunk reassembly
included, is the server's and lives in ``serve.ingest.validate_payload``.
"""

from __future__ import annotations

import base64
import zlib

import numpy as np

SCHEMA_VERSION = 2
# the one wire dtype: little-endian float32, the table's device dtype
WIRE_DTYPE = "<f4"
# cap on frames per payload: bounds what a server buffers for one
# submission whatever ``total`` a hostile frame claims
MAX_CHUNKS = 4096
# bytes the JSON envelope (keys, ints, quoting) may add around the data
# field; the chunk budget subtracts it so an encoded line stays under the cap
_ENVELOPE_SLACK = 512


def _chunk_raw_budget(max_frame_bytes: int) -> int:
    """Raw (pre-base64) bytes per chunk so an encoded frame line fits the
    cap: base64 inflates 4/3, the envelope adds slack, and the budget is
    floored to a multiple of 3 (one base64 group), so no chunk carries '='
    padding mid-stream."""
    budget = max((max_frame_bytes - _ENVELOPE_SLACK) * 3 // 4, 3)
    return budget - budget % 3


def encode_frame(table: np.ndarray, schema: int = SCHEMA_VERSION, max_frame_bytes: int = 0):
    """Frame a client's [r, c] table for the wire: one frame dict when the
    payload fits ``max_frame_bytes`` (0 = unlimited), else the list of
    ``total`` frames in sequence order, the header (nbytes, crc32 over the
    whole payload) on frame 0."""
    t = np.ascontiguousarray(np.asarray(table, np.float32))
    if t.ndim != 2:
        raise ValueError(f"payload table must be 2-D [r, c], got {t.shape}")
    raw = t.astype(WIRE_DTYPE, copy=False).tobytes()
    head = {
        "schema": int(schema),
        "dtype": WIRE_DTYPE,
        "shape": [int(t.shape[0]), int(t.shape[1])],
        "nbytes": len(raw),
        "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
        "seq": 0,
        "total": 1,
    }
    return _split(head, raw, max_frame_bytes)


def chunk_frame(frame: dict, max_frame_bytes: int):
    """An unchunked frame as it stands, header fields included, split into
    chunk frames when its data is over ``max_frame_bytes``; the frame
    itself when it fits. A client ships a damaged frame (a stale checksum,
    a cut payload) this way, so that it reaches the server's checks
    instead of the frame cap."""
    if max_frame_bytes <= 0 or len(frame["data"]) * 3 // 4 <= _chunk_raw_budget(max_frame_bytes):
        return frame
    head = {k: v for k, v in frame.items() if k != "data"}
    return _split(head, base64.b64decode(frame["data"]), max_frame_bytes)


def _split(head: dict, raw: bytes, max_frame_bytes: int):
    """One frame of ``raw`` under ``head``, or the chunk frames of
    ``raw`` at the cap (``head`` on frame 0)."""
    budget = _chunk_raw_budget(max_frame_bytes) if max_frame_bytes > 0 else 0
    if budget <= 0 or len(raw) <= budget:
        return {**head, "data": base64.b64encode(raw).decode("ascii")}
    total = -(-len(raw) // budget)
    if total > MAX_CHUNKS:
        raise ValueError(f"table of {len(raw)} bytes needs {total} chunks at "
                         f"max_frame_bytes={max_frame_bytes}, over MAX_CHUNKS {MAX_CHUNKS}: "
                         "raise the frame cap")
    frames = []
    for i in range(total):
        f = dict(head) if i == 0 else {"schema": head["schema"]}
        f["seq"], f["total"] = i, total
        f["data"] = base64.b64encode(raw[i * budget:(i + 1) * budget]).decode("ascii")
        frames.append(f)
    return frames
