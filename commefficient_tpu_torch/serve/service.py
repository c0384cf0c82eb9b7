"""The aggregation service: a running server over the session (the port's
copy of the JAX package's ``serve/service.py``: the sync and the
buffered-async service, serial or pipelined).

``AggregationService`` owns the serving stack (ingest queue, transport,
cohort assembler, traffic, metrics endpoint) and gives the run loop a
``ServedSource``: the round source ``runner.run_loop(source=...)`` pulls
from instead of the sampling prefetcher. A served round, on the dispatch
thread:

    1. ``session.sample_cohort(rnd)``    the invite list (the batch round's
                                         host draws: the parity rests on it)
    2. ``queue.open_round(rnd, ids)``    parked early submissions of invited
                                         clients admit at once
    3. traffic pushes submissions        transport.submit -> admission
    4. the assembler closes at W-of-N    quorum or deadline
    5. ``session.prepare_served_round``  the casualties are masked and
                                         queued exactly as client_drop faults

With ``--serve_payload sketch`` the round becomes the wire-payload round
(``_serve_payload_round``): the clients compute their [r, c] tables first
(``session.compute_client_tables``: one ``sketch_accumulate`` launch per
invitee on the card, then one copy of the [W, r, c] stack to the host),
the tables cross the transport (framed and checksummed over the loopback
socket when that is the transport) through the ingest validation, and the
merge (``dispatch_round``) consumes only the validated stack the close
collected. A rejected frame is bitwise a dropped client.

Threads: the socket engines and the metrics server run on threads of
their own and touch host numpy only. Serially, the client step and the
copies of the table stack run on the dispatch thread inside
``ServedSource.next()``; with ``--serve_pipeline`` the whole serve cycle
runs ahead on the pipeline's worker (``serve/pipeline.py``), which waits
before a payload round's client step until the previous round's merge is
dispatched (``_compute_gate``), so round r's client step reads the state
round r-1's merge produced either way. Both run on the device's default
stream, the one the merges run on.

On a group of ranks (``--mesh``, torchrun or ``--multihost``): rank 0 runs
the service, and the other ranks run a ``ServeFollower``, which makes the
same session calls in the same order without transport, ingest or
assembler. Right after each close rank 0 broadcasts it
(``parallel.distributed.broadcast_from_root`` on the serve group): the
[W] arrival mask, and on a payload round the validated [W, r, c] stack.
Every rank then prepares and merges exactly the bytes that crossed rank
0's wire, so a group's run is bitwise its one-device served twin (the
emulation at ``client_shards`` S), under the wire fault kinds too. The
same holds where the ranks also differ in their seq and model
coordinates (``--seq_parallel``, ``--model_parallel``), the client axis
down to one rank included: every rank keeps the whole flat state, so the
close goes to the whole job, while the payload client step computes over
the serve cycle's own seq and model groups and gathers over its client
axis's (``FederatedSession`` module docstring).

The buffered-async service (``--serve_async``, FedBuff-shaped): a round
closes at ``--serve_buffer`` validated tables instead of the quorum, and a
late table is not discarded but folded into a later merge with weight
(1 + lag) ** -``--serve_staleness``: a straggler that arrived after the
cut (``ClosedRound.straggler_tables``), or a payload for a round closed at
most ``--serve_stale_rounds`` ago, which the ingest band admits
ACCEPTED_STALE against that round's own screen state. At each payload
close ``_build_stale_fold`` fills up to ``session.cfg.stale_slots`` slots
in (source round, cohort position, admission order) order; entries older
than the band are dropped and counted, overflow waits for the next round.
The straggler is masked and queued at its own close all the same. A round
with no late table hands the merge no fold, so an async run where every
client is on time is bitwise the sync run. On a group rank 0 broadcasts
the filled slots and their count after the close (``_share_close``), and
every rank folds the same bytes in the same order.

Checkpoints: the early-submission buffer (and, async, the whole stale
band: parked late tables, the closed rounds' screen state, the straggler
stash and stale-poison tables in flight, through the reference's codec) is
snapshotted at every round boundary and published through
``session.serve_meta`` (meta.json "serve"); a restored session's
``restored_serve_meta`` re-seeds it, so a resumed run replays the arrival
stream and the folds of the uninterrupted one.

The fast path (``--serve_fastpath``): a layout and timing change, never an
order change, so a fast-path run is bitwise the same run without it. A
payload round opens a block of the ``TableRing`` (``serve/ring.py``; on
the GPU pinned once, when the pool makes it) at its invite and attaches it
to the queue; each validated table is written into its slot once (in
process the client's table is copied in; over the socket the decode
writes there, and the socket engines validate in batches on a
``GauntletPool``, ``serve/gauntlet.py``). While the window is open,
``_RingUploader``'s poller thread copies each finalized chunk of slots to
the device on a side CUDA stream of its own (``non_blocking``, from the
pinned block); at the close ``_finish_ring_stack`` ships the rest and
scatters the slots that made the cut into a zero [W, r, c] stack at their
cohort positions (``index_copy_``, positions filtered on the host), on the
stream the merge runs on, ordered after the copies by an event. The
merge's stack never crosses the host again, and the block goes back to the
pool, where its next ``reset`` waits for its last copy. On the CPU the
"upload" is a copy into a tensor of its own, never a view of the block.
On a group rank 0 broadcasts the stack it built from the ring.

The sharded ingest (``--serve_shards N``, socket eventloop only): with
``--serve_shard_mode thread`` N reactors (``serve/scale/shard.py``) front
the one queue; with ``process`` N SO_REUSEPORT worker processes
(``serve/scale/procshard.py``) each own their ``shard_for`` slice of the
admission state, the service's queue is the workers' control surface
(``ProcShardQueue``), the clients submit to their owner's port (a dead
shard's refused connection is a CONN_FAILED no-show), and ``shard_kill``
faults fire at the collect's start (``_consume_shard_kills``). With the
fast path the workers validate into one shared-memory ring block a shard
(``serve/scale/shmring.py``): the service views each block's tables as a
tensor, registered with CUDA on the GPU (a failed registration
raises; a pageable copy would be silently serial), runs one uploader a
block, and ``_finish_ring_stack`` scatters every block's admitted slots
into the one zero [N, r, c] stack (ownership makes their rows disjoint).
The root runs no ring pool and no validation pool of its own then.

The edge tree (``--serve_edges E``, ``serve/scale/edge.py``): the
session's ``serve_edges`` arms the edge merges (the grouped flat twin and
the partials root), and ``ServeConfig.edges`` the topology. At each
payload close ``_edge_round`` zeroes the arrival of the clients of the
edges an ``edge_kill`` fault kills this round, then the ``EdgeTree``
partitions the cohort by client-id hash (``shard_for``), each edge screens
its shard and sums it in cohort-position order on the host, and the merge
is the root over the [E, r, c] partials, with the [W] wire norms and
assignment the edges forward. An edge-armed session served without the
tree (``edges`` 0) merges the whole stack through the grouped flat twin:
bitwise the tree. Under a robust ``--merge_policy`` the tree runs in
forward mode (a NOTE on stderr): the edges forward their shards' tables,
reassembled into the stack for the plain robust merge. On a group rank 0
broadcasts what the merge reads: the edge-adjusted mask, the norms, the
assignment and the partials (the stack in the flat twin and in forward
mode). The tree does not compose with ``--serve_async``,
``--serve_pipeline``, ``--serve_fastpath`` or process shards (refused, in
the reference's words).
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import sys
import threading
import time

import numpy as np
import torch

from ..federated import engine as fed_engine
from ..obs import registry as obreg
from ..obs import trace as obtrace
from .assembler import ClosedRound, CohortAssembler
from .gauntlet import GauntletPool
from .ingest import IngestQueue, PayloadPolicy, Submission
from .metrics import MetricsServer, register_fastpath
from .ring import RingBlock, TableRing
from .scale.edge import EdgeTree, assign_edges, table_norms_host
from .traffic import TraceConfig, TrafficGenerator
from .transport import InProcessTransport, SocketTransport, abort_over_socket, submit_over_socket


# -- the stale band's checkpoint codec (the reference's, field for field, so
# a band written by either package reads in the other). meta.json needs
# JSON: base64 of a table's raw little-endian float32 bytes is exact.


def _enc_table(t) -> dict:
    a = np.ascontiguousarray(np.asarray(t, np.float32))
    return {"shape": list(a.shape), "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def _dec_table(d) -> np.ndarray:
    # the run's own checkpoint meta (tables that passed the validation when
    # they arrived), never wire input
    return np.frombuffer(base64.b64decode(d["b64"]), np.float32).reshape(d["shape"]).copy()


def _enc_band(band: dict, stash, poison) -> dict:
    """meta.json's "band": (the queue's band snapshot, the service's stale
    stash, the stale-poison tables in flight)."""
    return {
        "stale": [[int(r), int(c), float(lat), int(ro), _enc_table(t)]
                  for r, c, lat, ro, _w, t in band["stale"]],
        "recent": [[int(r), float(m), [[int(c), int(p)] for c, p in inv.items()],
                    sorted(int(c) for c in seen)]
                   for r, m, inv, seen in band["recent"]],
        "newest": band["newest"],
        "recv_counter": int(band["recv_counter"]),
        "stash": [[int(sr), int(pos), int(cid), _enc_table(t)] for sr, pos, cid, t in stash],
        "poison": [[int(sr), int(pos), int(cid), _enc_table(t)] for sr, pos, cid, t in poison],
    }


def _dec_band(enc: dict):
    """The inverse of ``_enc_band``: (queue band, stash, poison). An
    admission's wall time restarts at 0.0 (it feeds only the latency
    histogram, and a resumed process has a new clock)."""
    band = {
        "stale": [(int(r), int(c), float(lat), int(ro), 0.0, _dec_table(t))
                  for r, c, lat, ro, t in enc.get("stale", [])],
        "recent": [(int(r), float(m), {int(c): int(p) for c, p in inv}, {int(c) for c in seen})
                   for r, m, inv, seen in enc.get("recent", [])],
        "newest": enc.get("newest"),
        "recv_counter": int(enc.get("recv_counter", 0)),
    }
    stash = [(int(sr), int(pos), int(cid), _dec_table(t))
             for sr, pos, cid, t in enc.get("stash", [])]
    poison = [(int(sr), int(pos), int(cid), _dec_table(t))
              for sr, pos, cid, t in enc.get("poison", [])]
    return band, stash, poison


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service shape (the --serve_* flags)."""

    quorum: int = 0            # W-of-N close; 0 = the full cohort
    deadline_s: float = 4.0    # virtual deadline of the round close
    transport: str = "inproc"  # "inproc" | "socket"
    port: int = 0              # socket bind port (0 = ephemeral)
    metrics_port: int = -1     # >= 0 starts the HTTP endpoint (0 = ephemeral)
    queue_capacity: int = 1024
    pending_capacity: int = 256
    # "announce": submissions announce arrival and the session computes
    # every update; "sketch": submissions carry the client's table through
    # the validation, and the server merges the accepted tables (needs a
    # wire_payloads=True session)
    payload: str = "announce"
    # queue depth at or past this share of capacity sheds (0 = off)
    shed_watermark: float = 0.0
    shed_retry_after_s: float = 1.0
    # the socket engine: "eventloop" (the selectors reactor, default) or
    # "threaded" (a thread per connection)
    socket_transport: str = "eventloop"
    # connection cap of the socket engine; 0 = the engine's default
    # (threaded 128, eventloop 8192)
    max_conns: int = 0
    # --serve_pipeline: the serve cycle runs ahead on the pipeline's worker
    # (serve/pipeline.py), bitwise the serial source
    pipeline: bool = False
    # --serve_async: the buffered-async service (module docstring). The
    # close fires at buffer_size validated tables (0 = the quorum), late
    # tables fold with weight (1 + lag) ** -staleness_alpha while at most
    # stale_rounds behind; needs payload "sketch" and a session built with
    # stale_slots > 0
    async_mode: bool = False
    buffer_size: int = 0
    staleness_alpha: float = 0.5
    stale_rounds: int = 1
    # --serve_fastpath: the table ring, the batched validation over the
    # socket and the upload that overlaps the open window (module
    # docstring); bitwise the run without it. Needs payload "sketch"
    fastpath: bool = False
    # --serve_gauntlet_workers: the batched validation's threads (socket
    # only; in process the validation runs inline into the ring)
    gauntlet_workers: int = 2
    # --serve_shards: >= 2 shards the socket ingest over that many reactors
    # (clients routed by client-id hash; per-shard counters); 0 = one
    # listener
    shards: int = 0
    # --serve_shard_mode: "thread" (N reactor threads over the one queue)
    # or "process" (N SO_REUSEPORT worker processes, each owning its
    # clients' admission state; with the fast path, shared-memory ring
    # blocks). Process shards move bytes and verdicts, never arithmetic
    shard_mode: str = "thread"
    # --serve_edges: >= 2 arms the two-tier edge tree (serve/scale/edge.py):
    # each edge sums its hash shard's validated tables and forwards one
    # [r, c] partial to the root, bitwise the flat merge of the same
    # edge-armed session; a robust merge policy turns it into forward mode
    edges: int = 0

    @classmethod
    def from_args(cls, args) -> "ServeConfig":
        return cls(
            quorum=args.serve_quorum, deadline_s=args.serve_deadline, transport=args.serve,
            port=args.serve_port, metrics_port=args.serve_metrics_port,
            payload=args.serve_payload, shed_watermark=args.serve_shed_watermark,
            socket_transport=args.serve_transport, max_conns=args.serve_max_conns,
            pipeline=args.serve_pipeline, async_mode=args.serve_async,
            buffer_size=args.serve_buffer, staleness_alpha=args.serve_staleness,
            stale_rounds=args.serve_stale_rounds, fastpath=args.serve_fastpath,
            gauntlet_workers=args.serve_gauntlet_workers, shards=args.serve_shards,
            shard_mode=args.serve_shard_mode, edges=args.serve_edges)


def _check_payload_session(session, cfg: ServeConfig) -> None:
    if cfg.payload not in ("announce", "sketch"):
        raise ValueError(f"--serve_payload must be announce|sketch, got {cfg.payload!r}")
    if cfg.edges == 1 or cfg.edges < 0:
        raise ValueError(f"--serve_edges must be 0 (off) or >= 2, got {cfg.edges} (one edge IS "
                         "the flat merge)")
    if cfg.edges >= 2:
        if cfg.payload != "sketch":
            raise ValueError("--serve_edges aggregates client TABLES at the edge tier; the "
                             "announce path has none - arm --serve_payload sketch")
        if cfg.async_mode or cfg.pipeline:
            raise ValueError("--serve_edges does not compose with --serve_async/"
                             "--serve_pipeline yet (a stale table's edge assignment and the "
                             "worker's edge timing are open follow-ups) - drop one of the flags")
    if cfg.async_mode:
        if cfg.payload != "sketch":
            raise ValueError("--serve_async merges client tables as they arrive; the announce "
                             "path has no client-computed table to merge - arm "
                             "--serve_payload sketch")
        if session.cfg.stale_slots <= 0:
            raise ValueError("--serve_async needs a session built with stale_slots > 0 (the "
                             "CLIs arm it from the flag): the staleness-weighted fold takes "
                             "its late tables through those slots")
        if cfg.stale_rounds < 1:
            raise ValueError(f"--serve_stale_rounds must be >= 1 in async mode, got "
                             f"{cfg.stale_rounds} (0 stale rounds IS sync)")
        if cfg.staleness_alpha < 0:
            raise ValueError(f"--serve_staleness must be >= 0, got {cfg.staleness_alpha} "
                             "(0 = unweighted folds)")
    elif cfg.buffer_size:
        raise ValueError("--serve_buffer is the ASYNC buffer-size trigger; without "
                         "--serve_async the close discipline is the W-of-N quorum "
                         "(--serve_quorum)")
    if cfg.fastpath:
        if cfg.payload != "sketch":
            raise ValueError("--serve_fastpath accelerates the wire-PAYLOAD ingest path; the "
                             "announce path moves no tables - arm --serve_payload sketch")
        if cfg.edges >= 2 or session.cfg.serve_edges >= 2:
            raise ValueError("--serve_fastpath does not compose with --serve_edges yet (the "
                             "edge tier consumes the host table stack the ring replaces) - "
                             "drop one of the flags")
        if cfg.gauntlet_workers < 1:
            raise ValueError(f"--serve_gauntlet_workers must be >= 1, got "
                             f"{cfg.gauntlet_workers}")
    if cfg.payload == "sketch" and not session.cfg.wire_payloads:
        raise ValueError("--serve_payload sketch needs a session built with "
                         "wire_payloads=True (the CLIs arm it from the flag): the "
                         "payload round is another step pair, client tables + merge")


def _check_shards(cfg: ServeConfig) -> None:
    """The sharded ingest's compositions, refused with the reference's
    words."""
    if cfg.shard_mode not in ("thread", "process"):
        raise ValueError(f"--serve_shard_mode must be thread|process, got {cfg.shard_mode!r}")
    if cfg.shards >= 2:
        if cfg.transport != "socket":
            raise ValueError("--serve_shards shards the SOCKET ingest across reactors; the "
                             "inproc transport has no connections to shard - arm --serve socket")
        if cfg.socket_transport != "eventloop":
            raise ValueError("--serve_shards runs N event-loop reactors; the "
                             "thread-per-connection transport has no reactor to shard - arm "
                             "--serve_transport eventloop")
        if cfg.shard_mode == "process":
            # process shards share nothing: the admission state lives in the
            # workers, so a composition that reaches into the one queue in
            # the root is refused
            if cfg.async_mode:
                raise ValueError("--serve_shard_mode process does not compose with "
                                 "--serve_async yet (the stale admission band lives in the "
                                 "worker queues; its cross-process checkpoint/rewind "
                                 "discipline is a follow-up) - drop one of the flags")
            if cfg.pipeline:
                raise ValueError("--serve_shard_mode process does not compose with "
                                 "--serve_pipeline yet (the pipelined worker's boundary "
                                 "snapshots assume the in-process queue) - drop one of the flags")
            if cfg.edges >= 2:
                raise ValueError("--serve_shard_mode process does not compose with "
                                 "--serve_edges yet (the edge tier consumes the host table "
                                 "stack; the process shards hand over shm ring blocks) - drop "
                                 "one of the flags")
    elif cfg.shards < 0:
        raise ValueError(f"--serve_shards must be >= 0, got {cfg.shards}")
    elif cfg.shard_mode == "process":
        raise ValueError("--serve_shard_mode process needs --serve_shards >= 2 (one shard IS "
                         "the plain event-loop transport)")


def _shm_host_view(block, device: torch.device) -> None:
    """Give a process shard's shared-memory block the ``host`` tensor the
    uploader copies from: its tables, viewed in place. On the GPU the
    segment is registered with CUDA (page-locked), so the copies
    to the device are truly asynchronous; a registration that fails raises
    (a pageable source would make every copy silently synchronous). The
    view and the registration go before the segment's mapping closes."""
    host = torch.from_numpy(block.tables)
    if device.type != "cuda":
        def release():
            block.host = None
    else:
        cudart = torch.cuda.cudart()
        # the whole mapping, from its page-aligned base
        base = block._count.ctypes.data
        nbytes = -(-block.nbytes // 4096) * 4096
        rc = cudart.cudaHostRegister(base, nbytes, 0)
        if int(rc) != 0:
            raise RuntimeError(f"serve: cudaHostRegister of a {nbytes}-byte shared-memory table "
                               f"ring segment failed (cudaError {int(rc)})")
        if not host.is_pinned():
            cudart.cudaHostUnregister(base)
            raise RuntimeError("serve: a registered shared-memory table ring segment does not "
                               "read as pinned memory")

        def release():
            # no copy may still read the segment when it is unregistered
            torch.cuda.synchronize(device)
            block.host = None
            cudart.cudaHostUnregister(base)

    block.host = host
    block.before_close.append(release)


def _serve_group(session, root: bool):
    """The serve cycle's group of a session that spans a job of ranks
    (None on one device): the whole job's, whichever axes its ranks differ
    on. Checked against where the caller runs: the service on rank 0, the
    followers elsewhere."""
    if not session.spans_ranks:
        return None
    from ..parallel import distributed

    group = distributed.serve_group()
    if group is None:
        raise RuntimeError("a served group needs the serve cycle's own process group: join "
                           "with parallel.distributed.initialize")
    if (distributed.rank() == 0) != root:
        raise ValueError("a group's aggregation service runs on rank 0 and a ServeFollower on "
                         "each other rank")
    return group


def _agree(group, go: bool) -> bool:
    """The pipelined group's go/stop flag for the next round: rank 0's
    ``go``, broadcast on the serve group before any collective of that
    round, so every rank's worker serves the same rounds and stops at the
    same one."""
    from ..parallel import distributed

    flag = torch.tensor([1 if go else 0], dtype=torch.int64)
    return bool(distributed.broadcast_from_root([flag], group)[0][0])


class _RingUploader:
    """The copy of a ring block's slots to the device as they finalize: the
    fast path's overlap of the upload with the open window. A poller thread
    ships each finalized chunk of slots, on fixed boundaries (every
    ``max(1, capacity // 4)`` slots: the same chunks every round, whatever
    the arrival timing), into one [capacity, r, c] device tensor. On the GPU
    each chunk is a ``non_blocking`` copy from the pinned block on a side
    stream of the uploader's own, timed by CUDA events as ``"h2d_ring"`` in
    the session's ``wire_copy_stats``; on the CPU a copy into a tensor of
    its own. ``finish`` joins the poller, ships the rest of the acquired
    slots (a process shard's block is mostly empty) and returns the slots,
    ordered before the caller's stream by an event; an error of the poller
    is raised there."""

    POLL_S = 0.002  # the poller's period

    def __init__(self, block: RingBlock, session):
        self.block = block
        self._session = session
        self.device = session.device
        cap = block.capacity
        step = max(1, cap // 4)
        self._bounds = list(range(step, cap, step)) + [cap]
        # the poller's alone until finish() joins it
        self._bi = 0
        self._uploaded = 0
        self._stream = None
        shape = (cap, block.rows, block.cols)
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
            with torch.cuda.stream(self._stream):
                self.slots = torch.empty(shape, dtype=torch.float32, device=self.device)
        else:
            self.slots = torch.empty(shape, dtype=torch.float32)
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="serve-ring-upload",
                                        daemon=True)

    def start(self) -> "_RingUploader":
        self._thread.start()
        return self

    def _ship_through(self, ready: int) -> None:
        while self._bi < len(self._bounds) and self._bounds[self._bi] <= ready:
            lo, hi = self._uploaded, self._bounds[self._bi]
            # finalized slots' bytes do not change until the block's reset,
            # and the slots past the acquired ones are zeros
            src = self.block.host[lo:hi]
            if self._stream is None:
                self.slots[lo:hi].copy_(src)
            else:
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                with torch.cuda.stream(self._stream):
                    t0.record()
                    self.slots[lo:hi].copy_(src, non_blocking=True)
                    t1.record()
                self._session.note_wire_copy("h2d_ring", src.numel() * src.element_size(),
                                             t0, t1)
            self._uploaded, self._bi = hi, self._bi + 1

    def _run(self) -> None:
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
            while not self._stop.wait(self.POLL_S):
                self._ship_through(self.block.final_prefix())
        except BaseException as e:  # noqa: BLE001 - raised by finish()
            self._err = e

    def stop(self) -> None:
        """Stop the poller without finishing (the round is abandoned)."""
        self._stop.set()
        self._thread.join(timeout=30.0)

    def abandon(self) -> None:
        """Stop without finishing, and make the block's next ``reset`` wait
        for the copies already queued."""
        self.stop()
        if self._stream is not None:
            done = torch.cuda.Event()
            done.record(self._stream)
            self.block.upload_done = done

    def finish(self, count: int | None = None) -> torch.Tensor:
        """Join the poller, ship the chunks left that hold any of the first
        ``count`` slots (the acquired ones; all by default; the caller
        waited for them to finalize) and return the [capacity, r, c] slots,
        of which only those are defined."""
        self.stop()
        if self._thread.is_alive():
            raise RuntimeError("serve: the ring uploader did not stop within 30 s")
        if self._err is not None:
            raise self._err
        count = self.block.capacity if count is None else count
        while self._bi < len(self._bounds) and self._uploaded < count:
            self._ship_through(self._bounds[self._bi])
        if self._stream is not None:
            done = torch.cuda.Event()
            done.record(self._stream)
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            # allocated on the side stream, read on the consumer's
            self.slots.record_stream(consumer)
            self.block.upload_done = done
        return self.slots


class AggregationService:
    """See the module docstring. ``session`` is a FederatedSession;
    ``traffic`` a TrafficGenerator, or None for external clients only
    (socket transport). On a group of ranks it runs on rank 0 and shares
    each close with the others' ``ServeFollower``."""

    def __init__(self, session, cfg: ServeConfig, traffic: TrafficGenerator | None = None):
        if cfg.transport not in ("inproc", "socket"):
            raise ValueError(f"serve transport must be inproc|socket, got {cfg.transport!r}")
        _check_payload_session(session, cfg)
        _check_shards(cfg)
        self.group = _serve_group(session, root=True)
        if cfg.socket_transport not in ("threaded", "eventloop"):
            raise ValueError(f"--serve_transport must be threaded|eventloop, got "
                             f"{cfg.socket_transport!r}")
        quorum = cfg.quorum or session.num_workers
        if not 1 <= quorum <= session.num_workers:
            raise ValueError(f"--serve_quorum {cfg.quorum} must be in [1, num_workers="
                             f"{session.num_workers}]: the quorum closes an over-provisioned "
                             "cohort, it cannot exceed the invite list")
        if traffic is None and cfg.transport == "inproc":
            raise ValueError("inproc transport with no traffic generator would serve zero "
                             "submissions (pass a TrafficGenerator, or use the socket "
                             "transport with external clients)")
        payload_policy = payload_shape = None
        if cfg.payload == "sketch":
            mcfg = session.cfg.mode
            payload_shape = (mcfg.num_rows, mcfg.num_cols)
            # the gauntlet's sketch-space screen reads the ring the merge
            # screens against, so a QUARANTINED payload is the client the
            # merge would have quarantined
            payload_policy = PayloadPolicy(
                rows=payload_shape[0], cols=payload_shape[1],
                clip_multiple=float(session.cfg.client_update_clip),
                quarantine_median=session.quarantine_median_host)
        # the edge tree: the session's serve_edges arms the edge merges,
        # cfg.edges the topology; under a robust policy the tree forwards
        # per-client tables (the fan-in is forfeited, and the NOTE says so)
        robust = fed_engine.robust_policy(session.cfg)
        self._edge_tree = None
        if cfg.edges >= 2:
            if robust is not None:
                if session.cfg.serve_edges:
                    raise ValueError("robust merge policies run the edge tree in FORWARD mode "
                                     "against the plain robust program - build the session "
                                     "with serve_edges=0 (the CLIs do; EngineConfig rejects "
                                     "the combination too)")
                print(f"serve: NOTE - --serve_edges {cfg.edges} with merge_policy={robust!r}: "
                      "order statistics need per-client tables, so each edge FORWARDS its "
                      "shard's validated tables unsummed (W tables cross the tree, not E "
                      "partials - the robustness-vs-fanin trade-off; see README 'Scale-out "
                      "serving')", file=sys.stderr, flush=True)
            elif session.cfg.serve_edges != cfg.edges:
                raise ValueError(f"--serve_edges {cfg.edges} needs a session built with "
                                 f"serve_edges={cfg.edges} (got {session.cfg.serve_edges}): "
                                 "the edge partition size is part of the compiled merge "
                                 "variants - the CLIs arm it from the flag")
            self._edge_tree = EdgeTree(cfg.edges, payload_shape,
                                       forward_tables=robust is not None)
        self.session = session
        # async: the quorum becomes the buffer-size trigger (the close fires
        # when that many validated tables are in); sync keeps the quorum
        trigger = (min(cfg.buffer_size or quorum, session.num_workers) if cfg.async_mode
                   else quorum)
        if trigger < 1:
            raise ValueError(f"--serve_buffer must be >= 1, got {trigger}")
        self.cfg = dataclasses.replace(cfg, quorum=quorum, buffer_size=trigger)
        self.traffic = traffic
        self.queue = IngestQueue(capacity=cfg.queue_capacity,
                                 pending_capacity=cfg.pending_capacity,
                                 payload_policy=payload_policy,
                                 shed_watermark=cfg.shed_watermark,
                                 shed_retry_after_s=cfg.shed_retry_after_s,
                                 # the async band: late payloads for recently
                                 # closed rounds park for the fold
                                 stale_rounds=cfg.stale_rounds if cfg.async_mode else 0,
                                 stale_capacity=session.cfg.stale_slots)
        self.assembler = CohortAssembler(self.queue, trigger, cfg.deadline_s,
                                         payload_shape=payload_shape,
                                         buffered=cfg.async_mode, ring_mode=cfg.fastpath)
        # the async stash: (source round, cohort position, client id, table)
        # of late tables waiting for their fold, from each close's
        # stragglers and the queue's band; touched by the serve cycle only
        # (the pipeline's worker when pipelined)
        self._stale_stash: list[tuple[int, int, int, np.ndarray]] = []
        # client_stale_poison's second halves: (source round, position,
        # client id, poisoned table), withheld at their close and submitted
        # into the band at the next round's serving; band state like any
        # other
        self._stale_poison_pending: list[tuple[int, int, int, np.ndarray]] = []
        self._proc = None  # the process shards, when armed
        if cfg.transport == "socket":
            cap = {"max_conns": cfg.max_conns} if cfg.max_conns else {}
            if cfg.shards >= 2 and cfg.shard_mode == "process":
                from .scale.procshard import ProcShardedIngest

                # the admission state lives in the workers: the service's
                # queue becomes their control surface, which the assembler
                # drives as it drives the one queue
                self.transport = self._proc = ProcShardedIngest(
                    n_shards=cfg.shards, payload_shape=payload_shape,
                    payload_policy=payload_policy, port=cfg.port, fastpath=cfg.fastpath,
                    gauntlet_workers=cfg.gauntlet_workers,
                    queue_kwargs={"queue_capacity": cfg.queue_capacity,
                                  "pending_capacity": cfg.pending_capacity,
                                  "shed_watermark": cfg.shed_watermark,
                                  "shed_retry_after_s": cfg.shed_retry_after_s}, **cap)
                self.queue = self.assembler.queue = self.transport.queue
                if cfg.fastpath:
                    device = session.device
                    self._proc.on_block = lambda block: _shm_host_view(block, device)
            elif cfg.shards >= 2:
                from .scale.shard import ShardedIngest

                self.transport = ShardedIngest(self.queue, n_shards=cfg.shards, port=cfg.port,
                                               **cap)
            elif cfg.socket_transport == "eventloop":
                from .scale.eventloop import EventLoopTransport

                self.transport = EventLoopTransport(self.queue, port=cfg.port, **cap)
            else:
                self.transport = SocketTransport(self.queue, port=cfg.port, **cap)
        else:
            self.transport = InProcessTransport(self.queue)
        # the fast path: the ring every payload round lands in, and over the
        # socket the batched validation's pool the engines hand frames to
        # (one pool for every shard's reactor). Process shards run both in
        # their workers: the root has neither
        self._ring = self._gauntlet = None
        # round -> [(a ring block, its uploader), ...] while the round is
        # served: one pair, or one a process shard
        self._ring_blocks: dict[int, list] = {}
        if cfg.fastpath:
            register_fastpath()
            if self._proc is None:
                self._ring = TableRing(payload_shape[0], payload_shape[1], device=session.device)
                if cfg.transport == "socket":
                    self._gauntlet = GauntletPool(self.queue, workers=cfg.gauntlet_workers)
                    for tr in getattr(self.transport, "shards", (self.transport,)):
                        tr.gauntlet = self._gauntlet
        self.registry = obreg.default()
        self._rate = self.registry.meter("serve_arrival_rate")
        self._latency = self.registry.histogram("serve_submit_to_merge_ms")
        # a service counts only its own merges in the process-wide registry
        self._latency_base = self._latency.count
        self.queue.on_accept = self._rate.record
        # closed rounds whose merge has not committed yet: their
        # submission-to-merge latencies resolve at the commit
        self._unmerged: list[ClosedRound] = []
        self.metrics_server = (MetricsServer(self.metrics_snapshot, port=cfg.metrics_port)
                               if cfg.metrics_port >= 0 else None)
        # _pending_by_round[r] and _band_by_round[r]: the early-submission
        # buffer and (async; None sync) the whole stale band a run
        # positioned at committed round r starts from (checkpoints write
        # the committed ones, a rewind restores them)
        self._meta_lock = threading.Lock()
        self._pending_by_round: dict[int, list] = {}
        self._band_by_round: dict[int, tuple | None] = {}
        restored = session.restored_serve_meta
        if restored:
            self.queue.restore_pending(restored.get("pending", []))
            print(f"serve: restored {len(restored.get('pending', []))} pending early "
                  "submission(s) from checkpoint meta", file=sys.stderr, flush=True)
            if restored.get("band") is not None and cfg.async_mode:
                band, stash, poison = _dec_band(restored["band"])
                self.queue.restore_band(band)
                self._stale_stash, self._stale_poison_pending = stash, poison
                print(f"serve: restored stale band from checkpoint meta ({len(band['stale'])} "
                      f"parked, {len(stash)} stashed, {len(poison)} poison-pending)",
                      file=sys.stderr, flush=True)
        pending, band = self._boundary_state()
        self._pending_by_round[session.round] = pending
        self._band_by_round[session.round] = band
        # the checkpoint hook: utils/checkpoint.save calls it under the
        # session's mutate_lock and writes the result into meta.json
        session.serve_meta = self._serve_meta
        # the pipeline's payload compute gate (serve/pipeline.py sets it;
        # None: the serial source, whose compute runs inline)
        self._compute_gate = None
        self._started = False

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "AggregationService":
        if not self._started:
            if self._gauntlet is not None:
                self._gauntlet.start()
            self.transport.start()
            if self.metrics_server is not None:
                self.metrics_server.start()
            self._started = True
        return self

    def close(self) -> None:
        self.queue.shutdown()
        # the transport first: its connection threads may wait on verdicts
        # in flight, and the pool's stop fails the rest CLOSED
        self.transport.stop()
        if self._gauntlet is not None:
            self._gauntlet.stop()
        for rnd in list(self._ring_blocks):
            self._drop_ring(rnd)
        if self.metrics_server is not None:
            self.metrics_server.stop()
        self._started = False

    # -- the round source -----------------------------------------------

    def source(self, start_round: int | None = None) -> "ServedSource":
        """The run loop's round source (pipelined with ``cfg.pipeline``)."""
        return ServedSource(self, self.session.round if start_round is None else start_round,
                            pipelined=self.cfg.pipeline)

    def agree_round(self, rnd: int, stopping: bool) -> bool:
        """Whether the pipeline's worker serves round ``rnd``: not when its
        pipeline is stopping. On a group rank 0 decides for every rank."""
        if self.group is None:
            return not stopping
        return _agree(self.group, not stopping)

    def _share_close(self, closed: ClosedRound, rnd: int, stale=None, tables=None,
                     arrived=None, edge=None) -> None:
        """On a group: the close to every rank (the arrival mask, and a
        payload round's validated stack: ``tables``, the close's host stack
        or the fast path's ring-built one), as the followers' ``_receive``
        takes it. Async, a first broadcast carries the mask and the count of
        filled stale slots, a second the stack and those slots' tables and
        weights (only the filled ones). With an edge block (``edge``) the
        mask is ``arrived``, the edge-adjusted one, and the [W] norms and
        assignment follow it, then the [E, r, c] partials in place of the
        stack when the tree ran. The bits rank 0 merges are the ones it
        sent."""
        if self.group is None:
            return
        from ..parallel import distributed

        if torch.is_tensor(tables):
            # the ring's device stack: a group over gloo stages it through
            # the host anyway
            tables = tables.cpu()
        elif tables is not None:
            tables = torch.from_numpy(tables)
        with self._stage("broadcast", rnd):
            parts = [torch.from_numpy(closed.arrived if arrived is None
                                      else np.asarray(arrived, np.float32))]
            if edge is not None:
                parts += [torch.from_numpy(np.asarray(edge["norms"], np.float32)),
                          torch.from_numpy(np.asarray(edge["assign"], np.int32))]
                if edge["partials"] is not None:
                    tables = torch.from_numpy(np.asarray(edge["partials"], np.float32))
            if self.cfg.async_mode:
                k = 0 if stale is None else len(stale[1])
                distributed.broadcast_from_root(
                    parts + [torch.tensor([k], dtype=torch.int64)], self.group)
                parts = [tables]
                if k:
                    parts += [torch.from_numpy(stale[0]), torch.from_numpy(stale[1])]
            elif tables is not None:
                parts.append(tables)
            distributed.broadcast_from_root(parts, self.group)

    @contextlib.contextmanager
    def _stage(self, name: str, rnd: int):
        """One serving stage: a span on the serve-pipeline track and the
        ``serve_stage_<name>_ms`` histogram ``/metrics`` reads."""
        t0 = time.perf_counter()
        with obtrace.span("serve-pipeline", f"stage:{name}", round=rnd):
            yield
        self.registry.histogram(f"serve_stage_{name}_ms").observe(
            (time.perf_counter() - t0) * 1e3)

    def serve_round(self, rnd: int):
        """One served round's preparation: invite, collect, close at W-of-N,
        mask and queue the casualties. Returns (PreparedRound,
        ClosedRound)."""
        with obtrace.span("assembler", "serve_round", round=rnd):
            if self.cfg.payload == "sketch":
                prep, closed = self._serve_payload_round(rnd)
            else:
                with self._stage("invite", rnd):
                    ids = self.session.sample_cohort(rnd)
                    self.queue.open_round(rnd, ids)
                with self._stage("collect", rnd):
                    self._consume_shard_kills(rnd)
                    if self.traffic is not None:
                        submit = (self._proc_submit_fns()[0] if self._proc is not None
                                  else self.transport.submit)
                        self.traffic.respond_to_invites(rnd, ids, submit, self.cfg.deadline_s)
                        closed = self.assembler.close_virtual(rnd, ids)
                    else:
                        closed = self.assembler.close_wall(rnd, ids)
                self._share_close(closed, rnd, tables=closed.tables)
                with self._stage("prep", rnd):
                    prep = self.session.prepare_served_round(rnd, ids, closed.arrived)
        with self._meta_lock:
            self._unmerged.append(closed)
        return prep, closed

    def _submit_fns(self):
        """(submit, abort) of the payload round's clients. Over the socket
        every submission round-trips the real wire (to the client's shard,
        when the ingest is sharded), and a conn_drop is a real mid-send
        connection death; a transport failure raises. Process shards:
        ``_proc_submit_fns``."""
        if self._proc is not None:
            return self._proc_submit_fns()
        if self.cfg.transport != "socket":
            return self.transport.submit, None
        tr = self.transport
        if tr.address is None:
            raise ConnectionError("serve: the socket transport is not listening")
        route = getattr(tr, "addr_for", lambda cid: tr.address)
        return (lambda sub: submit_over_socket(route(sub.client_id), sub),
                lambda sub: abort_over_socket(route(sub.client_id), sub))

    def _proc_submit_fns(self):
        """(submit, abort) over the process shards: to the owner's direct
        port, a dead shard's refused connection resolving to a CONN_FAILED
        verdict (its client is a no-show, and the drop discipline applies)
        instead of an error of the round."""
        tr = self._proc

        def submit(sub):
            try:
                return submit_over_socket(tr.addr_for(sub.client_id), sub)
            except (OSError, ValueError):
                obreg.default().counter("serve_shard_submit_failed_total").inc()
                return "CONN_FAILED"

        def abort(sub):
            try:
                return abort_over_socket(tr.addr_for(sub.client_id), sub)
            except (OSError, ValueError):
                return "CONN_FAILED"

        return submit, abort

    def _consume_shard_kills(self, rnd: int) -> None:
        """Round ``rnd``'s shard_kill faults (process shards only): SIGKILL
        the scheduled workers at the start of the collect; their clients'
        submissions fail at the socket, the round closes without them, and
        the mask and the requeue make the death bitwise a client_drop of the
        dead shard's clients."""
        plan = self.session.fault_plan
        if self._proc is None or plan is None:
            return
        for k in plan.shard_kill_plan(rnd):
            self._proc.kill_shard(int(k))

    def _serve_payload_round(self, rnd: int):
        """The wire-payload round: the clients compute before the close (a
        real client sketches locally, then ships), the tables cross the
        transport, the validation checks each, and the close hands the merge
        only the validated stack. Every invitee whose payload missed the
        merge is masked and queued as a dropped client. With the fast path
        the tables land in a ring block opened at the invite and go to the
        device while the window is open (module docstring)."""
        with self._stage("prep", rnd):
            ids = self.session.sample_cohort(rnd)
            prep0 = self.session.prepare_served_round(rnd, ids, np.ones(len(ids), np.float32))
        with self._stage("compute", rnd):
            if self._compute_gate is not None:
                self._compute_gate(rnd)
            tables, aux = self.session.compute_client_tables(prep0)
        with self._stage("invite", rnd):
            self.queue.open_round(rnd, ids)
            if self.cfg.fastpath:
                self._open_ring(rnd, len(ids))
        try:
            return self._collect_payload_round(rnd, ids, prep0, tables, aux)
        finally:
            if rnd in self._ring_blocks:  # the round failed before its stack
                self._drop_ring(rnd)

    def _collect_payload_round(self, rnd: int, ids, prep0, tables, aux):
        """The payload round from its collect on (``_serve_payload_round``)."""
        with self._stage("collect", rnd):
            self._consume_shard_kills(rnd)
            if self.traffic is not None:
                plan = self.session.fault_plan
                wire = plan.wire_plan(rnd, len(ids)) if plan is not None else None
                if self.cfg.async_mode and plan is not None and plan.has_stale_poison():
                    # the stale-band attack's first half: the scheduled
                    # positions withhold their on-time payload (a no-show at
                    # this close), and the poisoned table waits for a late
                    # submission at the next round's serving, where it is
                    # screened against this round's kept median
                    wire = dict(wire or {})
                    for pos, factor in plan.stale_poison_plan(rnd, len(ids)):
                        wire.setdefault(int(pos), {})["withhold"] = True
                        self._stale_poison_pending.append(
                            (rnd, int(pos), int(ids[pos]),
                             np.asarray(factor * tables[pos], np.float32)))
                submit, abort = self._submit_fns()
                self.traffic.respond_to_invites(rnd, ids, submit, self.cfg.deadline_s,
                                                payloads=tables, wire=wire, abort=abort)
                closed = self.assembler.close_virtual(rnd, ids)
            else:
                closed = self.assembler.close_wall(rnd, ids)
        stale = None
        if self.cfg.async_mode:
            with self._stage("prep", rnd):
                # the poison's late half goes through the real admission
                # band first, then the fold is built, then this close's
                # stragglers wait for a later one
                self._submit_stale_poison(rnd)
                stale = self._build_stale_fold(rnd)
                self._stash_stragglers(closed)
        arrived, wire_tables, edge = closed.arrived, closed.tables, None
        with self._stage("prep", rnd):
            if self.cfg.fastpath:
                wire_tables = self._finish_ring_stack(rnd, closed)
            else:
                arrived, wire_tables, edge = self._edge_round(rnd, ids, closed, aux)
        self._share_close(closed, rnd, stale, wire_tables, arrived=arrived, edge=edge)
        with self._stage("prep", rnd):
            # (an edge block only where there is one: the call is the plain
            # round's otherwise)
            prep = self.session.finish_served_payload(
                prep0, arrived, wire_tables, aux, stale=stale,
                **({} if edge is None else {"edge": edge}))
        return prep, closed

    def _edge_round(self, rnd: int, ids, closed: ClosedRound, aux):
        """The edge tier of a payload round: (arrived, the stack, the edge
        block or None), the close's own when neither the tree nor an
        edge-armed session is in play.

        - The edges an ``edge_kill`` fault kills this round zero their
          clients' arrival first: bitwise those clients dropped, masked and
          queued.
        - With the tree, each edge screens and sums its shard, and the block
          carries the [E, r, c] partials with the [W] norms and assignment;
          in forward mode the edges' tables are reassembled into the stack
          and there is no block (the plain robust merge).
        - An edge-armed session without the tree (the flat twin) gets the
          norms and assignment of the whole stack, and no partials."""
        session_edges = self.session.cfg.serve_edges
        if self._edge_tree is None and session_edges < 2:
            return closed.arrived, closed.tables, None
        arrived = np.array(closed.arrived, np.float32, copy=True)
        if self._edge_tree is None:
            return arrived, closed.tables, {"assign": assign_edges(ids, session_edges),
                                            "norms": table_norms_host(closed.tables),
                                            "partials": None}
        tree = self._edge_tree
        plan = self.session.fault_plan
        if plan is not None:
            for e in plan.edge_kill_plan(rnd):
                tree.kill(int(e))
        dead = tree.dead_positions(ids)
        if len(dead):
            arrived[dead] = 0.0
            print(f"serve: edge(s) {tree.dead_edges} dead at round {rnd}: {len(dead)} shard "
                  "client(s) dropped + re-queued", file=sys.stderr, flush=True)
        ecfg = self.session.cfg
        screen = None
        if ecfg.client_update_clip > 0 and not tree.forward_tables:
            # the baseline the merge reads at dispatch, and the gauntlet
            # screened this round's wire against
            screen = (float(ecfg.client_update_clip), self.session.quarantine_median_host())
        # the edges fold with the masks the merge recomputes (participation
        # times arrival times the screen); the participation mask comes to
        # the host at the round's one sync point, after the tables
        base_live = aux[3].cpu().numpy().astype(np.float32) * arrived
        try:
            reports, root = tree.aggregate_round(rnd, ids, closed.tables, base_live,
                                                 screen=screen)
        finally:
            tree.revive_all()  # an edge dies for its round only
        if tree.forward_tables:
            stack = np.zeros_like(np.asarray(closed.tables, np.float32))
            for rep in reports:
                if rep.tables is not None and len(rep.positions):
                    stack[rep.positions] = rep.tables
            return arrived, stack, None
        return arrived, closed.tables, root

    def _open_ring(self, rnd: int, n: int) -> None:
        """Arm the fast path for round ``rnd``: a ring block of ``n`` slots
        attached to its window (with process shards, the shards' blocks the
        open prepared), and an uploader a block shipping its slots as they
        finalize."""
        if self._proc is not None:
            blocks = self._proc.ring_blocks()
        else:
            blocks = [self._ring.open_block(rnd, n)]
            self.queue.attach_block(rnd, blocks[0])
        self._ring_blocks[rnd] = [(b, _RingUploader(b, self.session).start()) for b in blocks]

    def _drop_ring(self, rnd: int) -> None:
        """Forget round ``rnd``'s blocks without building its stack (the
        round failed, or the service closed): the uploaders stop, a pooled
        block, which a copy may still read, does not go back to the pool,
        and a shard's block waits for the copies queued before its next
        reset."""
        for _, uploader in self._ring_blocks.pop(rnd):
            uploader.abandon()

    def _finish_ring_stack(self, rnd: int, closed: ClosedRound) -> torch.Tensor:
        """The merge's [N, r, c] stack of round ``rnd``, on the session's
        device, from its ring blocks: wait for the decodes in flight to
        finalize their slots, finish the uploads the open window overlapped,
        and scatter the admitted slots whose client made the cut into a zero
        stack at their cohort positions (a table a block had no slot for
        lands on its own). Bitwise the assembler's host stack: the copies
        move bytes, each position is written at most once (a client has one
        position and one owning shard, so the shards' blocks write disjoint
        rows) and every other row is the same +0.0. A process shard that died
        in the round left slots its clients' masks drop. A pooled block then
        goes back to the pool."""
        pairs = self._ring_blocks.pop(rnd)
        n = len(closed.invited)
        r, c = self.assembler.payload_shape
        stack = total = None
        host = self.session._host  # pinned on the GPU: the copies queue without a sync
        for k, (block, uploader) in enumerate(pairs):
            alive = self._proc is None or self._proc.workers[k].alive
            if alive and not block.wait_final(timeout_s=30.0):
                for _, up in pairs[k:]:
                    up.abandon()
                raise RuntimeError(f"serve: round {rnd}'s ring block has slots no decode "
                                   "finalized within 30 s of the close")
            count, positions, valid, extras = block.snapshot()
            # a shard's block is about 1 / N full: its empty tail stays home
            slots = uploader.finish(count)
            dev = slots.device
            if stack is None:
                stack = torch.zeros((n, r, c), dtype=torch.float32, device=dev)
                total = 0
            total += count
            pos = positions[:count]
            sel = np.flatnonzero(valid[:count] & (pos >= 0) & (pos < n))
            sel = sel[closed.arrived[pos[sel]] == 1.0]
            if len(sel):
                stack.index_copy_(0, host(pos[sel].astype(np.int64)).to(dev, non_blocking=True),
                                  slots.index_select(0, host(sel).to(dev, non_blocking=True)))
            for p, table in extras:
                if 0 <= p < n and closed.arrived[p] == 1.0:
                    stack[p] = host(np.asarray(table, np.float32)).to(dev, non_blocking=True)
            if self._ring is not None:
                self._ring.release(block)
        self.registry.histogram("serve_ring_occupancy").observe(float(total))
        return stack

    def _submit_stale_poison(self, rnd: int) -> None:
        """Push the due stale-poison tables (withheld at an earlier close) as
        late submissions for their source round, through the transport a
        client uses. The band decides: ACCEPTED_STALE inside it and the
        screen, QUARANTINED over the screen, OUT_OF_ROUND aged out."""
        due = [e for e in self._stale_poison_pending if e[0] < rnd]
        if not due:
            return
        self._stale_poison_pending = [e for e in self._stale_poison_pending if e[0] >= rnd]
        submit, _ = self._submit_fns()
        for sr, pos, cid, table in due:
            status = submit(Submission(client_id=int(cid), round=int(sr), latency_s=0.0,
                                       payload=table))
            obtrace.instant("serve-ingest", "stale_poison_submit", round=int(rnd),
                            source_round=int(sr), client=int(cid), status=status)
            print(f"serve: stale-poison table from client {cid} (round {sr}) submitted late "
                  f"-> {status}", file=sys.stderr, flush=True)

    def _stash_stragglers(self, closed: ClosedRound) -> None:
        """Keep a close's validated tables that missed the cut for a later
        fold. The client is masked and queued at this close all the same
        (it missed this round): the fold keeps its work, the queue its
        turn."""
        for pos, cid, table in closed.straggler_tables:
            self._stale_stash.append((int(closed.rnd), pos, cid, table))

    def _build_stale_fold(self, rnd: int):
        """Round ``rnd``'s fold: the stash plus the queue's late admissions,
        each weighted (1 + lag) ** -alpha, lag = rnd - source round. An
        entry more than ``stale_rounds`` behind is dropped (counted);
        overflow past the session's ``stale_slots`` waits for the next
        round (to merge then or age out then, never both). Slots are filled
        in (source round, cohort position) order, a late admission's
        position being num_workers + its admission order: a function of
        the submissions, never of wall time. Returns the filled slots
        ([n, r, c] tables, [n] weights), or None when nothing is due (the
        round then runs the plain merge)."""
        for a in self.queue.drain_stale():
            self._stale_stash.append((int(a.round), self.session.num_workers + int(a.recv_order),
                                      int(a.client_id), a.table))
        if not self._stale_stash:
            return None
        keep, dropped = [], 0
        for e in self._stale_stash:
            if rnd - e[0] > self.cfg.stale_rounds:
                dropped += 1  # too stale to be worth its noise
            else:
                keep.append(e)
        keep.sort(key=lambda e: (e[0], e[1]))
        ready = [e for e in keep if rnd - e[0] >= 1][:self.session.cfg.stale_slots]
        folded = {(sr, cid) for sr, _, cid, _ in ready}
        self._stale_stash = [e for e in keep if (e[0], e[2]) not in folded]
        if dropped:
            self.registry.counter("serve_stale_dropped_total").inc(dropped)
            print(f"serve: dropped {dropped} stale table(s) aged past the "
                  f"{self.cfg.stale_rounds}-round band", file=sys.stderr, flush=True)
        if not ready:
            return None
        tables = np.stack([np.asarray(t, np.float32) for _, _, _, t in ready])
        weights = np.array([(1.0 + (rnd - sr)) ** -self.cfg.staleness_alpha
                            for sr, _, _, _ in ready], np.float32)
        for sr, _, cid, _ in ready:
            obtrace.instant("serve-ingest", "stale_fold", round=int(rnd), source_round=int(sr),
                            client=int(cid))
        self.registry.counter("serve_stale_folded_total").inc(len(ready))
        return tables, weights

    def record_merges(self, committed_round: int | None = None) -> int:
        """Resolve the submission-to-merge latency of every closed round the
        session has committed: each accepted submission's accept-to-commit
        wall time goes into the ``serve_submit_to_merge_ms`` histogram.
        Returns how many resolved."""
        committed = self.session.round if committed_round is None else committed_round
        with self._meta_lock:
            ready = [c for c in self._unmerged if c.rnd < committed]
            self._unmerged = [c for c in self._unmerged if c.rnd >= committed]
        now = time.perf_counter()
        n = 0
        for closed in ready:
            for pos in range(len(closed.invited)):
                wall = float(closed.wall_ts[pos])
                if closed.arrived[pos] == 0.0 or wall == float("inf"):
                    continue  # masked out of the merge, or never accepted
                self._latency.observe((now - wall) * 1e3)
                n += 1
        return n

    # -- checkpoint and metrics surfaces --------------------------------

    def _boundary_state(self):
        """(pending, band) of a round boundary: the queue's half under one
        lock hold (a submission between two reads would tear it), and
        async the stash and stale-poison lists, which only the serve cycle
        changes; band is None on a sync service. Validated tables do not
        change, so the references are a frozen view; they are encoded when
        a checkpoint is written."""
        pending, qband = self.queue.boundary_snapshot()
        band = ((qband, list(self._stale_stash), list(self._stale_poison_pending))
                if self.cfg.async_mode else None)
        return pending, band

    def _record_boundary(self, next_round: int) -> None:
        """Snapshot the pending buffer (and, async, the stale band) as the
        state a run positioned at ``next_round`` starts from; drop
        snapshots behind the committed round."""
        pending, band = self._boundary_state()
        with self._meta_lock:
            self._pending_by_round[next_round] = pending
            self._band_by_round[next_round] = band
            committed = self.session.round
            for r in [r for r in self._pending_by_round if r < committed]:
                del self._pending_by_round[r]
                self._band_by_round.pop(r, None)

    def _serve_meta(self) -> dict:
        """The checkpoint block: the pending buffer (and, async, the whole
        stale band) as of the committed round (the caller holds the
        session's mutate_lock), so a resume with late tables in flight
        replays the uninterrupted run's folds."""
        with self._meta_lock:
            committed = self.session.round
            if committed in self._pending_by_round:
                pending = self._pending_by_round[committed]
                band = self._band_by_round.get(committed)
            else:
                pending, band = self._boundary_state()
            out = {"round": committed, "pending": [[int(c), float(s)] for c, s in pending]}
            if band is not None:
                out["band"] = _enc_band(*band)
            return out

    def rewind_to_committed(self) -> None:
        """Restore the live pending buffer (and the stale band) to the
        committed boundary (the twin of run_loop's host-RNG rewind), close
        any window left open, drop the band's state of rounds that never
        committed and the served rounds that never committed, so a session
        and service reused after an interrupted loop replay identically."""
        committed = self.session.round
        for r in self.queue.open_rounds():
            if r >= committed:
                self.queue.close_round(r)
        # late payloads for a round served again must not meet their own
        # replay
        self.queue.prune_stale(committed)
        with self._meta_lock:
            pending = self._pending_by_round.get(committed)
            band = self._band_by_round.get(committed)
            self._unmerged = [c for c in self._unmerged if c.rnd < committed]
        if pending is not None:
            self.queue.restore_pending(pending)
        if band is not None:
            # the whole band as the committed boundary had it: what the
            # uncommitted rounds drained, stashed or counted comes back
            qband, stash, poison = band
            self.queue.restore_band(qband)
            self._stale_stash, self._stale_poison_pending = list(stash), list(poison)

    def metrics_snapshot(self) -> dict:
        """The ``/metrics`` payload (``serve/metrics.py``)."""
        s = self.session
        return {
            "round": int(s.round),
            "queue_depth": self.queue.depth(),
            "arrival_rate_per_s": round(self._rate.rate(), 3),
            "submissions": self.queue.counters(),
            "rounds": self.assembler.counters(),
            "requeue_depth": len(s._requeue),
            "clients_quarantined": int(s.clients_quarantined_total),
            "latency_ms": {**self._latency.summary(),
                           "count": self._latency.count - self._latency_base},
            "round_phase_ms": {ph: self.registry.histogram(f"runner_phase_{ph}_ms").summary()
                               for ph in obreg.RUNNER_PHASES},
            "serve_stage_ms": {st: self.registry.histogram(f"serve_stage_{st}_ms").summary()
                               for st in obreg.SERVE_STAGES},
            # the commit-to-next-dispatch gap the run loop measures (about
            # 0 pipelined, the whole serve cycle serial)
            "server_idle_ms": round(self.registry.gauge("server_idle_ms").value, 3),
            "pipeline": bool(self.cfg.pipeline),
            "async": bool(self.cfg.async_mode),
            # the async posture: the trigger, the staleness discipline and
            # the late tables admitted at the band, folded and dropped
            "stale": {
                "buffer_size": int(self.cfg.buffer_size),
                "staleness_alpha": float(self.cfg.staleness_alpha),
                "stale_rounds": int(self.cfg.stale_rounds),
                "admitted": int(self.registry.counter("serve_stale_admitted_total").value),
                "folded": int(self.registry.counter("serve_stale_folded_total").value),
                "dropped": int(self.registry.counter("serve_stale_dropped_total").value),
            } if self.cfg.async_mode else None,
            # the fast path's posture (null without it): the validation
            # batches' ms, the ring's fill, its overflows and the host bytes
            # of the tables' copies
            "fastpath": {
                "gauntlet_workers": int(self.cfg.gauntlet_workers),
                "gauntlet_batch_ms": self.registry.histogram("serve_gauntlet_batch_ms").summary(),
                "ring_occupancy": self.registry.histogram("serve_ring_occupancy").summary(),
                "ring_overflow": int(self.registry.counter("serve_ring_overflow_total").value),
                "bytes_copied": int(
                    self.registry.counter("serve_table_bytes_copied_total").value),
            } if self.cfg.fastpath else None,
            "quorum": self.cfg.quorum,
            "invited_per_round": s.num_workers,
            "deadline_s": self.cfg.deadline_s,
            "transport": self.cfg.transport,
            "transport_engine": (self.cfg.socket_transport if self.cfg.transport == "socket"
                                 else None),
            # the sharded ingest: each shard's counters and load-scaled shed
            # hint (also in /metrics.prom), its mode, and the worker deaths
            "shards": (self.transport.counters() if self.cfg.shards >= 2 else None),
            "shard_mode": self.cfg.shard_mode if self.cfg.shards >= 2 else None,
            "shard_deaths": (int(self.registry.counter("serve_shard_deaths_total").value)
                             if self._proc is not None else None),
            # the edge tier: its size, mode (partial or forward), dead edges
            # and the deaths and partials counted so far
            "edge": self._edge_tree.counters() if self._edge_tree is not None else None,
            "payload": self.cfg.payload,
            # the armed Byzantine defence: the merge (the sum or a robust
            # statistic) and how wide the quarantine screens
            "merge_policy": s.cfg.merge_policy,
            "merge_trim": int(s.cfg.merge_trim),
            "quarantine_scope": s.cfg.quarantine_scope,
        }


class ServeFollower:
    """The service's part on every rank but 0 of a served job: the session
    calls rank 0's service makes, in the same order, with the close taken
    from rank 0's broadcast instead of a transport, an ingest queue and an
    assembler. So every rank draws the same host RNG, queues the same
    casualties and merges the same validated stack (and, async, folds the
    same late tables). It holds no queue, so it has no pending buffer or
    stale band to snapshot, restore or rewind, and serves no port."""

    def __init__(self, session, cfg: ServeConfig):
        _check_payload_session(session, cfg)
        self.group = _serve_group(session, root=False)
        if self.group is None:
            raise ValueError("a ServeFollower follows rank 0's service over a group of ranks; "
                             "this session does not span one")
        self.session = session
        self.cfg = cfg
        self._compute_gate = None

    def start(self) -> "ServeFollower":
        return self

    def close(self) -> None:
        pass

    def source(self, start_round: int | None = None) -> "ServedSource":
        return ServedSource(self, self.session.round if start_round is None else start_round,
                            pipelined=self.cfg.pipeline)

    def agree_round(self, rnd: int, stopping: bool) -> bool:
        """Rank 0's decision, whatever this rank's pipeline wants."""
        return _agree(self.group, False)

    def _edge_layout(self) -> tuple[bool, int | None]:
        """What rank 0's ``_edge_round`` gives a payload round: (whether
        there is an edge block, the edge count E whose partials replace the
        stack or None)."""
        edges, session_edges = self.cfg.edges, self.session.cfg.serve_edges
        if edges >= 2 and fed_engine.robust_policy(self.session.cfg) is not None:
            return False, None  # forward mode: the reassembled stack
        if edges >= 2:
            return True, edges
        return session_edges >= 2, None

    def _receive(self, n: int, payload: bool) -> tuple:
        """Rank 0's close as host numpy: (the [n] arrival mask, on a payload
        round the validated [n, r, c] stack, async the filled stale slots'
        ([k, r, c] tables, [k] weights) or None, and the edge block or
        None; with the tree's partials the stack is None)."""
        from ..parallel import distributed

        mask = [torch.empty(n, dtype=torch.float32)]
        if not payload:
            return distributed.broadcast_from_root(mask, self.group)[0].numpy(), None, None, None
        shape = (self.session.cfg.mode.num_rows, self.session.cfg.mode.num_cols)
        has_edge, n_partials = self._edge_layout()
        if has_edge:
            got = distributed.broadcast_from_root(
                mask + [torch.empty(n, dtype=torch.float32), torch.empty(n, dtype=torch.int32),
                        torch.empty((n_partials or n,) + shape, dtype=torch.float32)],
                self.group)
            arrived, norms, assign, tables = (t.numpy() for t in got)
            edge = {"assign": assign, "norms": norms,
                    "partials": tables if n_partials else None}
            return arrived, None if n_partials else tables, None, edge
        k, parts = 0, mask
        if self.cfg.async_mode:
            arrived, count = distributed.broadcast_from_root(
                mask + [torch.empty(1, dtype=torch.int64)], self.group)
            k, parts = int(count[0]), []
        parts = parts + [torch.empty((n,) + shape, dtype=torch.float32)]
        if k:
            parts += [torch.empty((k,) + shape, dtype=torch.float32),
                      torch.empty(k, dtype=torch.float32)]
        got = distributed.broadcast_from_root(parts, self.group)
        if not self.cfg.async_mode:
            arrived = got.pop(0)
        stale = (got[1].numpy(), got[2].numpy()) if k else None
        return arrived.numpy(), got[0].numpy(), stale, None

    def serve_round(self, rnd: int):
        """Rank 0's ``serve_round`` without the transport: (PreparedRound,
        None)."""
        s = self.session
        with obtrace.span("assembler", "serve_round", round=rnd):
            ids = s.sample_cohort(rnd)
            if self.cfg.payload != "sketch":
                arrived = self._receive(len(ids), payload=False)[0]
                return s.prepare_served_round(rnd, ids, arrived), None
            prep0 = s.prepare_served_round(rnd, ids, np.ones(len(ids), np.float32))
            if self._compute_gate is not None:
                self._compute_gate(rnd)
            # joins the client step's ordered gather; rank 0 alone copies
            # the stack to the host for its transport
            _, aux = s.compute_client_tables(prep0, to_host=False)
            arrived, tables, stale, edge = self._receive(len(ids), payload=True)
            return s.finish_served_payload(prep0, arrived, tables, aux, stale=stale,
                                           **({} if edge is None else {"edge": edge})), None

    def _record_boundary(self, next_round: int) -> None:
        pass

    def record_merges(self, committed_round: int | None = None) -> int:
        return 0

    def rewind_to_committed(self) -> None:
        pass


class ServedSource:
    """The run loop's round source backed by the service (or a group's
    follower). Serial: ``next()`` runs the whole invite -> collect -> close
    cycle on the dispatch thread (the device still overlaps: the merge of
    round N runs while round N+1 is served, up to the payload round's table
    copy). Pipelined: the cycle runs ahead on the pipeline's worker
    (``serve/pipeline.py``) and ``next()`` pops a ready round.
    ``closed_rounds`` keeps each round's ClosedRound (rank 0's) for
    observers."""

    def __init__(self, service, start_round: int, pipelined: bool = False):
        self.service = service
        self._next = start_round
        self.last_closed: ClosedRound | None = None
        self.closed_rounds: list[ClosedRound] = []
        service._record_boundary(start_round)
        self._pipeline = None
        if pipelined:
            from .pipeline import RoundPipeline

            self._pipeline = RoundPipeline(service, start_round).start()

    def next(self):
        rnd = self._next
        if self._pipeline is not None:
            # the worker served this round and recorded its boundary
            prep, closed = self._pipeline.next()
        else:
            prep, closed = self.service.serve_round(rnd)
            self.service._record_boundary(rnd + 1)
        if closed is not None:
            self.last_closed = closed
            self.closed_rounds.append(closed)
        self._next = rnd + 1
        return prep

    def on_dispatched(self, rnd: int):
        """The run loop's dispatch hook: round ``rnd``'s merge is dispatched,
        so the pipeline's worker may compute round rnd + 1's tables."""
        if self._pipeline is not None:
            self._pipeline.on_dispatched(rnd)

    def on_committed(self, committed_round: int):
        """The run loop's commit hook: submission-to-merge latencies resolve
        at the commit that published their round."""
        self.service.record_merges(committed_round)

    def stop(self):
        # the worker first: the loop's exit rewind (host RNG, requeue,
        # pending buffer) must not race a preparation in flight
        if self._pipeline is not None:
            self._pipeline.stop()
        # the loop may have served rounds that never commit (preemption, an
        # early exit): rewind the pending buffer with the host RNG
        self.service.rewind_to_committed()


def service_from_args(args, session) -> AggregationService | ServeFollower | None:
    """Build and start the service of a CLI run (after the checkpoint
    restore, so a resumed service picks up the persisted pending queue);
    None with --serve off. On a group of ranks rank 0 builds the service
    and the other ranks a ``ServeFollower``, which prints nothing. The
    trace's population defaults to the dataset's client count and its seed
    to --seed unless the spec pins them."""
    if args.serve == "off":
        return None
    from ..parallel import distributed

    if session.spans_ranks:
        if distributed.rank() != 0:
            return ServeFollower(session, ServeConfig.from_args(args)).start()
    spec = args.serve_trace
    trace = TraceConfig.parse(spec)
    pinned = {p.partition("=")[0].strip() for p in spec.split(",") if p.strip()}
    if "population" not in pinned:
        trace = dataclasses.replace(trace, population=args.num_clients)
    if "seed" not in pinned:
        trace = dataclasses.replace(trace, seed=args.seed)
    scfg = ServeConfig.from_args(args)
    service = AggregationService(session, scfg, traffic=TrafficGenerator(trace)).start()
    addr = service.transport.address
    maddr = service.metrics_server.address if service.metrics_server is not None else None
    print(f"serve: {service.cfg.transport} transport"
          + (f" ({service.cfg.socket_transport})" if service.cfg.transport == "socket" else "")
          + (f" on {addr[0]}:{addr[1]}" if addr else "")
          + (f", {service.cfg.shards} ingest shards ({service.cfg.shard_mode}"
             + (" processes, SO_REUSEPORT + shm ring)" if service.cfg.shard_mode == "process"
                else "s)") if service.cfg.shards >= 2 else "")
          + (f", {service.cfg.edges}-edge tree" if service.cfg.edges >= 2 else "")
          + f", payload {service.cfg.payload}"
          + (", fastpath" if service.cfg.fastpath else "")
          + (", pipelined" if service.cfg.pipeline else "")
          + (f", async (alpha={service.cfg.staleness_alpha:g}, band={service.cfg.stale_rounds})"
             if service.cfg.async_mode else "")
          + (f", on rank 0 of {distributed.world_size()}" if service.group is not None else "")
          + (f", buffer {service.cfg.buffer_size}/" if service.cfg.async_mode
             else f", quorum {service.cfg.quorum}/")
          + f"{session.num_workers}, deadline {service.cfg.deadline_s}s, trace {trace}"
          + (f", metrics http://{maddr[0]}:{maddr[1]}/metrics" if maddr else ""), flush=True)
    return service
