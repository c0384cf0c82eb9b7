"""Joining the ranks of a sharded run: the PyTorch twin of the JAX
package's ``parallel/distributed.py``.

The JAX package runs one controller process per host, which drives every
device of that host; ``jax.distributed.initialize`` joins the hosts. The
port runs one process per card (a rank), and ``torch.distributed``'s
process group joins them. A rank learns its place from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or from the reference's explicit cluster flags
(``--coordinator_address host:port --num_processes N --process_id I``).

- ``initialize`` joins the group, under bounded retries (site
  ``dist_init``, where a ``FaultPlan`` injects its failures): the backend
  is NCCL for a CUDA device and gloo for the CPU, chosen from the device
  and never switched after a failure. A rank on the card takes
  ``cuda:LOCAL_RANK``. Auto mode (no flag) joins only when ``detected``,
  and degrades to a single process with a warning when the join fails, as
  the reference's auto mode does; a forced join propagates its failure.
- ``all_hosts_max`` is the agreement behind coordinated preemption: an
  ``all_reduce(MAX)`` of one int over a gloo group on the host, so it
  never waits on the card's queued work. A single process returns the
  value and touches no collective.
- ``all_gather_stacked`` gathers per-rank tensors into [S, ...] stacks in
  rank order with one ``all_gather`` of their bytes: copies, so a stack is
  bitwise what each rank held (over gloo a CUDA tensor is staged through
  host memory, which is how that backend moves card memory).
- ``broadcast_from_root`` gives every rank rank 0's tensors with one
  ``broadcast`` of their bytes: how a served group's rank 0, which runs
  the aggregation service, shares each round's close.
- ``serve_group`` is the process group of the serve cycle's collectives
  (the payload client step's gather, the close's broadcast, the pipelined
  worker's go/stop flag): a served run may issue them from its pipeline
  worker while the main thread issues the round's own, and two threads on
  one group could pair one rank's broadcast with another's all-to-all.
  Every rank makes it at the join, in the same order.
- ``RowMoves`` moves the split client state's rows between their owners
  and the ranks that run their cohort slots, and back, with one
  ``all_to_all_single`` each way (gloo and NCCL both have it);
  ``gather_rows`` collects the blocks on rank 0 for a checkpoint.
- ``join_mesh`` makes the process groups of the mesh's axes once the
  mesh is known: every rank makes every group, in one order (the client
  axis's groups, then the seq groups, then the model groups), and keeps
  its own. ``axis_group`` returns this rank's group of an axis and
  ``parallel_axes`` the ``seq`` and ``model`` axes a model computes over
  (``collectives.ParallelAxes``). A mesh without seq or model ranks makes
  none: its client axis is the whole job. A mesh with them also gets the
  serve cycle's own group on each axis, made after the others in the
  same order and with the serve group's timeout: ``serve_axis_group`` and
  ``serve_parallel_axes`` are what a served client step gathers and
  computes over, on the pipeline's worker when pipelined, so that none of
  its collectives can pair with one of the main thread's (the round's
  merge, the eval, the F1 decode), which stay on the groups above. The
  whole job's ``serve_group`` still carries the close's broadcast and the
  go/stop flag: every rank keeps the whole flat state.
- ``launch_local`` starts N ranks of a function on this host, with the
  environment torchrun would give them.
"""

from __future__ import annotations

import datetime
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

# the host-side group of all_hosts_max: the default group under gloo, a
# gloo group of its own beside an NCCL default group
_HOST_GROUP = None
# the serve cycle's own group (serve_group), beside the default group
_SERVE_GROUP = None
# the mesh join_mesh made groups for, this rank's process group along each
# of its axes, and the gloo group of its client axis on the host
# (gather_rows), when the mesh has seq or model ranks
_MESH = None
_AXIS_GROUPS: dict = {}
_CLIENT_HOST_GROUP = None
# this rank's serve cycle group along each axis of the joined mesh (when it
# has seq or model ranks), and how much longer than TIMEOUT_S the serve
# cycle's groups wait
_SERVE_AXIS_GROUPS: dict = {}
_SERVE_EXTRA_S = 0.0
# how long a rank waits for the others in the join and in a collective
TIMEOUT_S = 600.0


def detected() -> bool:
    """Whether the environment is one rank of a multi-rank launch:
    torchrun's ``RANK`` and ``MASTER_ADDR`` with a ``WORLD_SIZE`` of 2 or
    more. A world of one is a single process, where joining a group is
    pointless."""
    try:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    except ValueError:
        return False
    return world >= 2 and "RANK" in os.environ and bool(os.environ.get("MASTER_ADDR"))


def is_joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the job (1 when no group was joined)."""
    return dist.get_world_size() if is_joined() else 1


def rank() -> int:
    """This process's rank (0 when no group was joined)."""
    return dist.get_rank() if is_joined() else 0


def local_rank() -> int:
    """This rank's card on its host: ``LOCAL_RANK`` when the launcher set
    it (torchrun does), else the rank modulo the cards the host shows."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank() % max(n, 1)


def backend_for(device: str | torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device: str | torch.device) -> torch.device:
    """The device a rank runs on: ``cuda:LOCAL_RANK`` for a CUDA request
    inside a group, else the request as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_joined():
        return torch.device("cuda", local_rank())
    return dev


def initialize(force: bool = False, fault_plan=None, retry_policy=None,
               device: str | torch.device = "cuda", backend: str | None = None,
               coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, serve_deadline_s: float = 0.0) -> bool:
    """Join the job's process group (idempotent). Returns True if this
    process is (now) in a group.

    - auto mode (force=False): join only when ``detected()``; a failed
      join warns and runs as a single process, which must never kill a job
      that would have run fine alone.
    - force=True: join and propagate any failure. ``coordinator_address``
      (host:port of rank 0), ``num_processes`` and ``process_id`` name the
      cluster where no launcher's environment does; missing ones are read
      from it.

    ``backend`` defaults to ``backend_for(device)``; gloo on a CUDA device
    is the caller's explicit choice (several ranks sharing one card, which
    NCCL refuses). The join runs under bounded retries at the site
    "dist_init": the common failure is rank 0 not listening yet. The serve
    group waits ``serve_deadline_s`` longer than the others: the other
    ranks sit in its broadcast while rank 0's wall-clock close waits up to
    the served round's deadline."""
    global _HOST_GROUP, _SERVE_GROUP, _SERVE_EXTRA_S
    if is_joined():
        return True
    if not (force or detected()):
        return False
    from ..resilience import retry as rtry

    backend = backend or backend_for(device)
    env = os.environ
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "0") or 0)
    rnk = process_id if process_id is not None else int(env.get("RANK", "-1") or -1)
    if coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    elif env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = "env://"
    else:
        init_method = None
    if init_method is None or world < 1 or not 0 <= rnk < world:
        msg = ("cannot join a process group: need --coordinator_address, --num_processes and "
               "--process_id, or torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK "
               f"(have address={coordinator_address or env.get('MASTER_ADDR')!r}, "
               f"num_processes={world or None}, process_id={rnk if rnk >= 0 else None})")
        if force:
            raise ValueError(msg)
        print(f"warning: {msg}; running as a single process", file=sys.stderr, flush=True)
        return False

    def join():
        if fault_plan is not None:
            fault_plan.fire_transient("dist_init")
        try:
            dist.init_process_group(backend, init_method=init_method, world_size=world,
                                    rank=rnk, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        except Exception:
            # a half-made group would make every retry fail on "already
            # initialized" and hide the real connection error
            if dist.is_initialized():
                dist.destroy_process_group()
            raise

    try:
        rtry.with_retries(join, site="dist_init", policy=retry_policy)
    except Exception as e:  # noqa: BLE001 — auto mode degrades, forced raises
        if force:
            raise
        print(f"warning: auto-join failed ({type(e).__name__}: {e}); running as a single "
              "process", file=sys.stderr, flush=True)
        return False
    # the preemption agreement is host data: a gloo group keeps it off the
    # card's stream (every rank makes it, in the same order)
    _HOST_GROUP = None if backend == "gloo" else dist.new_group(backend="gloo")
    _SERVE_EXTRA_S = float(serve_deadline_s)
    _SERVE_GROUP = dist.new_group(
        backend=backend, timeout=datetime.timedelta(seconds=TIMEOUT_S + serve_deadline_s))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank())
    return True


def shutdown() -> None:
    """Leave the process group (and the groups beside it), if joined."""
    global _HOST_GROUP, _SERVE_GROUP, _CLIENT_HOST_GROUP, _MESH, _SERVE_EXTRA_S
    if is_joined():
        dist.destroy_process_group()
    _HOST_GROUP = _SERVE_GROUP = _CLIENT_HOST_GROUP = _MESH = None
    _SERVE_EXTRA_S = 0.0
    _AXIS_GROUPS.clear()
    _SERVE_AXIS_GROUPS.clear()


def join_mesh(mesh) -> None:
    """Make the process groups of ``mesh``'s axes (a collective: every rank
    of the job calls it, with the same mesh). Each rank keeps its group on
    the client axis (the ranks of its (seq, model) coordinate: the sharded
    round's merge), on the seq axis and on the model axis, and a gloo
    group of its client axis on the host. A mesh without seq or model
    ranks makes none. Then, in the same order, the serve cycle's groups
    of the three axes (``serve_axis_group``), which wait as long as the
    serve group does. Idempotent for one mesh."""
    global _CLIENT_HOST_GROUP, _MESH
    if mesh is None or mesh == _MESH:
        return
    if mesh.seq * mesh.model == 1:
        # an earlier mesh's axes must not outlive it in this process
        _MESH = _CLIENT_HOST_GROUP = None
        _AXIS_GROUPS.clear()
        _SERVE_AXIS_GROUPS.clear()
        return
    if world_size() != mesh.ranks:
        raise ValueError(f"the mesh {mesh.shape} needs {mesh.ranks} ranks; this job has "
                         f"{world_size()}")
    me = rank()
    for axis in ("clients", "seq", "model"):
        for ranks in mesh.axis_ranks(axis):
            g = dist.new_group(ranks)
            if me in ranks:
                _AXIS_GROUPS[axis] = g
    for ranks in mesh.axis_ranks("clients"):
        g = dist.new_group(ranks, backend="gloo")
        if me in ranks:
            _CLIENT_HOST_GROUP = g
    serve_timeout = datetime.timedelta(seconds=TIMEOUT_S + _SERVE_EXTRA_S)
    for axis in ("clients", "seq", "model"):
        for ranks in mesh.axis_ranks(axis):
            g = dist.new_group(ranks, timeout=serve_timeout)
            if me in ranks:
                _SERVE_AXIS_GROUPS[axis] = g
    _MESH = mesh


def axis_group(axis: str):
    """This rank's process group along ``axis`` of the joined mesh, or None
    when ``join_mesh`` made none (no seq or model ranks)."""
    return _AXIS_GROUPS.get(axis)


def _axes_of(groups: dict):
    from .collectives import Axis, ParallelAxes

    if _MESH is None:
        return None
    c = _MESH.coords(rank())
    return ParallelAxes(**{a: Axis(groups[a], getattr(_MESH, a), c[a])
                           for a in ("seq", "model") if getattr(_MESH, a) > 1})


def parallel_axes():
    """The ``seq`` and ``model`` axes of the joined mesh as this rank sees
    them (``collectives.ParallelAxes``), an axis of size 1 None; None when
    the mesh has neither."""
    return _axes_of(_AXIS_GROUPS)


def serve_group():
    """The group of the serve cycle's collectives over the whole job (the
    close's broadcast, the pipeline's go/stop flag; None when no group was
    joined)."""
    return _SERVE_GROUP


def serve_axis_group(axis: str):
    """This rank's serve cycle group along ``axis`` of the joined mesh (a
    served client step's gather on "clients"), or None when ``join_mesh``
    made none: then the client axis is the whole job (``serve_group``)."""
    return _SERVE_AXIS_GROUPS.get(axis)


def serve_parallel_axes():
    """``parallel_axes`` on the serve cycle's groups: the axes a served
    client step's model computes over (None when the mesh has no seq or
    model ranks)."""
    return _axes_of(_SERVE_AXIS_GROUPS)


def initialize_from_args(args, fault_plan=None, retry_policy=None) -> bool:
    """CLI adapter: explicit cluster flags force the join (a user who typed
    a coordinator address wants a cluster; training alone on each node
    would be the worst outcome)."""
    cluster_kw = {k: v for k, v in (("coordinator_address", args.coordinator_address),
                                    ("num_processes", args.num_processes),
                                    ("process_id", args.process_id)) if v is not None}
    return initialize(force=args.multihost or bool(cluster_kw), fault_plan=fault_plan,
                      retry_policy=retry_policy, device=args.device,
                      serve_deadline_s=args.serve_deadline if args.serve != "off" else 0.0,
                      **cluster_kw)


def join_cli(args, fault_plan=None) -> bool:
    """The CLIs' start: join the job's process group before any work (a
    torchrun launch of 2+ ranks, or the explicit cluster flags) and print
    the reference's ``multihost:`` line; then leave the run's files to rank
    0: on rank r > 0 the rows (``--log_jsonl``), the trace and the profiler
    capture are off, and the ledger goes to PATH.rank<r>. With ``--serve``
    rank 0 alone runs the aggregation service (its socket and metrics
    ports); the other ranks follow it (``serve.service.ServeFollower``)."""
    from ..resilience.retry import RetryPolicy
    from ..utils.device import make_reproducible

    if torch.device(args.device).type == "cuda":
        make_reproducible()  # before any CUDA work of the run
    joined = initialize_from_args(args, fault_plan=fault_plan,
                                  retry_policy=RetryPolicy(max_retries=args.max_retries))
    if joined:
        print(f"multihost: {process_info()}", flush=True)
    r = rank()
    if r:
        args.log_jsonl = args.trace = args.trace_events = ""
        args.profile_rounds = args.profile_dir = ""
        if args.ledger:
            args.ledger = f"{args.ledger}.rank{r}"
    return joined


def cli_mesh(args):
    """The CLIs' client mesh (``mesh.mesh_from_args`` over this job's
    ranks), printed as the reference's ``mesh:`` line."""
    from . import mesh as meshlib

    mesh = meshlib.mesh_from_args(args, world_size())
    if mesh is not None:
        join_mesh(mesh)
        print(f"mesh: {mesh_info(mesh)}", flush=True)
    return mesh


def all_hosts_max(value: int) -> int:
    """The max of a small host-local int over every rank: one int64
    ``all_reduce(MAX)`` on the host. A single process returns the value
    unchanged without touching any collective."""
    if world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return int(t[0])


def all_gather_stacked(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """Every rank's ``tensors``, each stacked to [S, *shape] in rank order,
    on the device they came from: one ``all_gather`` of their bytes
    (packed in list order), so each stack holds exactly the bits each rank
    gave. Every rank passes tensors of the same shapes and dtypes. Over
    gloo a CUDA buffer is staged through host memory."""
    S = dist.get_world_size(group)
    dev = tensors[0].device
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat(flat)
    staged = dev.type == "cuda" and dist.get_backend(group) == "gloo"
    if staged:
        buf = buf.cpu()
    parts = [torch.empty_like(buf) for _ in range(S)]
    dist.all_gather(parts, buf, group=group)
    gathered = torch.stack(parts)
    if staged:
        gathered = gathered.to(dev)
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        out.append(gathered[:, off:off + n].contiguous().view(t.dtype)
                   .reshape((S,) + tuple(t.shape)))
        off += n
    return out


# the broadcasts ``broadcast_from_root`` made in this process since the
# count was last set to 0: calls, bytes of each call's buffer, and the host
# ms from the call to its return
broadcast_stats = {"calls": 0, "bytes": 0, "ms": 0.0}


def broadcast_from_root(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """Rank 0's ``tensors`` on every rank, on the device each came from:
    one ``broadcast`` of their bytes (packed in list order), so every rank
    gets rank 0's exact bits. The other ranks pass tensors of the same
    shapes and dtypes, whose values are not read. Over gloo a CUDA buffer
    is staged through host memory, and over NCCL a host buffer through the
    card. A failed broadcast raises."""
    dev = tensors[0].device
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat(flat)
    backend = dist.get_backend(group)
    if backend == "gloo" and dev.type == "cuda":
        buf = buf.cpu()
    elif backend == "nccl" and dev.type != "cuda":
        buf = buf.to(torch.device("cuda", torch.cuda.current_device()))
    t0 = time.perf_counter()
    # src is a rank of the default group: the groups here span every rank
    dist.broadcast(buf, src=0, group=group)
    broadcast_stats["calls"] += 1
    broadcast_stats["bytes"] += buf.numel()
    broadcast_stats["ms"] += (time.perf_counter() - t0) * 1e3
    buf = buf.to(dev)
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        part = buf[off:off + n]
        if off % t.element_size():
            part = part.clone()  # a dtype view needs an aligned offset
        out.append(part.view(t.dtype).reshape(t.shape))
        off += n
    return out


# cross-rank bytes of the split client state's row moves (``RowMoves``)
# this process sent and received since the count was last set to 0: what
# ``mesh.client_row_bytes`` predicts for each rank
row_move_bytes = {"sent": 0, "received": 0}


class RowMoves:
    """One round's moves of the split client state's rows over a group of S
    ranks: rank s owns rows [s * B, (s + 1) * B) of the padded
    [num_clients, d] state (``rows_per_rank`` B) and runs cohort slots
    [s * W / S, (s + 1) * W / S). ``fetch`` brings each slot's rows from
    their owner to the rank that runs the slot; ``give_back`` sends the new
    rows back to their owners, which write them out of place. Each is one
    ``all_to_all_single`` of the rows packed by destination rank, slot order
    inside, all keys side by side ([n, K * d]): copies, so every row arrives
    bitwise. Every rank builds the same plan from the same cohort ids, which
    are host data, so planning syncs nothing. Over gloo a CUDA buffer is
    staged through host memory."""

    def __init__(self, ids, rows_per_rank: int, group=None):
        S, r = dist.get_world_size(group), dist.get_rank(group)
        ids = np.asarray(ids, np.int64)
        W = len(ids)
        if W % S:
            raise ValueError(f"cohort of {W} does not split over {S} ranks")
        owner, runner = ids // rows_per_rank, np.arange(W) // (W // S)
        # slots whose rows this rank owns, by the rank that runs them; and
        # the slots this rank runs, by the rank that owns their rows
        out = [np.flatnonzero((owner == r) & (runner == q)) for q in range(S)]
        into = [np.flatnonzero((runner == r) & (owner == p)) for p in range(S)]
        self.group, self.rank = group, r
        self.out_counts = [len(x) for x in out]
        self.in_counts = [len(x) for x in into]
        out_slots, in_slots = np.concatenate(out), np.concatenate(into)
        self._local = torch.from_numpy(ids[out_slots] - r * rows_per_rank)
        # the received rows in slot order, and this rank's slots in send order
        self._to_slots = torch.from_numpy(np.argsort(in_slots, kind="stable"))
        self._from_slots = torch.from_numpy(in_slots - r * (W // S))

    def _exchange(self, send: torch.Tensor, recv_counts: list, send_counts: list) -> torch.Tensor:
        dev = send.device
        staged = dev.type == "cuda" and dist.get_backend(self.group) == "gloo"
        buf = send.cpu() if staged else send.contiguous()
        out = torch.empty((sum(recv_counts),) + tuple(send.shape[1:]), dtype=send.dtype,
                          device=buf.device)
        dist.all_to_all_single(out, buf, recv_counts, send_counts, group=self.group)
        width = send.shape[1] * send.element_size()
        row_move_bytes["sent"] += width * sum(n for q, n in enumerate(send_counts)
                                              if q != self.rank)
        row_move_bytes["received"] += width * sum(n for p, n in enumerate(recv_counts)
                                                  if p != self.rank)
        return out.to(dev) if staged else out

    def fetch(self, block: dict) -> dict:
        """{key: [W / S, d]}: the rows of this rank's slots, in slot order,
        from this rank's ``block`` ({key: [B, d]}) and the other ranks'."""
        keys = sorted(block)
        dev = block[keys[0]].device
        send = torch.cat([block[k].index_select(0, self._local.to(dev)) for k in keys], 1)
        rows = self._exchange(send, self.in_counts, self.out_counts)
        rows = rows.index_select(0, self._to_slots.to(dev))
        return dict(zip(keys, (c.contiguous() for c in rows.chunk(len(keys), 1))))

    def give_back(self, block: dict, new_rows: dict) -> dict:
        """This rank's new block: ``block`` with the new rows of the slots it
        owns written in, out of place (``block`` stays as it was)."""
        keys = sorted(block)
        dev = block[keys[0]].device
        send = torch.cat([new_rows[k] for k in keys], 1).index_select(
            0, self._from_slots.to(dev))
        rows = self._exchange(send, self.out_counts, self.in_counts)
        local = self._local.to(dev)
        return {k: block[k].index_copy(0, local, c)
                for k, c in zip(keys, rows.chunk(len(keys), 1))}


def gather_rows(blocks: dict, num_rows: int) -> dict | None:
    """The whole client state on rank 0: every rank's host ``blocks``
    ({key: [B, d]}, shard s's rows [s * B, (s + 1) * B) of the padded
    state), gathered over the host group of the client axis in shard order
    with the pad rows cut, {key: [num_rows, d]}; None on every other rank
    (on a mesh with seq or model ranks each client axis gathers to its
    first rank, and only rank 0 keeps the rows: the others' are the same).
    A collective: every rank calls it, in the same order."""
    group = _CLIENT_HOST_GROUP or _HOST_GROUP
    S, r = dist.get_world_size(group), dist.get_rank(group)
    out = {}
    for k in sorted(blocks):
        t = blocks[k].contiguous()
        parts = [torch.empty_like(t) for _ in range(S)] if r == 0 else None
        dist.gather(t, parts, dst=dist.get_global_rank(group, 0) if group is not None else 0,
                    group=group)
        if r == 0:
            B = t.shape[0]
            out[k] = torch.cat([p[:max(0, min(B, num_rows - s * B))]
                                for s, p in enumerate(parts)])
    return out if rank() == 0 else None


def mesh_info(mesh) -> dict:
    """The mesh for the start-up line: its axes, how many ways the cohort
    splits, and whether the merge crosses slices (hosts), the reference's
    keys."""
    from . import mesh as meshlib

    return {"axes": mesh.shape, "client_shards": meshlib.client_shards(mesh),
            "merge_crosses_dcn": mesh.slices > 1}


def process_info() -> dict:
    """This rank's place for the start-up line, under the reference's keys
    (a rank drives one device), and the backend."""
    return {"process_index": rank(), "process_count": world_size(), "local_devices": 1,
            "global_devices": world_size(),
            "backend": dist.get_backend() if is_joined() else None}


def free_port() -> int:
    """A TCP port free now on every address of this host (for a group's
    rendezvous, whose store listens on all of them: a port free on
    127.0.0.1 alone may be held on another loopback address, by a closed
    connection's TIME_WAIT)."""
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def reserve_port():
    """A socket holding a port free on every address (``free_port``) until
    it is closed: bound with SO_REUSEADDR and never listening, so the
    rendezvous store can still bind and listen on the port (it sets
    SO_REUSEADDR too), while no other socket's bind to port 0 and no
    outgoing connection can take it meanwhile, as they could between
    ``free_port`` and the store's bind."""
    import socket

    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("", 0))
    return s


def _launched(fn, args, env: dict):
    os.environ.update(env)
    fn(*args)


def launch_local(fn, world: int, args: tuple = (), env: dict | None = None,
                 timeout_s: float = 900.0) -> list[int | None]:
    """Run ``fn(*args)`` in ``world`` fresh processes on this host (the
    "spawn" start method of ``torch.multiprocessing``), rank r with
    torchrun's environment for a job of ``world`` ranks on a free localhost
    port, plus ``env``. ``fn`` joins the
    group itself (``initialize``). Returns the exit codes in rank order;
    once one rank fails, the others are given 30 s before they are killed
    (a rank waiting in a collective for a dead peer would wait out the
    group's timeout), and a rank still running at ``timeout_s`` is killed
    (its code is then the kill's)."""
    import torch.multiprocessing as mp

    reserved = reserve_port()
    port = reserved.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = []
    for r in range(world):
        renv = {"RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
                "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), **(env or {})}
        p = ctx.Process(target=_launched, args=(fn, args, renv), daemon=False)
        p.start()
        procs.append(p)
    deadline = time.monotonic() + timeout_s
    failed_at = None
    while any(p.is_alive() for p in procs):
        now = time.monotonic()
        if failed_at is None and any(p.exitcode not in (None, 0, 75) for p in procs):
            failed_at = now
        if now > deadline or (failed_at is not None and now > failed_at + 30.0):
            for p in procs:
                if p.is_alive():
                    p.kill()
        time.sleep(0.05)
    for p in procs:
        p.join()
    reserved.close()
    return [p.exitcode for p in procs]
