"""The mesh of the port's sharded runs: the PyTorch twin of the JAX
package's ``parallel/mesh.py``, for one rank per card.

In the JAX package a mesh is a grid of devices driven by one program and
the sampled-client axis is sharded over it. In the port a rank is one
process with one card, joined to the others by ``torch.distributed``
(``parallel/distributed.py``), so the mesh is only its shape, outermost
first: ``slices`` x ``clients`` x ``seq`` x ``model``, the reference's axis
order. A rank's coordinates are row-major over those four axes, with
``model`` innermost. The cohort splits over the ``shards`` = slices x
clients coordinates: shard s is the contiguous slice ``[s * W / S, (s + 1)
* W / S)``, and every rank of one (slices, clients) coordinate holds the
same shard, which its ``seq`` ranks split by token block (ring attention)
and its ``model`` ranks by heads, hidden units and experts (tensor
parallelism, ``parallel/tp.py``). The batch of a shard is a slice of the
cohort's batch, not a device placement, so the reference's sharding
helpers (``client_sharding``, ``replicated``, ``shard_client_batch``)
have no counterpart here.
"""

from __future__ import annotations

import dataclasses

DCN_AXIS = "slices"  # ranks on other hosts or slices
CLIENT_AXIS = "clients"  # ranks inside a slice
SEQ_AXIS = "seq"  # sequence-parallel ranks (ring attention)
MODEL_AXIS = "model"  # tensor-parallel ranks (the GPT-2 path)
AXES = (DCN_AXIS, CLIENT_AXIS, SEQ_AXIS, MODEL_AXIS)  # outermost first


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """``slices`` x ``clients`` x ``seq`` x ``model`` ranks, one card
    each; the ``shards`` = slices x clients coordinates split the sampled
    cohort."""

    clients: int
    slices: int = 1
    seq: int = 1
    model: int = 1

    def __post_init__(self):
        for axis in AXES:
            size = getattr(self, axis)
            if not isinstance(size, int) or size <= 0:
                raise ValueError(f"the client mesh's {axis} must be a positive int, got {size!r}")

    @property
    def shards(self) -> int:
        return self.clients * self.slices

    @property
    def ranks(self) -> int:
        """The job's ranks: shards x seq x model."""
        return self.shards * self.seq * self.model

    @property
    def shape(self) -> dict:
        """The axes and their sizes, outermost first; an axis of size 1 is
        left out (but ``clients``), as the reference's ``make_mesh`` leaves
        it out."""
        return {a: getattr(self, a) for a in AXES
                if a == CLIENT_AXIS or getattr(self, a) > 1}

    def coords(self, rank: int) -> dict:
        """Rank ``rank``'s coordinate on each axis: row-major over (slices,
        clients, seq, model), model innermost."""
        if not 0 <= rank < self.ranks:
            raise ValueError(f"rank {rank} is outside the {self.ranks}-rank mesh")
        out = {}
        for axis in reversed(AXES):
            rank, out[axis] = divmod(rank, getattr(self, axis))
        return out

    def axis_ranks(self, axis: str) -> list[list[int]]:
        """The groups of ranks along ``axis`` ("clients" takes the slices
        too: the cohort's shards), each in rank order, every rank in one
        group; the groups in the order of the first rank of each."""
        along = (DCN_AXIS, CLIENT_AXIS) if axis == CLIENT_AXIS else (axis,)
        groups: dict = {}
        for r in range(self.ranks):
            c = self.coords(r)
            key = tuple(v for a, v in c.items() if a not in along)
            groups.setdefault(key, []).append(r)
        return sorted(groups.values())

    def shard_index(self, rank: int) -> int:
        """The cohort shard rank ``rank`` holds: its (slices, clients)
        coordinate, row-major."""
        c = self.coords(rank)
        return c[DCN_AXIS] * self.clients + c[CLIENT_AXIS]


def client_shards(mesh: ClientMesh) -> int:
    """Total ways the cohort splits (must divide num_workers)."""
    return mesh.shards


def parse_mesh_spec(spec: str) -> dict:
    """Parse the CLI's ``--mesh clients=N[,slices=M]`` into {"clients": N,
    "slices": M} (slices defaults to 1), with the reference's loud errors:
    a typo'd axis silently training on one card is the failure the flag
    exists to prevent."""
    out = {"clients": 0, "slices": 1}
    seen: set[str] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad --mesh entry {part!r}: expected axis=size "
                "(e.g. clients=8 or clients=4,slices=2)"
            )
        axis, _, size = part.partition("=")
        axis = axis.strip()
        if axis not in ("clients", "slices"):
            raise ValueError(
                f"unknown --mesh axis {axis!r}: the round shards over "
                "'clients' (ICI) and 'slices' (DCN); model/seq parallelism "
                "keep their dedicated flags"
            )
        if axis in seen:
            # a duplicate is almost always a typo for the other axis
            raise ValueError(f"--mesh sets axis {axis!r} twice: {spec!r}")
        seen.add(axis)
        try:
            out[axis] = int(size)
        except ValueError:
            raise ValueError(f"bad --mesh size {size!r} for axis {axis!r}")
        if out[axis] <= 0:
            raise ValueError(f"--mesh {axis} must be positive, got {out[axis]}")
    if out["clients"] <= 0:
        raise ValueError("--mesh must set clients=N (e.g. clients=8)")
    return out


def mesh_from_spec(spec: str, world_size: int, model_parallel: int = 1,
                   seq_parallel: int = 1) -> ClientMesh:
    """The mesh a ``--mesh`` spec asks for, times ``seq_parallel`` x
    ``model_parallel``, in a job of ``world_size`` ranks (one card each).
    A spec that needs another number of ranks raises, as the reference's
    ``make_mesh_from_spec`` raises when the host shows too few devices: an
    operator who typed a topology wants that topology or a loud failure."""
    sizes = parse_mesh_spec(spec)
    mesh = ClientMesh(clients=sizes["clients"], slices=sizes["slices"], seq=seq_parallel,
                      model=model_parallel)
    if mesh.ranks != world_size:
        raise ValueError(
            f"--mesh {spec!r} (x model_parallel={model_parallel} x seq_parallel="
            f"{seq_parallel}) needs {mesh.ranks} ranks (one card each); this job has "
            f"{world_size} (launch one rank per card: torchrun --nproc_per_node, or "
            "--multihost --coordinator_address --num_processes --process_id)")
    return mesh


def merge_comm_bytes(n_shards: int, r: int, c: int, d: int) -> dict:
    """Analytic per-round cross-rank traffic of the sharded round's merge,
    per rank: the sketch-table merge (what the round ships) against the
    dense [d] all-reduce a gradient-synchronous data-parallel round would
    ship.

    allgather = (S-1) tables received per rank (the ordered merge the round
    uses); psum = 2(S-1)/S tables (the ring all-reduce's lower bound, for
    comparison); dense_allreduce = the same ring bound on [d] floats."""
    table = r * c * 4
    dense = d * 4
    s = max(n_shards, 1)
    ring = 2 * (s - 1) / s
    return {
        "sketch_table_mb": table / 1e6,
        "sketch_allgather_mb_per_device": (s - 1) * table / 1e6,
        "sketch_psum_mb_per_device": ring * table / 1e6,
        "dense_allreduce_mb_per_device": ring * dense / 1e6,
        "dense_over_sketch_ratio": d / (r * c),
    }


def client_row_bytes(ids, num_clients: int, n_shards: int, d: int, n_keys: int,
                     itemsize: int = 4) -> dict:
    """Per-round bytes of the split client state's row moves
    (``distributed.RowMoves``) for the cohort ``ids`` on S = ``n_shards``
    ranks: shard s owns rows [s * B, (s + 1) * B), B = ceil(num_clients /
    S), and runs cohort slots [s * W / S, (s + 1) * W / S). Each slot's
    ``n_keys`` rows of d floats are brought from their owner to the rank
    that runs the slot, and the new rows go back the same way.

    rows: the W slot rows each way; crossing: those whose owner is not the
    rank that runs them, which are all that cross between ranks;
    row_bytes: one slot's rows; bytes_each_way: crossing x row_bytes;
    sent_per_rank / received_per_rank: the cross-rank bytes each rank
    sends and receives in one direction (the other direction swaps them),
    what ``distributed.row_move_bytes`` counts."""
    import numpy as np

    ids = np.asarray(ids, np.int64)
    W, S = len(ids), max(n_shards, 1)
    owner = ids // -(-num_clients // S)
    runner = np.arange(W) // (W // S)
    cross = owner != runner
    row = n_keys * d * itemsize
    return {
        "rows": W,
        "crossing": int(cross.sum()),
        "row_bytes": row,
        "bytes_each_way": int(cross.sum()) * row,
        "sent_per_rank": [int((cross & (owner == s)).sum()) * row for s in range(S)],
        "received_per_rank": [int((cross & (runner == s)).sum()) * row for s in range(S)],
    }


def mesh_from_args(args, world_size: int) -> ClientMesh | None:
    """The CLIs' mesh: ``--mesh``'s, or the job's ``world_size`` ranks
    split into ``--seq_parallel`` x ``--model_parallel`` (GPT-2's flags,
    1 elsewhere) and one cohort shard per remaining coordinate (the
    reference shards over every visible device by default), or None for a
    single process. ``--num_devices`` other than 0 must equal the rank
    count: a rank is one card."""
    mp, sp = getattr(args, "model_parallel", 1), getattr(args, "seq_parallel", 1)
    if args.mesh:
        return mesh_from_spec(args.mesh, world_size, model_parallel=mp, seq_parallel=sp)
    if args.num_devices and args.num_devices != world_size:
        raise ValueError(
            f"--num_devices {args.num_devices} disagrees with this job's {world_size} rank(s): "
            "the port runs one rank per card, so launch that many ranks (or leave "
            "--num_devices at 0)")
    if world_size % (mp * sp):
        raise ValueError(
            f"{world_size} devices not divisible by num_slices=1 x seq_parallel={sp} x "
            f"model_parallel={mp}")
    if world_size == 1:
        return None
    return ClientMesh(clients=world_size // (mp * sp), seq=sp, model=mp)
