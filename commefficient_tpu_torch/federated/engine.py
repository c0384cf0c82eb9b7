"""The federated round step: the PyTorch twin of the JAX package's
``federated/engine.py`` for the single-device ravel-path round, in every
mode: FetchSGD's sketch, true_topk, local_topk, fedavg/localSGD and the
uncompressed control.

One round, given the flat [d] params (ravel_pytree order, see
``models/convert.py``):

1. every sampled client computes its update from its own batch, with its
   own train-mode batch-norm statistics: one forward/backward with weight
   decay added client-side (``gflat + wd * pflat``), or for
   fedavg/localSGD ``num_local_iters`` local SGD steps whose weight delta
   ``p0 - p_final`` is the update; local_topk then compresses each
   client's update with that client's rows of the client state;
2. the clients' updates come from one ``torch.func.vmap`` of one
   client's pure update (``make_client_updates``) over the stacked
   cohort, as the reference's ``jax.vmap``; their updates, batch-norm
   statistics and metrics are reduced to participation-weighted sums over
   the client axis (``modes.mask_rows``, then ``.sum(0)``) and normalised
   to the survivor mean. With ``client_chunk`` C > 0 the linear grad modes
   run W / C vmapped chunks whose sums are added in chunk order, so at most
   C full [d] updates are live at a time;
3. every mode but local_topk is linear and takes the shortcut:
   compressing commutes with the mean, so the reduced update is compressed
   once (``modes.client_compress``) and lifted to the aggregate wire;
4. ``modes.server_step_sparse`` runs momentum and error feedback and
   releases the delta, which ``modes.apply_delta`` subtracts.

The per-client-table round (``make_payload_round_steps``: the wire-payload
round ``wire_payloads``, a robust ``merge_policy``, the adversarial fault
kinds) has no shortcut: every client's update is sketched into its own
table, the batch's ``_adv_*`` keys may rewrite the tables, and the server
merges them by an ordered sum, or by the coordinate-wise trimmed mean or
median (``modes._robust_table_merge``).

The sharded round (``make_sharded_round_step``, ``client_shards`` S > 1):
the cohort splits into S contiguous shards; each shard runs the client
phase on its W / S clients, reduces them to one weighted sum and
compresses it (for mode=sketch, the shard's partial Count Sketch: one
``sketch_accumulate`` launch a shard). The S partial wires are stacked in
shard order and merged by one ordered sum (``modes.merge_partial_wires``),
never by an all-reduce, which would reassociate the sum; then one
replicated tail (``_merged_sharded_tail``) runs survivor normalisation,
the quarantine's rings, the non-finite guard, DP noise and the server
step. On one device the shards run in a loop (the emulation); on a
``torch.distributed`` group of S ranks each rank runs its own shard and
the partials are all-gathered, so a given S gives the same bits on one
device and on S ranks. On a group the sharded round also runs local_topk
(each client compressed against its rows of the client state, which the
session keeps split over the ranks) and fedavg/localSGD, which the
reference runs over its mesh by GSPMD; the per-client-table round runs
each rank's W / S clients and gathers their tables in slot order.

The layerwise path (``sketch_path="layerwise"``, mode=sketch only): the
client phase is the ravel path's, and the reduced [d] update (a shard's
partial sum on the sharded round) folds into the running table leaf by
leaf, each leaf's slice of the flat vector in ravel order
(``sketch/layerwise.py``; on the card one ``sketch_accumulate_tree``
launch folds the whole tree). The fold is bitwise ``sketch_vec`` of the
whole vector, so the layerwise round gives the ravel round's bits by
construction. The port keeps its flat client stacks: the vmapped backward
returns every leaf's [C, n] gradient at once, so folding per leaf lowers
no peak here.

The sketch-space quarantine (``client_update_clip``): each client's update
L2 norm (the table's, on the table round), and under layer scope each
leaf's, is screened against the running median the server state carries
(``state["quarantine"]``, a ring of ``quarantine_window`` per-round
medians); a client over the clip multiple, or not finite, leaves the round
exactly as a dropped client.

Client participation: a client takes part in a round when the batch's
validity mask (``VALID_KEY``: a dropped client, a failed data load) says
so and it survives ``client_dropout``. Every sum, normalisation,
batch-norm merge and client-row select reads that one [W] weight, so a
client that does not take part adds exact zeros, and a round where nobody
does aggregates zero (momentum still decays) and keeps its batch-norm
statistics and client rows. With ``dp_clip`` each client's update is
clipped to that L2 norm before the sum; with ``dp_noise`` the aggregate
gets central Gaussian noise scaled to the survivors (none when nobody
took part).

Observability (``obs/``): with ``health`` the step computes the
sketch-health block (``_health_metrics``) on the rounds whose batch carries
an armed ``HEALTH_KEY`` flag, a host value, and with ``ledger_fingerprint``
order-fixed fingerprints of the committed state (``_ledger_fingerprints``),
under the reserved "health/" and "ledger/" metric prefixes. Both only read
round state, so an armed round is bitwise an unarmed one. The round's
phases are spans on the tracer's ``federated`` track (``obs/trace.py``;
mirrored into an open ``torch.profiler`` capture): ``round.step`` around
every round-step closure built here (the payload pair's client and merge
steps each), ``round.client`` around the client phase (a shard's in the
sharded round; the whole client step of the payload pair), ``round.server``
around ``modes.server_step_sparse``, and the sketch leaves
``sketch.accumulate``, ``sketch.query`` and ``sketch.topk`` wherever they
run. A span reads no device value: its round is the runner's enclosing
``dispatch`` span's.

Randomness: a training forward that draws (GPT-2's dropout) reads keep
masks drawn from a ``torch.Generator`` per (round, client slot, local
step), seeded by ``dropout_seed`` from the engine's seed and those three
indices. Nothing draws under the vmap: the loss's ``dropout_masks(cbatch,
gen)`` draws each client's masks before it, in the forward's order and at
its shapes, and the stacked masks enter the map as the loss's fourth
argument, a batched input. The participation mask and the DP noise come from
generators seeded the same way under tags of their own
(``PARTICIPATION_TAG``, ``NOISE_TAG``), so no stream collides with
another. Every seed is a pure function of the round, so the async and sync
loops, and a run resumed from a checkpoint, draw the same values with no
generator state to carry. The classification losses draw nothing.
The reference draws its mask and noise from JAX's threefry keys, which
torch cannot reproduce: parity with it is distributional.

PyTorch runs eagerly, so the step is a plain function; nothing is
compiled. It makes new tensors and updates none in place, so a state once
returned is never written again (checkpoints read committed states while
later rounds run). State is a dict {"params": flat [d], "net_state": {buffer
name: tensor}, "mode_state": {"Vvelocity", "Verror"}, "round": int}; client
rows are {key: [W, d]} slices of the session's client state ({} when the
mode keeps none).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..data.fed_dataset import splitmix64
from ..models.convert import FlatLayout
from ..modes import modes
from ..modes.config import ModeConfig
from ..obs import health as obhealth
from ..obs import trace as obtrace
from ..parallel import collectives
from ..sketch import csvec, layerwise

# reserved batch key: the [W] 0/1 validity mask of the sampled clients
VALID_KEY = "_valid"
# reserved batch key: the health cadence flag, a [W] float host tensor (all
# 1.0 on a round whose health block runs, all 0.0 elsewhere). It stays on
# the host (FederatedSession copies every other key to the device), so the
# step decides from host data and no round syncs on it
HEALTH_KEY = "_health_on"
# the client-slot words of the participation mask's and the DP noise's
# seeds: far above any cohort position, so neither stream meets a
# client's dropout stream
PARTICIPATION_TAG = 0x5041525449434950
NOISE_TAG = 0x44504E4F495345


def dropout_seed(seed: int, rnd: int, slot: int, step: int) -> int:
    """The seed of the generator a client's training forward draws from:
    splitmix64 folded over (seed, round, client slot, local step), below
    2**63 (what ``torch.Generator.manual_seed`` takes)."""
    x = 0
    for word in (seed, rnd, slot, step):
        x = splitmix64(x ^ (word & ((1 << 64) - 1)))
    return x >> 1


def participation_mask(seed: int, rnd: int, num_sampled: int, dropout: float,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """[W] float32 0/1 survivor mask of round ``rnd``: each sampled client
    independently drops with probability ``dropout``. A pure function of
    (seed, round, W, dropout): drawn on the host from a CPU generator
    seeded ``dropout_seed(seed, rnd, PARTICIPATION_TAG, 0)``, so the CPU and
    the card get the same mask, and copied to a GPU from pinned memory
    without a host sync."""
    if dropout <= 0.0:
        return torch.ones(num_sampled, dtype=torch.float32, device=device)
    gen = torch.Generator().manual_seed(dropout_seed(seed, rnd, PARTICIPATION_TAG, 0))
    mask = (torch.rand(num_sampled, generator=gen) >= dropout).to(torch.float32)
    if torch.device(device).type == "cuda":
        return mask.pin_memory().to(device, non_blocking=True)
    return mask


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The subset of the reference's EngineConfig this round reads."""

    mode: ModeConfig
    weight_decay: float = 0.0  # applied to the gradient client-side
    # "skip": a round whose aggregate or new batch-norm statistics are not
    # finite aggregates to zero and keeps the previous statistics (momentum
    # decays, state stays clean); "off" lets the poison through
    on_nonfinite: str = "off"
    # the run's seed, from which every training forward's generator, the
    # participation mask and the DP noise are derived (dropout_seed)
    seed: int = 0
    # each sampled client independently drops before aggregation with this
    # probability (participation_mask)
    client_dropout: float = 0.0
    # differential privacy: dp_clip > 0 clips each client's update to that
    # L2 norm before the sum; dp_noise > 0 adds N(0, (dp_noise * sens)^2)
    # to every aggregate entry, sens = dp_clip for agg_op="sum" and
    # dp_clip / participants for the mean
    dp_clip: float = 0.0
    dp_noise: float = 0.0
    # the wire-payload round (--serve_payload sketch): every client sketches
    # its own update and the server merges the per-client tables
    # (make_payload_round_steps) instead of compressing the reduced update
    wire_payloads: bool = False
    # > 0: the linear grad modes vmap the clients in W / client_chunk chunks
    # of this many, adding the chunks' sums in chunk order, so at most this
    # many full [d] updates are live at a time (must divide W); 0: one vmap
    # of all W. fedavg/localSGD, local_topk and the payload round ignore it
    client_chunk: int = 0
    # sketch-health estimators (--health_every, obs/health.py): the step
    # computes the "health/" block on rounds whose HEALTH_KEY flag is armed.
    # mode=sketch only (the quantities are sketch-wire quantities)
    health: bool = False
    # round-ledger fingerprints (--ledger, obs/ledger.py): order-fixed
    # float reductions of the committed params and optimizer state on every
    # round, under the "ledger/" prefix
    ledger_fingerprint: bool = False
    # the sketch-space quarantine (--client_update_clip): > 0 rejects any
    # client whose update L2 norm is not finite or exceeds this multiple of
    # the running median of live client norms (state["quarantine"], seeded
    # by the first round's cohort median). A rejected client leaves the
    # merge and every renormalization exactly as a dropped one. The norms
    # are taken before the DP clip; the table round screens the table norms
    # (sketch space). 0 = off
    client_update_clip: float = 0.0
    # the quarantine baseline: 1 screens against the last non-empty round's
    # live-cohort median (state {"median"}); K > 1 keeps a [K] ring of the
    # per-round medians and screens against the median over its filled slots
    quarantine_window: int = 1
    # the table merge (--merge_policy): "sum" is the ordered sum; "trimmed"
    # drops merge_trim live contributions at each end of every table
    # coordinate before the ordered sum of the survivors; "median" is the
    # coordinate-wise median. A robust policy runs the per-client-table
    # round (uses_table_round) and needs mode=sketch; trimmed with
    # merge_trim 0 is the sum (robust_policy)
    merge_policy: str = "sum"
    merge_trim: int = 0
    # "layer" adds a per-leaf screen beside the cohort one: each leaf's
    # update L2 against that leaf's own running-median ring (the leaves are
    # layerwise.leaf_segments, the health block's segments); a client over
    # any leaf's screen is rejected
    quarantine_scope: str = "cohort"
    # with a robust policy, add lr * (winsorized mean - robust merge) into
    # Verror before the server step, so the honest mass the trim clips
    # re-enters through error feedback (modes._robust_table_merge)
    robust_residual: bool = False
    # the sharded round's shard count S (make_sharded_round_step): part of
    # the round's numerical contract, like client_chunk (it fixes the order
    # of the sum), so a given S gives the same bits on one device and on S
    # ranks; 1 = the unsharded round
    client_shards: int = 1
    # how the round's sketch table is built (mode=sketch only): "ravel"
    # sketches the reduced [d] update at once; "layerwise" folds it into
    # the running table leaf by leaf (sketch/layerwise.py; on the card one
    # sketch_accumulate_tree launch a round), bitwise the ravel round. The
    # random hash family needs num_blocks == 1 there
    sketch_path: str = "ravel"
    # the buffered-async service (--serve_async): > 0 lets the payload
    # merge take up to this many late tables, folded staleness-weighted
    # after the live cohort's ordered sum (_stale_fold), or joining the
    # robust order statistics as weighted rows under a robust policy. A
    # round with no late table runs the plain merge, which is what keeps an
    # async run where everyone is on time bitwise the sync run. 0 = off
    stale_slots: int = 0
    # the two-tier edge tree (--serve_edges, serve/scale/edge.py): >= 2 arms
    # the edge variants of the payload merge (make_payload_round_steps'
    # edge_input): the grouped flat twin, which folds the full [W, r, c]
    # stack edge by edge (modes.edge_grouped_sum), and the partials root,
    # which folds the [E, r, c] partials the edges forwarded
    # (modes.merge_edge_partials); both screen the quarantine against the
    # per-client wire norms the serving layer computed. Another float
    # association than the plain merge: an edge-armed session differs from
    # serve_edges=0 in the last bits, and its tree is bitwise its flat twin.
    # A robust policy never arms them (the tree forwards per-client tables
    # to the plain robust merge). 0 = off
    serve_edges: int = 0

    def generator(self, rnd: int, slot: int, step: int,
                  device: torch.device) -> torch.Generator:
        """The generator of client slot ``slot``'s local step ``step`` in
        round ``rnd``, on ``device``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(dropout_seed(self.seed, rnd, slot, step))
        return gen

    def __post_init__(self):
        if self.on_nonfinite not in ("off", "skip"):
            raise ValueError(f"on_nonfinite must be 'off' or 'skip', got {self.on_nonfinite!r}")
        if self.sketch_path not in ("ravel", "layerwise"):
            raise ValueError(f"sketch_path must be 'ravel' or 'layerwise', got "
                             f"{self.sketch_path!r}")
        if self.sketch_path == "layerwise":
            if self.mode.mode != "sketch":
                raise ValueError(
                    "sketch_path='layerwise' accumulates per-layer gradient blocks into the "
                    f"Count-Sketch table, so it requires mode='sketch'; mode={self.mode.mode!r} "
                    "has no table to accumulate into")
            if self.mode.hash_family == "random" and self.mode.num_blocks != 1:
                raise ValueError(
                    "sketch_path='layerwise' with hash_family='random' requires num_blocks=1: "
                    "the blocked ravel oracle sums per-block partial tables (a different fp "
                    "association than the continuous coordinate fold), which would break the "
                    "layerwise==ravel bit-parity contract. Use num_blocks=1 (layerwise "
                    "transients are O(leaf) anyway) or hash_family='rotation'.")
        if self.client_chunk < 0:
            raise ValueError(f"client_chunk must be >= 0, got {self.client_chunk}")
        if self.client_shards < 1:
            raise ValueError(f"client_shards must be >= 1, got {self.client_shards}")
        if not 0.0 <= self.client_dropout < 1.0:
            raise ValueError(f"client_dropout must be in [0, 1), got {self.client_dropout}")
        if self.client_update_clip < 0:
            raise ValueError(f"client_update_clip must be >= 0, got {self.client_update_clip}")
        if self.quarantine_window < 1:
            raise ValueError(f"quarantine_window must be >= 1, got {self.quarantine_window}")
        if self.merge_policy not in ("sum", "trimmed", "median"):
            raise ValueError(f"merge_policy must be 'sum', 'trimmed' or 'median', got "
                             f"{self.merge_policy!r}")
        if self.merge_trim < 0:
            raise ValueError(f"merge_trim must be >= 0, got {self.merge_trim}")
        if self.merge_trim > 0 and self.merge_policy != "trimmed":
            raise ValueError(f"merge_trim={self.merge_trim} names the trimmed policy's "
                             f"per-coordinate drop count; merge_policy={self.merge_policy!r} "
                             "has no use for it")
        if robust_policy(self) and self.mode.mode != "sketch":
            raise ValueError(f"merge_policy={self.merge_policy!r} is the robust TABLE merge "
                             "over per-client Count-Sketch tables, so it requires "
                             f"mode='sketch'; mode={self.mode.mode!r} has no table wire")
        if robust_policy(self) and self.sketch_path != "ravel":
            raise ValueError(
                "robust merge policies run the per-client-table round (each client's table "
                "is sketched from its flat update); sketch_path='layerwise' is a "
                "server-memory optimization of the compress-once shortcut the robust merge "
                "forfeits — use sketch_path='ravel'")
        if self.quarantine_scope not in ("cohort", "layer"):
            raise ValueError(f"quarantine_scope must be 'cohort' or 'layer', got "
                             f"{self.quarantine_scope!r}")
        if self.quarantine_scope == "layer" and self.client_update_clip <= 0:
            raise ValueError("quarantine_scope='layer' refines the --client_update_clip "
                             "screen; with the clip at 0 there is no quarantine to scope - "
                             "set client_update_clip > 0")
        if self.robust_residual and robust_policy(self) is None:
            trim0 = " with merge_trim=0" if self.merge_policy == "trimmed" else ""
            raise ValueError(
                "robust_residual is the robust merge's error-feedback repair; merge_policy="
                f"{self.merge_policy!r}{trim0} runs the plain sum, which has no residual to "
                "accumulate - arm merge_policy='trimmed' (trim > 0) or 'median', or drop "
                "the flag")
        if self.dp_clip < 0 or self.dp_noise < 0:
            raise ValueError(f"dp_clip and dp_noise must be >= 0, got {self.dp_clip} and "
                             f"{self.dp_noise}")
        if self.health and self.mode.mode != "sketch":
            raise ValueError(
                "health (--health_every) computes SKETCH-wire quality estimators — recall "
                f"proxy, table saturation, sketched Verror health; mode={self.mode.mode!r} "
                "has no table to estimate from (use mode='sketch')")
        if self.wire_payloads and self.mode.mode != "sketch":
            raise ValueError(f"wire_payloads needs mode='sketch' (per-client Count-Sketch "
                             f"tables); mode={self.mode.mode!r} has no table wire")
        if self.wire_payloads and self.sketch_path != "ravel":
            raise ValueError(
                "wire_payloads requires sketch_path='ravel': the client-side table is "
                "sketched from the client's flat gradient (the object that crosses the "
                "wire); layerwise accumulation is a server-memory optimization with no "
                "client wire to ship")
        if self.stale_slots < 0:
            raise ValueError(f"stale_slots must be >= 0, got {self.stale_slots}")
        if self.stale_slots > 0 and not self.wire_payloads:
            raise ValueError(
                "stale_slots (--serve_async) folds LATE WIRE TABLES into the payload merge; "
                "without wire_payloads there is no per-client table wire to arrive late - arm "
                "--serve_payload sketch")
        if self.serve_edges < 0:
            raise ValueError(f"serve_edges must be >= 0, got {self.serve_edges}")
        if self.serve_edges >= 2:
            if not self.wire_payloads:
                raise ValueError(
                    "serve_edges (--serve_edges) is the two-tier edge-aggregation topology "
                    "over WIRE tables; without wire_payloads there is no per-client table for "
                    "an edge to sum - arm --serve_payload sketch")
            if robust_policy(self) is not None:
                raise ValueError(
                    f"serve_edges={self.serve_edges} with merge_policy={self.merge_policy!r}: "
                    "a robust merge runs order statistics over PER-CLIENT tables, which a "
                    "pre-summed edge partial has destroyed - the serving tree forwards "
                    "per-client tables instead (set serve_edges=0 on the session; "
                    "serve/scale/edge.py runs the tree in forward mode against the plain "
                    "robust program)")
            if self.stale_slots > 0:
                raise ValueError(
                    "serve_edges does not compose with the buffered-async stale fold yet (a "
                    "stale table's edge assignment is a cross-round question the tree does "
                    "not answer) - drop --serve_async or --serve_edges")
            if self.quarantine_scope == "layer":
                raise ValueError(
                    "serve_edges with quarantine_scope='layer' is not supported: the per-leaf "
                    "median rings are root state the edges cannot screen against - use the "
                    "cohort scope (the wire-side L2 screen still runs per edge)")
        if self.dp_noise > 0 and self.dp_clip <= 0:
            raise ValueError("dp_noise > 0 requires dp_clip > 0 (unbounded sensitivity has no "
                             "meaningful noise scale)")
        if self.dp_noise > 0 and self.mode.needs_local_state:
            raise ValueError(
                "dp_noise with client-local error/momentum state is unsound: the transmitted "
                "wire is topk(error_accumulator + update), whose norm is unbounded across "
                "rounds, so dp_clip does not bound sensitivity. Use local_topk with "
                "error_type=none and momentum_type=none/virtual, or a mode without "
                "client-local state.")
        if self.dp_noise > 0 and self.mode.mode == "sketch":
            raise ValueError(
                "dp_noise with mode=sketch is unsound: a count-sketch table's worst-case L2 "
                "sensitivity under an L2 clip is l1-scale, so dp_clip-calibrated Gaussian "
                "noise on the table under-delivers the configured privacy. Use a dense-wire "
                "mode (uncompressed/true_topk/fedavg/localSGD) or local_topk without local "
                "state.")


def robust_policy(cfg: EngineConfig) -> str | None:
    """The effective robust merge policy, or None for the ordered sum:
    "trimmed" with merge_trim 0 trims nothing, so it runs the exact sum."""
    if cfg.merge_policy == "median":
        return "median"
    if cfg.merge_policy == "trimmed" and cfg.merge_trim > 0:
        return "trimmed"
    return None


def uses_table_round(cfg: EngineConfig) -> bool:
    """Whether the round needs per-client tables (make_payload_round_steps):
    a real wire (wire_payloads) or a robust merge, whose order statistics
    need the contributions the compress-once shortcut never makes."""
    return cfg.wire_payloads or robust_policy(cfg) is not None


def init_server_state(cfg: EngineConfig, pflat: torch.Tensor, net_state: dict,
                      layout: FlatLayout | None = None) -> dict:
    """The round-0 server state. With the quarantine armed it carries
    ``state["quarantine"]``: the running median (0 = no baseline yet: the
    first round screens only non-finite updates, then seeds it), with
    quarantine_window K > 1 the [K] ring of per-round medians and its fill
    count, and under layer scope the same per leaf of ``layout`` (needed
    then)."""
    if cfg.dp_noise > 0 and net_state:
        raise ValueError(
            "dp_noise with mutable model collections (e.g. BatchNorm batch_stats) is unsound: "
            "per-client statistics are averaged into the released model without clipping or "
            "noise, bypassing the DP mechanism. Use a normalization-free model for DP runs.")
    state = {
        "params": pflat,
        "net_state": net_state,
        "mode_state": modes.init_server_state(cfg.mode, pflat.device),
        "round": 0,
    }
    if cfg.client_update_clip > 0:
        dev, K = pflat.device, cfg.quarantine_window
        q = {"median": torch.zeros((), dtype=torch.float32, device=dev)}
        if K > 1:
            q["window"] = torch.zeros(K, dtype=torch.float32, device=dev)
            q["count"] = torch.zeros((), dtype=torch.int32, device=dev)
        if cfg.quarantine_scope == "layer":
            if layout is None:
                raise ValueError("quarantine_scope='layer' needs the model's layout: one "
                                 "median ring per parameter leaf")
            L = len(layerwise.leaf_segments(layout))
            q["layer_median"] = torch.zeros(L, dtype=torch.float32, device=dev)
            if K > 1:
                q["layer_window"] = torch.zeros((L, K), dtype=torch.float32, device=dev)
                q["layer_count"] = torch.zeros(L, dtype=torch.int32, device=dev)
        state["quarantine"] = q
    return state


def split_valid(batch: dict) -> tuple[dict, torch.Tensor | None]:
    """Pop the validity mask off a round batch (absent: all valid)."""
    if VALID_KEY in batch:
        batch = dict(batch)
        return batch, batch.pop(VALID_KEY)
    return batch, None


def split_health(batch: dict) -> tuple[dict, bool]:
    """Pop the health cadence flag off a round batch: (batch without it,
    whether this round's health block runs). Absent: no health. The flag
    must be host data: deciding from a device tensor would sync the host."""
    if HEALTH_KEY not in batch:
        return batch, False
    batch = dict(batch)
    flag = batch.pop(HEALTH_KEY)
    if torch.is_tensor(flag) and flag.device.type != "cpu":
        raise ValueError(f"the {HEALTH_KEY!r} cadence flag must stay on the host (got a "
                         f"{flag.device} tensor): reading it would sync the device")
    return batch, bool((flag > 0).any())


def _ledger_fingerprints(cfg: EngineConfig, new_state: dict) -> dict:
    """Order-fixed float fingerprints of the round's committed state under
    the reserved "ledger/" prefix, on every round when the ledger is armed:
    deterministic per program, so two runs of one config give equal
    sequences and the ledger's diff names the first round where they split.
    The optimizer state folds its tensors' sums of squares in sorted key
    order (the JAX package's leaf order). Reads only."""
    if not cfg.ledger_fingerprint:
        return {}
    p = new_state["params"].to(torch.float32)
    opt = torch.zeros((), dtype=torch.float32, device=p.device)
    for k in sorted(new_state["mode_state"]):
        opt = opt + torch.sum(torch.square(new_state["mode_state"][k].to(torch.float32)))
    return {"ledger/params_l2sq": torch.sum(torch.square(p)),
            "ledger/params_sum": torch.sum(p),
            "ledger/opt_state_l2sq": opt}


def _health_metrics(cfg: EngineConfig, raw_agg: dict, delta: dict, new_mode_state: dict,
                    weighted: torch.Tensor | None = None,
                    segments: tuple | None = None) -> dict:
    """The sketch-health block (obs/health.py's device half) of a round
    whose cadence flag is armed, under the reserved "health/" prefix; the
    session pops the prefix off the committed metrics before any row or
    total sees it. Every estimator reads and none writes, which (with the
    popped prefix) keeps a health-armed run bitwise an unarmed one.

    ``raw_agg`` is the PRE-guard aggregate wire (a poisoned round's block
    shows the poison the non-finite guard is about to discard);
    ``delta``/``new_mode_state`` are the server step's release and new
    Vvelocity/Verror tables; ``weighted`` (the fused round only) is the
    dense reduced update, the dense-comparable reference the recall proxy
    is validated against, sliced into per-leaf norms by ``segments``. On a
    CUDA table the naive estimate's ``unsketch_topk`` launches the
    ``sketch_query`` kernel."""
    mcfg = cfg.mode
    spec = mcfg.sketch_spec
    out: dict = {}
    table = raw_agg["table"]
    mass = obhealth.table_mass_estimate(table)
    out["grad_mass_est"] = mass
    out["grad_norm_est"] = torch.sqrt(torch.clamp(mass, min=0.0))
    out["row_mass_cv"] = obhealth.row_mass_cv(table)
    out["table_occupancy"] = obhealth.table_occupancy(table)
    # the recall proxy's bracket: the naive same-rows estimate inflates
    # under saturation, the split-row cross-estimate deflates; their
    # midpoint is the proxy and their gap its own uncertainty
    _, pvals = csvec.unsketch_topk(spec, table, mcfg.k, impl=mcfg.topk_impl)
    naive = obhealth.energy_fraction(obhealth.topk_energy(pvals), mass)
    if spec.r >= 2:
        pess = obhealth.split_topk_energy_fraction(spec, table, mcfg.k, mass)
        out["topk_mass_proxy"] = 0.5 * (naive + pess)
        out["topk_proxy_width"] = naive - pess
    else:
        out["topk_mass_proxy"] = naive
        out["topk_proxy_width"] = torch.zeros_like(naive)
    # telescoping health: the energy released this round against the
    # energy the error accumulator kept (release_frac falling while
    # verror_ratio climbs is the diverging-Verror signature)
    rel = (obhealth.topk_energy(delta["vals"]) if "vals" in delta
           else torch.zeros((), dtype=torch.float32, device=table.device))
    out["release_energy"] = rel
    vmass = obhealth.table_mass_estimate(new_mode_state["Verror"])
    out["verror_norm_est"] = torch.sqrt(torch.clamp(vmass, min=0.0))
    out["release_frac"] = obhealth.energy_fraction(rel, rel + vmass)
    out["verror_ratio"] = obhealth.energy_fraction(out["verror_norm_est"],
                                                   out["grad_norm_est"])
    if weighted is not None:
        # dense-comparable reference: the true top-k energy fraction the
        # proxy estimates, and the per-leaf norms of the reduced update
        w = weighted.to(torch.float32)
        gsq = torch.sum(torch.square(w))
        out["grad_norm_true"] = torch.sqrt(gsq)
        t_idx = csvec.topk_abs(weighted, mcfg.k, impl="exact")
        out["topk_mass_true"] = obhealth.energy_fraction(
            obhealth.topk_energy(weighted[t_idx]), gsq)
        if segments is not None:
            out["leaf_norms"] = torch.stack([torch.sqrt(torch.sum(torch.square(w[o:o + n])))
                                             for o, n in segments])
    return {f"health/{k}": v for k, v in out.items()}


def _draw_masks(loss_fn: Callable, cfg: EngineConfig, rnd: int, slots: range, step: int,
                cbatch: dict, device: torch.device) -> list | None:
    """The dropout keep masks of the clients in cohort slots ``slots`` at
    local step ``step``, drawn outside the map from each slot's generator
    ``cfg.generator(rnd, slot, step)`` by the loss's ``dropout_masks``, in
    the forward's order and at its shapes, then stacked on a leading client
    axis: what the loop of one generator per client drew, bitwise. None when
    the loss draws nothing (no ``dropout_masks``, or dropout off)."""
    draw = getattr(loss_fn, "dropout_masks", None)
    if draw is None:
        return None
    per_client = [draw({k: v[i] for k, v in cbatch.items()},
                       cfg.generator(rnd, slot, step, device))
                  for i, slot in enumerate(slots)]
    if not per_client[0]:
        return None
    return [torch.stack(site) for site in zip(*per_client)]


def make_client_updates(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout) -> Callable:
    """updates(state, cbatch, lr, slots) -> ([C, d] updates, new batch-norm
    statistics {k: [C, ...]}, metric sums {k: [C]}) of the C clients in
    cohort slots ``slots``, whose batches are stacked on the leading axis of
    ``cbatch``, before clipping and compression: one ``torch.func.vmap`` of
    one client's pure update over the C clients.

    A client's update is its gradient (``torch.func.grad`` of the loss over
    the unflattened leaves, flattened) plus weight decay, or for
    fedavg/localSGD the weight delta ``p0 - p_final`` of ``num_local_iters``
    local SGD steps at ``lr`` over the microbatches ``cbatch[key][:, i]``,
    with weight decay inside the loop, local momentum only for
    momentum_type="local", the batch-norm statistics carried from step to
    step and the metrics summed over the steps. Each forward reads the
    dropout masks of ``cfg.generator(state["round"], slot, step)``, drawn
    before the map (``_draw_masks``). Batch norm computes each client's
    statistics over that client's own batch under the map.

    A loss whose model computes over seq and model groups (its
    ``parallel``, ``collectives.ParallelAxes``) gives each rank a partial
    gradient, which is made whole before anything else reads it, inside
    the map, after every local step: first summed over the seq group in
    rank order (each rank's loss is its token block's share), then, on a
    model group, the ranks' slices of the split leaves are gathered and
    placed (``tp.TPPlan.gather_full``). Every rank of a (clients, slices)
    coordinate then holds the same bits."""
    mcfg = cfg.mode
    wd = cfg.weight_decay
    axes = getattr(loss_fn, "parallel", None)
    plan = None
    if axes is not None and axes.model is not None:
        from ..parallel.tp import TPPlan

        plan = TPPlan(layout)

    def whole(g):
        if axes is not None and axes.seq is not None:
            g = collectives.reduce_from_group(g, axes.seq)
        if plan is not None:
            g = plan.gather_full(g, axes.model)
        return g

    def grad_one(pflat, net_state, cbatch, masks):
        def loss(leaves):
            return loss_fn(leaves, net_state, cbatch, masks)

        grads, aux = torch.func.grad(loss, has_aux=True)(layout.unflatten(pflat))
        return whole(layout.flatten(grads)) + wd * pflat, aux["net_state"], aux["metrics"]

    def local_sgd_one(pflat, net_state, cbatch, masks, lr):
        mu = mcfg.momentum if mcfg.momentum_type == "local" else 0.0
        p_cur, nstate, mom, msum = pflat, net_state, torch.zeros_like(pflat), None
        for i in range(mcfg.num_local_iters):
            micro = {k: v[i] for k, v in cbatch.items()}
            g, nstate, m = grad_one(p_cur, nstate, micro, None if masks is None else masks[i])
            mom = mu * mom + g
            p_cur = p_cur - lr * mom
            msum = m if msum is None else {k: msum[k] + m[k] for k in msum}
        return pflat - p_cur, nstate, msum

    def updates(state, cbatch, lr, slots):
        pflat = state["params"]
        rnd = state["round"]
        if mcfg.uses_weight_delta:
            masks = [_draw_masks(loss_fn, cfg, rnd, slots, i,
                                 {k: v[:, i] for k, v in cbatch.items()}, pflat.device)
                     for i in range(mcfg.num_local_iters)]
            masks = None if masks[0] is None else masks
            # vmap's default randomness="error": nothing may draw under the map
            return torch.func.vmap(
                local_sgd_one, in_dims=(None, None, 0, None if masks is None else 0, None))(
                pflat, state["net_state"], cbatch, masks, lr)
        masks = _draw_masks(loss_fn, cfg, rnd, slots, 0, cbatch, pflat.device)
        return torch.func.vmap(grad_one, in_dims=(None, None, 0, None if masks is None else 0))(
            pflat, state["net_state"], cbatch, masks)

    return updates


def clip_factor(u: torch.Tensor, clip: float) -> torch.Tensor:
    """The DP clip's factor of each client's update, along the last axis
    (one client's [d] update, or a [W, d] stack: one factor per row):
    min(1, clip / max(||u||, 1e-12)), the L2 norm in float32."""
    nrm = torch.linalg.vector_norm(u.to(torch.float32), dim=-1)
    return torch.clamp(clip / torch.clamp(nrm, min=1e-12), max=1.0)


def _clip_rows(cfg: EngineConfig, updates: torch.Tensor,
               part: torch.Tensor | None = None) -> torch.Tensor:
    """The [W, d] updates, each row clipped to ``dp_clip`` in L2 (unchanged
    when the clip is off): nonlinear, so it comes before any sum. With
    ``part``, a client that does not take part keeps factor 1: its row (NaN
    behind a mask, say) is weighed to an exact zero afterwards."""
    if cfg.dp_clip <= 0:
        return updates
    fac = clip_factor(updates, cfg.dp_clip)
    if part is not None:
        fac = torch.where(part > 0, fac, torch.ones_like(fac))
    return updates * fac[:, None]


def _client_norms(updates: torch.Tensor) -> torch.Tensor:
    """[W] L2 norm of each client's flat update, in float32: the quarantine's
    observable, taken before the DP clip."""
    return torch.sqrt(torch.sum(torch.square(updates.to(torch.float32)), dim=1))


def _quarantine_mask(cfg: EngineConfig, norms: torch.Tensor, qmed: torch.Tensor) -> torch.Tensor:
    """[W] bool: the client is rejected by the quarantine. A non-finite norm
    always is; the magnitude screen arms once a running median exists
    (qmed > 0)."""
    bad = ~torch.isfinite(norms)
    return bad | ((qmed > 0) & (norms > cfg.client_update_clip * qmed))


def _masked_median(values: torch.Tensor, live: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Median over the ``live`` entries of ``values`` along the last axis
    (leading axes batch independent rings): sort with dead entries keyed
    to +inf, then take ranks (n-1)//2 and n//2 by gathering on the device.
    Undefined where n == 0: callers select past it."""
    W = values.shape[-1]
    s = torch.sort(torch.where(live, values, torch.full_like(values, float("inf"))),
                   dim=-1).values
    n = n.to(torch.int64)

    def rank(i):
        return torch.gather(s, -1, i.clamp(0, W - 1).unsqueeze(-1)).squeeze(-1)

    return 0.5 * (rank((n - 1) // 2) + rank(n // 2))


def _round_median(norms: torch.Tensor, part_eff: torch.Tensor):
    """(median, live count) of this round's live, finite client norms along
    the last axis: the per-round observation every baseline is built from."""
    live = (part_eff > 0) & torch.isfinite(norms)
    n_live = live.sum(-1)
    return _masked_median(norms, live, n_live), n_live


def _advance_quarantine(cfg: EngineConfig, qstate: dict, norms: torch.Tensor,
                        part_eff: torch.Tensor) -> dict:
    """One round's update of the quarantine state, for the rings along the
    leading axes of ``norms`` ([W]: the cohort ring; [L, W]: one per leaf).
    Window 1: {"median"}, this round's live median, or the previous one
    when nobody live was left (an empty round must not zero the threshold).
    Window K > 1: this round's median pushed into the [K] ring (an empty
    round pushes nothing) and the threshold the median over the filled
    slots, which fill from the tail."""
    med, n_live = _round_median(norms, part_eff)
    has = n_live > 0
    if cfg.quarantine_window <= 1:
        return {"median": torch.where(has, med, qstate["median"])}
    K = cfg.quarantine_window
    window = torch.where(has.unsqueeze(-1),
                         torch.cat([qstate["window"][..., 1:], med.unsqueeze(-1)], dim=-1),
                         qstate["window"])
    count = torch.where(has, torch.clamp(qstate["count"] + 1, max=K), qstate["count"])
    filled = torch.arange(K, device=window.device) >= (K - count).unsqueeze(-1)
    wmed = _masked_median(window, filled, count)
    return {"median": torch.where(count > 0, wmed, qstate["median"]), "window": window,
            "count": count}


def _client_layer_norms(updates: torch.Tensor, segments) -> torch.Tensor:
    """[W, L] L2 norm of each client's update per parameter leaf (the
    (offset, size) ``segments``), in float32. A single-leaf model's one
    column is the reduction ``_client_norms`` runs."""
    u = updates.to(torch.float32)
    return torch.stack([torch.sqrt(torch.sum(torch.square(u[:, o:o + n]), dim=1))
                        for o, n in segments], dim=1)


def _quarantine_layer_mask(cfg: EngineConfig, lnorms: torch.Tensor,
                           lmed: torch.Tensor) -> torch.Tensor:
    """[W] bool: rejected by any leaf's screen (a non-finite leaf norm, or
    one past the clip multiple of that leaf's running median, each leaf's
    screen arming once its median seeds)."""
    bad = ~torch.isfinite(lnorms)
    bad = bad | ((lmed[None, :] > 0) & (lnorms > cfg.client_update_clip * lmed[None, :]))
    return bad.any(dim=1)


def _advance_quarantine_layers(cfg: EngineConfig, qstate: dict, lnorms: torch.Tensor,
                               part_eff: torch.Tensor) -> dict:
    """One round's update of the per-leaf rings: ``_advance_quarantine`` on
    every leaf at once ([W, L] norms, rings on the leaf axis)."""
    sub = {"median": qstate["layer_median"]}
    if cfg.quarantine_window > 1:
        sub.update(window=qstate["layer_window"], count=qstate["layer_count"])
    out = _advance_quarantine(cfg, sub, lnorms.t(), part_eff)
    return {f"layer_{k}": v for k, v in out.items()}


def _advance_quarantine_full(cfg: EngineConfig, qstate: dict, norms: torch.Tensor,
                             lnorms: torch.Tensor | None, part_eff: torch.Tensor) -> dict:
    """The cohort ring and (layer scope) the per-leaf rings, one round: the
    one entry both rounds use, so the state tree cannot drift."""
    new_q = _advance_quarantine(cfg, qstate, norms, part_eff)
    if lnorms is not None:
        new_q.update(_advance_quarantine_layers(cfg, qstate, lnorms, part_eff))
    return new_q


def _weighted_sums(part: torch.Tensor, updates: torch.Tensor, stats: dict,
                   metrics: dict) -> tuple[torch.Tensor, dict, dict]:
    """Participation-weighted sums over the client axis of the stacked
    updates, statistics and metrics (``modes.mask_rows``, then ``.sum(0)``):
    a masked client's NaN contributes an exact zero."""
    return (modes.mask_rows(part, updates).sum(0),
            {k: modes.mask_rows(part, v).sum(0) for k, v in stats.items()},
            {k: modes.mask_rows(part, v).sum(0) for k, v in metrics.items()})


def _compress_rows(mcfg: ModeConfig, updates: torch.Tensor, part: torch.Tensor,
                   client_rows: dict) -> tuple[torch.Tensor, dict]:
    """local_topk: each client's update compressed with its rows of the
    client state (``modes.client_compress``), row by row in cohort order.
    Returns the densified wires [W, d] and the new rows (a client that does
    not take part keeps its rows)."""
    dense, rows = [], []
    for w in range(updates.shape[0]):
        wire, row = modes.client_compress(mcfg, updates[w],
                                          {k: v[w] for k, v in client_rows.items()})
        dense.append(csvec.to_dense(mcfg.d, wire["idx"], wire["vals"]))
        rows.append(row)
    new_rows = {k: torch.where(modes.bcast(part, v) > 0, torch.stack([r[k] for r in rows]), v)
                for k, v in client_rows.items()}
    return torch.stack(dense), new_rows


def _cohort_part(cfg: EngineConfig, state: dict, batch: dict, num_sampled: int | None = None,
                 lo: int = 0):
    """(batch without the validity mask, W, the [W] participation weight):
    the validity mask times the round's ``participation_mask``. A shard's
    batch holds cohort slots [lo, lo + W) of a cohort of ``num_sampled``:
    the mask is drawn for the whole cohort and sliced, so a client's draw
    does not depend on the shard it lands in."""
    batch, valid = split_valid(batch)
    # W: the leading dimension every leaf shares (an LM batch has no "x")
    n_clients = next(iter(batch.values())).shape[0]
    total = n_clients if num_sampled is None else num_sampled
    part = participation_mask(cfg.seed, state["round"], total, cfg.client_dropout,
                              state["params"].device)[lo:lo + n_clients]
    if valid is not None:
        part = part * valid.to(torch.float32)
    return batch, n_clients, part


def _client_reduce(updates: Callable, cfg: EngineConfig, state: dict, batch: dict,
                   part: torch.Tensor, client_rows: dict, lr, segments: tuple = (),
                   slot0: int = 0):
    """The clients of ``batch`` (cohort slots from ``slot0`` on, weighed by
    ``part``) reduced to participation-weighted sums, as the reference's
    ``_weighted_client_reduce`` does: (update sum [d], batch-norm statistic
    sums, metric sums, the effective weight [W] after the quarantine, the
    [W] norms and [W, L] layer norms the quarantine screened (None when
    off), the cohort's new client rows).

    With the quarantine armed (``client_update_clip``) each chunk's clients
    are screened on their update norms (and, under layer scope, on their
    per-leaf norms over ``segments``) against the running median in
    ``state["quarantine"]``, before the clip: a rejected client's weight
    drops to 0, so it leaves every sum and renormalization; the modes with
    a weight delta or client state also zero its update, so its client rows
    stay as they were. The verdict needs no other chunk's norms.

    The linear grad modes run one vmap over all W clients at
    ``client_chunk`` 0, else W / C vmapped chunks of C clients whose sums
    are added in chunk order, so at most C full [d] updates are live at a
    time. fedavg/localSGD and local_topk run one vmap of all W (the knob is
    ignored, as in the reference); local_topk then compresses row by row in
    cohort order."""
    mcfg = cfg.mode
    W = part.shape[0]
    C = cfg.client_chunk
    if mcfg.uses_weight_delta or not modes.is_linear(mcfg) or not C or C >= W:
        C = W
    if W % C:
        raise ValueError(f"client_chunk={C} must divide the sampled cohort ({W})")
    quarantine = cfg.client_update_clip > 0
    layer_q = quarantine and cfg.quarantine_scope == "layer"
    # a weight delta or a client-state wire is formed from the update row
    # itself: a rejected client's row is zeroed before it can form one
    zero_bad = mcfg.uses_weight_delta or not modes.is_linear(mcfg)
    sums, new_rows, parts, norms, lnorms = None, {}, [], [], []
    for lo in range(0, W, C):
        cb = {k: v[lo:lo + C] for k, v in batch.items()}
        cpart = part[lo:lo + C]
        u, stats, metrics = updates(state, cb, lr, range(slot0 + lo, slot0 + lo + C))
        if quarantine:
            q = state["quarantine"]
            norms.append(_client_norms(u))
            bad = _quarantine_mask(cfg, norms[-1], q["median"])
            if layer_q:
                lnorms.append(_client_layer_norms(u, segments))
                bad = bad | _quarantine_layer_mask(cfg, lnorms[-1], q["layer_median"])
            cpart = cpart * (1.0 - bad.to(cpart.dtype))
            if zero_bad:
                u = torch.where(bad[:, None], torch.zeros_like(u), u)
        parts.append(cpart)
        u = _clip_rows(cfg, u, cpart)
        if not modes.is_linear(mcfg):
            u, new_rows = _compress_rows(mcfg, u, cpart, client_rows)
        chunk = _weighted_sums(cpart, u, stats, metrics)
        del u  # this chunk's updates are gone before the next chunk's exist
        sums = chunk if sums is None else (
            sums[0] + chunk[0], {k: v + chunk[1][k] for k, v in sums[1].items()},
            {k: v + chunk[2][k] for k, v in sums[2].items()})
    wsum, ns_sum, m_sum = sums
    return (wsum, ns_sum, m_sum, torch.cat(parts), torch.cat(norms) if quarantine else None,
            torch.cat(lnorms) if layer_q else None, new_rows)


@obtrace.spanned("federated", "round.client")
def _client_phase(updates: Callable, cfg: EngineConfig, state: dict, batch: dict,
                  client_rows: dict, lr, segments: tuple = ()):
    """The client phase of a round: the clients' updates (clipped to
    ``dp_clip``; local_topk: then their densified top-k wires, compressed
    with their rows of the client state) reduced to participation-weighted
    sums over the stacked client axis (``_client_reduce``). The
    participation weight is the batch's validity mask times the round's
    ``participation_mask``. Returns the reduced update [d] (the survivor
    mean unless agg_op=sum), the survivor mean of the batch-norm statistics
    (the previous ones when nobody survived), the metric sums with the
    participants count (and ``clients_quarantined``, ``quarantine_median``),
    the cohort's new rows ([W, d] per key; a client that did not take part
    keeps its row) and the advanced quarantine state (None when off)."""
    mcfg = cfg.mode
    batch, _, part = _cohort_part(cfg, state, batch)
    wsum, ns_sum, m_sum, part_eff, norms, lnorms, new_rows = _client_reduce(
        updates, cfg, state, batch, part, client_rows, lr, segments)
    n_live = part_eff.sum().clamp_min(1.0)
    weighted = wsum if mcfg.agg_op == "sum" else wsum / n_live
    new_net_state, metrics = _merged_survivor_finalize(ns_sum, m_sum, part_eff,
                                                       state["net_state"])
    new_q = None
    if cfg.client_update_clip > 0:
        metrics["clients_quarantined"] = part.sum() - part_eff.sum()
        new_q = _advance_quarantine_full(cfg, state["quarantine"], norms, lnorms, part_eff)
        metrics["quarantine_median"] = new_q["median"]
    return weighted, new_net_state, metrics, new_rows, new_q


def reduce_clients(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout,
                   state: dict, batch: dict) -> tuple[torch.Tensor, dict, dict]:
    """The client phase of a round of a mode without client state: (reduced
    update [d], survivor-mean batch-norm statistics, metric sums with the
    participants count)."""
    weighted, new_net_state, metrics, _, _ = _client_phase(
        make_client_updates(loss_fn, cfg, layout), cfg, state, batch, {}, None,
        layerwise.leaf_segments(layout))
    return weighted, new_net_state, metrics


def _all_finite(tensors) -> torch.Tensor:
    ok = None
    for t in tensors:
        if t.is_floating_point():
            f = torch.isfinite(t).all()
            ok = f if ok is None else ok & f
    return ok


def _guard_nonfinite(cfg: EngineConfig, agg: dict, new_net_state: dict, net_state: dict,
                     new_rows: dict, client_rows: dict, metrics: dict,
                     rows_ok: torch.Tensor | None = None):
    """on_nonfinite="skip": zero a non-finite aggregate, keep the previous
    batch-norm statistics and client rows, zero the round's training sums
    and flag it in ``nonfinite_rounds`` (the participants count and the
    quarantine's metrics stay). On finite data every select keeps its
    input. Also returns the round's finite flag (None with "off").
    ``rows_ok`` is the finite flag of new client rows held elsewhere (the
    other shards' of a sharded round), folded into the verdict."""
    if cfg.on_nonfinite != "skip":
        return agg, new_net_state, new_rows, metrics, None
    ok = _all_finite([*agg.values(), *new_net_state.values(), *new_rows.values()])
    if rows_ok is not None:
        ok = ok & rows_ok
    agg = {k: torch.where(ok, v, torch.zeros_like(v)) if v.is_floating_point() else v
           for k, v in agg.items()}
    new_net_state = {k: torch.where(ok, v, net_state[k]) for k, v in new_net_state.items()}
    new_rows = {k: torch.where(ok, v, client_rows[k]) for k, v in new_rows.items()}
    # the participants count and the quarantine's verdicts are server-side
    # bookkeeping, not sums of the poisoned forward pass: they stay
    keep = ("participants", "clients_quarantined", "quarantine_median")
    metrics = {k: v if k in keep else torch.where(ok, v, torch.zeros_like(v))
               for k, v in metrics.items()}
    metrics["nonfinite_rounds"] = (~ok).to(torch.float32)
    return agg, new_net_state, new_rows, metrics, ok


def _dp_noise_agg(cfg: EngineConfig, agg: dict, participants: torch.Tensor, rnd: int) -> dict:
    """Central DP on the aggregate: N(0, std^2) on every entry, std =
    dp_noise * sens * (participants > 0), sens = dp_clip for agg_op="sum"
    and dp_clip / max(participants, 1) for the mean (the mean divides by
    the survivors, so its sensitivity does too). An empty round transmits
    nothing and releases nothing. One generator per aggregate key, in
    sorted key order, seeded ``dropout_seed(seed, rnd, NOISE_TAG, i)`` on
    the aggregate's device."""
    n_live = participants.clamp_min(1.0)
    sens = cfg.dp_clip if cfg.mode.agg_op == "sum" else cfg.dp_clip / n_live
    std = cfg.dp_noise * sens * (participants > 0).to(torch.float32)
    out = {}
    for i, (k, v) in enumerate(sorted(agg.items())):
        gen = torch.Generator(device=v.device)
        gen.manual_seed(dropout_seed(cfg.seed, rnd, NOISE_TAG, i))
        out[k] = v + std * torch.randn(v.shape, generator=gen, device=v.device, dtype=v.dtype)
    return out


def _block_plan(cfg: EngineConfig, layout: FlatLayout) -> layerwise.BlockPlan | None:
    """The layerwise round's block plan (None on the ravel path)."""
    if cfg.sketch_path != "layerwise":
        return None
    return layerwise.make_block_plan(cfg.mode.sketch_spec, layout)


def _compress(mcfg: ModeConfig, update: torch.Tensor,
              plan: layerwise.BlockPlan | None) -> dict:
    """The wire of a reduced (or a shard's partial) [d] update of a linear
    mode: ``modes.client_compress``, or on the layerwise path the table
    folded from the update's slices (``plan``'s blocks; one tree launch on
    the card), bitwise the same table."""
    if plan is None:
        return modes.client_compress(mcfg, update, {})[0]
    leaves = [update[b.offset:b.offset + b.size] for b in plan.blocks]
    return {"table": layerwise.sketch_tree(mcfg.sketch_spec, leaves, plan)}


def make_round_step(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout) -> Callable:
    """step(state, batch, client_rows, lr) -> (state', client_rows',
    metrics): the reference's step, its device RNG replaced by generators
    seeded from (cfg.seed, state["round"]). ``batch`` holds
    tensors with leading axis W (the sampled clients; fedavg/localSGD add a
    [num_local_iters] axis after it), optionally with the ``VALID_KEY``
    mask; ``client_rows`` is {key: [W, d]} of the cohort's client state ({}
    when the mode keeps none); ``lr`` is the round's learning rate, a
    float32 0-d tensor on the state's device (the session copies it there
    without a host sync) or a Python float. The grad modes apply it at the
    server; the weight-delta modes take it in the local steps and apply the
    averaged delta at ``server_lr``. Metrics are device tensors summed over
    clients (and local steps)."""
    mcfg = cfg.mode
    _robust_scope_check(cfg)
    updates = make_client_updates(loss_fn, cfg, layout)
    segments = layerwise.leaf_segments(layout)
    plan = _block_plan(cfg, layout)

    @obtrace.spanned("federated", "round.step")
    def step(state: dict, batch: dict, client_rows: dict, lr):
        pflat = state["params"]
        batch, health_on = split_health(batch)
        lr_t = lr if torch.is_tensor(lr) else torch.tensor(lr, dtype=torch.float32,
                                                           device=pflat.device)
        weighted, new_net_state, metrics, new_rows, new_q = _client_phase(
            updates, cfg, state, batch, client_rows, lr_t, segments)
        if modes.is_linear(mcfg):
            # linearity shortcut: compress the reduced update once
            wire = _compress(mcfg, weighted, plan)
            agg = modes.aggregate(mcfg, {k: v[None] for k, v in wire.items()})
        else:
            agg = {"dense": weighted}
        raw_agg = agg  # the pre-guard wire: a health block shows the poison
        agg, new_net_state, new_rows, metrics, fin_ok = _guard_nonfinite(
            cfg, agg, new_net_state, state["net_state"], new_rows, client_rows, metrics)
        if cfg.dp_noise > 0:
            # a skipped round is an empty cohort: it releases no noise
            live = metrics["participants"]
            if fin_ok is not None:
                live = live * fin_ok.to(live.dtype)
            agg = _dp_noise_agg(cfg, agg, live, state["round"])
        # the weight-delta modes' local steps consumed lr; the server applies
        # the averaged delta at server_lr
        server_lr = mcfg.server_lr if mcfg.uses_weight_delta else lr_t
        delta, mode_state = modes.server_step_sparse(mcfg, agg, state["mode_state"], server_lr)
        if mcfg.mode == "local_topk":
            # the broadcast delta's support: local_topk's measured down-link
            metrics["down_support"] = modes.delta_support(mcfg.d, delta)
        new_state = {
            "params": modes.apply_delta(pflat, delta),
            "net_state": new_net_state,
            "mode_state": mode_state,
            "round": state["round"] + 1,
        }
        if new_q is not None:
            new_state["quarantine"] = new_q
        if cfg.health and health_on:
            # mode=sketch takes the linearity shortcut, so `weighted` is the
            # dense reduced update: the dense-comparable reference
            metrics.update(_health_metrics(cfg, raw_agg, delta, mode_state,
                                           weighted=weighted, segments=segments))
        metrics.update(_ledger_fingerprints(cfg, new_state))
        return new_state, new_rows, metrics

    return step


def _merged_survivor_finalize(ns_sum: dict, m_sum: dict, part: torch.Tensor,
                              net_state: dict) -> tuple[dict, dict]:
    """Survivor-mean batch-norm statistics (the previous ones when nobody
    survived) and the metric sums with the participants count, from the
    merged per-client sums."""
    n_live = part.sum().clamp_min(1.0)
    alive = part.sum() > 0
    new_net_state = {k: torch.where(alive, v / n_live, net_state[k]) for k, v in ns_sum.items()}
    metrics = dict(m_sum)
    metrics["participants"] = part.sum()
    return new_net_state, metrics


def _normalize_merged_wire(mcfg: ModeConfig, wire_sum: dict, n_live: torch.Tensor) -> dict:
    """Survivor normalisation in wire space, after the merge."""
    if mcfg.agg_op == "sum":
        return dict(wire_sum)
    return {k: v / n_live for k, v in wire_sum.items()}


def _table_norms(tables: torch.Tensor) -> torch.Tensor:
    """[W] L2 norm of each client's [r, c] table, in float32: the table
    round's quarantine observable. The table is the only object the server
    sees, so the screen and its running median live in sketch space (a
    Count-Sketch row's squared norm estimates the update's; a non-finite
    update gives a non-finite table)."""
    return torch.sqrt(torch.sum(torch.square(tables.to(torch.float32)), dim=(1, 2)))


# reserved batch keys: the adversarial transform of the table round
# (resilience/faults.py's client_signflip, client_scale, client_collude and
# client_normride). Client i transmits _adv_scale[i] * table[_adv_src[i]]
# (sketch linearity: scaling the table is scaling the update); with
# _adv_ride (a plan that names client_normride) a riding client's table is
# rescaled to ride * clip * running median, just under the quarantine. The
# identity (scale 1, src = position, ride 0) rides every round of a plan
# that names the kinds; the client step pops them before the updates
ADV_SCALE_KEY = "_adv_scale"
ADV_SRC_KEY = "_adv_src"
ADV_RIDE_KEY = "_adv_ride"


def split_adv(batch: dict) -> tuple[dict, tuple | None]:
    """Pop the adversarial keys off a round batch: (batch without them,
    (scale, src, ride or None) or None)."""
    if ADV_SCALE_KEY not in batch:
        return batch, None
    batch = dict(batch)
    scale, src = batch.pop(ADV_SCALE_KEY), batch.pop(ADV_SRC_KEY)
    return batch, (scale, src, batch.pop(ADV_RIDE_KEY, None))


def _apply_adv(tables: torch.Tensor, adv, clip: float = 0.0,
               qmed: torch.Tensor | None = None) -> torch.Tensor:
    """The adversarial wire transform of the [W, r, c] table stack: row i
    becomes scale[i] * tables[src[i]] (the identity leaves give the same
    values bit for bit). With ``ride`` and the quarantine's ``qmed``, a
    riding row (ride > 0) is rescaled so its table L2 is ride * clip * qmed;
    with no baseline yet (qmed 0) it is left as it is."""
    if adv is None:
        return tables
    scale, src, ride = adv
    out = tables.index_select(0, src.to(torch.int64)) * scale.to(tables.dtype)[:, None, None]
    if ride is not None and qmed is not None:
        norms = _table_norms(out)
        target = ride.to(torch.float32) * clip * qmed
        factor = torch.where((ride > 0) & (target > 0) & (norms > 0),
                             target / norms.clamp_min(1e-12), torch.ones_like(norms))
        out = out * factor.to(out.dtype)[:, None, None]
    return out


def _stale_fold(table: torch.Tensor, live_weight: torch.Tensor, stale_tables: torch.Tensor,
                stale_weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """The buffered-async service's fold of late client tables into the
    merged wire table, the port's one site of arithmetic over the stale
    stack (the reference's ``engine._stale_fold``): a left fold in slot
    order, ``table += w_i * t_i`` and ``weight += w_i``, so the float
    association is fixed by the slots the service filled (source round,
    then cohort position, then admission order). Returns (the folded
    table, the live weight plus the stale weights, which the survivor
    normalisation divides by, and the metrics ``stale_folded``, the slots
    of positive weight, and ``stale_weight``, their weights' sum in slot
    order)."""
    tbl, total = table, live_weight
    stale_weight = torch.zeros_like(live_weight)
    for i in range(stale_tables.shape[0]):
        w = stale_weights[i]
        tbl = tbl + w * stale_tables[i]
        total = total + w
        stale_weight = stale_weight + w
    return tbl, total, {"stale_folded": (stale_weights > 0).sum(),
                        "stale_weight": stale_weight}


def make_payload_round_steps(loss_fn: Callable, cfg: EngineConfig,
                             layout: FlatLayout, group=None, *,
                             edge_input: str = "none") -> tuple[Callable, Callable]:
    """The per-client-table round as two steps, the shape a serving
    deployment has (the reference's ``make_payload_round_steps`` with no
    mesh): the wire-payload round (``wire_payloads``) and the round of a
    robust merge policy or adversarial fault kinds.

        client_step(state, batch) -> (tables [W, r, c], nstates, mvals, part,
                                      lnorms)
        merge_step(state, tables, nstates, mvals, part, arrived, lr,
                   lnorms=None, health_on=False, stale_tables=None,
                   stale_weights=None, norms_wire=None, edge_assign=None)
            -> (state', metrics)

    ``client_step`` is "the clients": the clients' updates
    (``make_client_updates``; ``client_chunk`` does not apply), each row
    clipped to ``dp_clip`` and sketched into its own [r, c] table, row by
    row in cohort order (on the card, one ``sketch_accumulate`` launch per
    client: what the reference's ``sequential_vmap`` lowers to), then the
    adversarial transform of the batch's ``_adv_*`` keys on the stack
    (``_apply_adv``). With ``cfg.client_shards`` S > 1 the clients run as
    S groups of W / S, one vmap a group, one group after another, as the
    reference's ``lax.map`` over its groups (so at most W / S updates are
    live); S = 1 is one vmap of all W, whose [W, d] stack of updates is
    live, as in the reference. Given a ``torch.distributed`` group of S
    ranks, each rank runs its own group (its batch holds cohort slots
    [rank * W / S, (rank + 1) * W / S), W / S accumulate launches) and one
    ordered ``all_gather`` of the tables, statistics, metric rows, masks
    and norms makes the [W, ...] stacks in slot order on every rank, the
    emulation's stacks bit for bit; the adversarial transform and the
    merge then run replicated. Per-client tables keep the merge's
    arithmetic per client, so the merge is the same at any S. ``nstates``
    and ``mvals`` are each client's batch-norm
    statistics and metric sums, stacked on [W]; ``part`` is the validity
    mask times the participation mask; ``lnorms`` the [W, L] per-leaf update
    norms before the clip under layer scope (else None).

    ``merge_step`` is "the server": it sees only the tables and the small
    per-client rows. ``arrived`` is the serving layer's 0/1 admission mask
    (ones in the batch round): a rejected or missing payload is a zero row
    under a 0 weight, exactly a dropped client. With the quarantine armed
    the tables are screened on their norms (and on ``lnorms`` under layer
    scope) against ``state["quarantine"]``; a robust policy also masks a
    non-finite table out. The merge is the masked ordered sum over the
    client axis (``modes.merge_partial_wires``) with survivor
    normalisation in wire space, or the robust mean, rescaled by the live
    count for agg_op=sum (with ``robust_residual`` its winsorized residual
    joins Verror at lr before the server step). Then the non-finite guard,
    the ring's advance and ``modes.server_step_sparse`` (one query launch
    on the card).

    The batch round composes the two (``compose_payload``); the serving
    layer round-trips each client's table through the transport between
    them. float32 framing is exact and both run these two functions, which
    is what makes a served payload round bitwise the batch round that
    drops the same clients. There is no compress-once shortcut here: the
    sum of W tables is another float association than the sketch of the
    summed update, so payload params are not bit-comparable to the
    announce round's.

    With ``stale_tables`` [n, r, c] and ``stale_weights`` [n] (the
    buffered-async service's late tables, n <= ``cfg.stale_slots``) the sum
    folds them in after the live cohort's ordered sum (``_stale_fold``) and
    normalises by the live count plus their weights; a robust policy takes
    them into its order statistics as weighted rows of the union stack
    (``modes.merge_partial_wires``). Either adds ``stale_folded`` and
    ``stale_weight`` to the metrics. A round without them runs exactly the
    plain merge.

    ``edge_input`` picks the edge tree's variants of the sum (``--serve_edges``,
    ``cfg.serve_edges`` E >= 2; ``serve/scale/edge.py``): "tables", the
    grouped flat twin, takes the [W, r, c] stack and folds it edge by edge
    (``modes.edge_grouped_sum``); "partials", the root, takes the [E, r, c]
    partials the edges forwarded in place of ``tables`` and folds them in
    edge order (``modes.merge_edge_partials``). Both take ``norms_wire``,
    the [W] per-client wire norms the serving layer computed, in place of
    the norms of ``tables``, and ``edge_assign``, the [W] edge of each
    position on the host; everything after the sum is the plain merge's.
    "none" is the plain merge."""
    mcfg = cfg.mode
    if mcfg.mode != "sketch":
        raise ValueError(f"the per-client-table round requires mode='sketch'; "
                         f"mode={mcfg.mode!r} has no table wire")
    if edge_input not in ("none", "tables", "partials"):
        raise ValueError(f"edge_input must be none|tables|partials, got {edge_input!r}")
    if edge_input != "none" and cfg.serve_edges < 2:
        raise ValueError(f"edge_input={edge_input!r} needs cfg.serve_edges >= 2, got "
                         f"{cfg.serve_edges} (the edge partition size is part of the compiled "
                         "program)")
    updates = make_client_updates(loss_fn, cfg, layout)
    segments = layerwise.leaf_segments(layout)
    quarantine = cfg.client_update_clip > 0
    layer_q = quarantine and cfg.quarantine_scope == "layer"
    pol = robust_policy(cfg)
    S, shard = _group_info(cfg, group)

    def group_tables(state: dict, batch_g: dict, slots: range) -> dict:
        """One group's clients (cohort ``slots``): their tables, statistics,
        metric rows and (layer scope) per-leaf norms, under "t", "ns/",
        "m/" and "lnorms"."""
        u, nstates, mvals = updates(state, batch_g, None, slots)
        out = {f"ns/{k}": v for k, v in nstates.items()}
        out.update({f"m/{k}": v for k, v in mvals.items()})
        if layer_q:
            out["lnorms"] = _client_layer_norms(u, segments)
        u = _clip_rows(cfg, u)
        # row by row, in cohort order: what the reference's sequential_vmap
        # of the accumulate lowers to
        out["t"] = torch.stack([modes.client_compress(mcfg, u[w], {})[0]["table"]
                                for w in range(u.shape[0])])
        return out

    @obtrace.spanned("federated", "round.step")
    @obtrace.spanned("federated", "round.client")
    def client_step(state: dict, batch: dict):
        batch, _ = split_health(batch)  # the merge computes health
        batch, adv = split_adv(batch)
        if group is None:
            batch, W, part = _cohort_part(cfg, state, batch)
            if W % S:
                raise ValueError(f"sampled cohort ({W}) not divisible by client_shards={S}")
            wl = W // S
            outs = [group_tables(state, {k: v[lo:lo + wl] for k, v in batch.items()},
                                 range(lo, lo + wl)) for lo in range(0, W, wl)]
            out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        else:
            n = next(iter(batch.values())).shape[0]
            lo = shard * n
            batch, _, part_l = _cohort_part(cfg, state, batch, n * S, lo)
            local = group_tables(state, batch, range(lo, lo + n))
            local["part"] = part_l
            out = {k: v.reshape((-1,) + v.shape[2:])
                   for k, v in _gather_in_shard_order(local, group).items()}
            part = out.pop("part")
        tables = _apply_adv(out.pop("t"), adv, cfg.client_update_clip,
                            state["quarantine"]["median"] if quarantine else None)
        nstates = {k[3:]: v for k, v in out.items() if k.startswith("ns/")}
        mvals = {k[2:]: v for k, v in out.items() if k.startswith("m/")}
        return tables, nstates, mvals, part, out.get("lnorms")

    @obtrace.spanned("federated", "round.step")
    def merge_step(state: dict, tables: torch.Tensor, nstates: dict, mvals: dict,
                   part: torch.Tensor, arrived: torch.Tensor, lr,
                   lnorms: torch.Tensor | None = None, health_on: bool = False,
                   stale_tables: torch.Tensor | None = None,
                   stale_weights: torch.Tensor | None = None,
                   norms_wire: torch.Tensor | None = None, edge_assign=None):
        part = part * arrived
        part_eff, norms = part, None
        if quarantine:
            q = state["quarantine"]
            # the edge variants screen against the wire norms the serving
            # layer computed (per client, so the grouped twin and the root
            # read the same values); the plain merge computes them here
            norms = norms_wire if edge_input != "none" else _table_norms(tables)
            bad = _quarantine_mask(cfg, norms, q["median"])
            if layer_q:
                bad = bad | _quarantine_layer_mask(cfg, lnorms, q["layer_median"])
            part_eff = part * (1.0 - bad.to(part.dtype))
        if pol is not None:
            # a non-finite table never enters the order statistics, so it
            # leaves the round the same way: the survivor count, the rescale,
            # the metric folds and the rings
            finite = torch.isfinite(tables).reshape(tables.shape[0], -1).all(dim=1)
            part_eff = part_eff * finite.to(part_eff.dtype)
        residual, stale = None, {}
        if pol is None:
            # merge_policy="trimmed" with trim 0 runs this branch: the sum
            if edge_input == "partials":
                # the edge tree's root: `tables` is the [E, r, c] stack of
                # partials, already masked by the edges
                wire_sum = {"table": modes.merge_edge_partials(tables)}
            elif edge_input == "tables":
                # the grouped flat twin: the same two-level fold over the
                # full stack and the same partition
                wire_sum = {"table": modes.edge_grouped_sum(tables, part_eff, edge_assign,
                                                            cfg.serve_edges)}
            else:
                wire_sum = modes.merge_partial_wires(
                    mcfg, {"table": modes.mask_rows(part_eff, tables)})
            total_w = part_eff.sum()
            if stale_tables is not None:
                # the late tables join after the live cohort's ordered sum
                # (linearity makes the staging exact), their weights the
                # survivor normalisation
                folded, total_w, stale = _stale_fold(wire_sum["table"], total_w, stale_tables,
                                                     stale_weights)
                wire_sum = {"table": folded}
            agg = _normalize_merged_wire(mcfg, wire_sum, total_w.clamp_min(1.0))
        else:
            merged = modes.merge_partial_wires(
                mcfg, {"table": tables}, policy=pol, live=part_eff, trim=cfg.merge_trim,
                stale_tables=stale_tables, stale_weights=stale_weights,
                want_residual=cfg.robust_residual)
            if cfg.robust_residual or stale_tables is not None:
                robust, total_w, extras = merged
                residual = extras.get("residual")
                stale = {k: extras[k] for k in ("stale_folded", "stale_weight") if k in extras}
            else:
                robust, total_w = merged, part_eff.sum()
            # the robust mean; agg_op=sum rescales by the live count, so
            # sum@lr == mean@lr*W survives
            if mcfg.agg_op == "sum":
                scale_w = total_w.clamp_min(1.0)
                robust = {k: v * scale_w for k, v in robust.items()}
                residual = None if residual is None else residual * scale_w
            agg = robust
        new_net_state, metrics = _merged_survivor_finalize(
            {k: modes.mask_rows(part_eff, v).sum(0) for k, v in nstates.items()},
            {k: modes.mask_rows(part_eff, v).sum(0) for k, v in mvals.items()},
            part_eff, state["net_state"])
        metrics.update(stale)
        new_q = None
        if quarantine:
            metrics["clients_quarantined"] = part.sum() - part_eff.sum()
            new_q = _advance_quarantine_full(cfg, state["quarantine"], norms, lnorms, part_eff)
            metrics["quarantine_median"] = new_q["median"]
        raw_agg = agg  # the pre-guard wire for the health estimators
        agg, new_net_state, _, metrics, _ = _guard_nonfinite(
            cfg, agg, new_net_state, state["net_state"], {}, {}, metrics)
        # dp_noise is refused with mode=sketch (EngineConfig)
        mode_state_in = state["mode_state"]
        if residual is not None:
            # the winsorized residual joins the error accumulator at the
            # server step's lr scale; the momentum stays on the robust series
            mode_state_in = dict(mode_state_in, Verror=mode_state_in["Verror"] + lr * residual)
        delta, mode_state = modes.server_step_sparse(mcfg, agg, mode_state_in, lr)
        new_state = {
            "params": modes.apply_delta(state["params"], delta),
            "net_state": new_net_state,
            "mode_state": mode_state,
            "round": state["round"] + 1,
        }
        if new_q is not None:
            new_state["quarantine"] = new_q
        if cfg.health and health_on:
            # a served round sees only wire tables: the wire-side
            # estimators, what a server that never holds a dense gradient
            # can measure
            metrics.update(_health_metrics(cfg, raw_agg, delta, mode_state))
        metrics.update(_ledger_fingerprints(cfg, new_state))
        return new_state, metrics

    return client_step, merge_step


def compose_payload(client_step: Callable, merge_step: Callable) -> Callable:
    """The payload pair as a round step with ``make_round_step``'s
    signature, the batch round of a table-round session: the client tables
    flow straight into the merge with every invitee arrived. Client rows
    pass through (the table round keeps no client state)."""

    def step(state: dict, batch: dict, client_rows: dict, lr):
        pflat = state["params"]
        lr_t = lr if torch.is_tensor(lr) else torch.tensor(lr, dtype=torch.float32,
                                                           device=pflat.device)
        # the cadence flag gates the merge's health block
        batch, health_on = split_health(batch)
        tables, nstates, mvals, part, lnorms = client_step(state, batch)
        new_state, metrics = merge_step(state, tables, nstates, mvals, part,
                                        torch.ones_like(part), lr_t, lnorms=lnorms,
                                        health_on=health_on)
        return new_state, client_rows, metrics

    return step


def supports_sharded_round(mcfg: ModeConfig) -> bool:
    """The reference's sharded-round scope: linear grad modes without
    client-local state and without the local-SGD weight-delta loop, where
    compression commutes with the cross-shard sum (FetchSGD's sketch
    linearity; trivially the dense wires). The session's ``client_shards``
    asks for these modes only, as the reference's does; on a group of ranks
    the port also runs the other modes through ``make_sharded_round_step``,
    which the reference runs over its mesh by GSPMD."""
    return modes.is_linear(mcfg) and not mcfg.needs_local_state and not mcfg.uses_weight_delta


def _robust_scope_check(cfg: EngineConfig):
    """A robust merge policy needs per-client tables, which the linear
    round builders never make: a direct caller reaching one with a policy
    armed gets a loud error, not a silently linear merge."""
    if robust_policy(cfg) is not None:
        raise ValueError(
            f"merge_policy={cfg.merge_policy!r} (trim={cfg.merge_trim}) needs the per-client-"
            "table round: use make_payload_round_steps (FederatedSession routes this "
            "automatically); the linear round builders merge by the ordered sum only")


def _merged_sharded_tail(cfg: EngineConfig, state: dict, stacked: dict, lr,
                         health_on: bool = False) -> tuple[dict, dict, torch.Tensor | None]:
    """Everything after the shards' client phases, shared by the emulation
    and the ranks of a group so they cannot drift: the ordered merge of the
    [S, ...] partial wires (``modes.merge_partial_wires``: an ordered sum,
    shard 0 first, not an all-reduce), survivor normalisation in wire space,
    the batch-norm and metric sums, the quarantine's rings from the
    gathered [W] norms, the non-finite guard, DP noise and the server step
    (at ``server_lr`` for the weight-delta modes, whose local steps took
    ``lr``). Returns (state', metrics, the guard's finite flag or None).

    ``stacked`` holds each shard's outputs (``make_sharded_round_step``'s
    ``shard_outputs``) stacked on a leading [S] axis in shard order:
    "wire/<key>", "ns/<key>", "m/<key>", "part_eff" ([S, W/S]: dropout x
    validity x quarantine), with the quarantine armed "part" (before the
    quarantine), "norms" and under layer scope "lnorms", and with client
    state "rows_ok", each shard's finite flag of its new rows. A sharded
    round merges wires, so only the wire-side health estimators exist (the
    dense reduced update never does).

    Where the algebra differs from the linear modes': a local_topk shard's
    partial is the sum of its clients' densified top-k wires, each
    compressed against that client's rows, so compression does not commute
    with this sum and nothing is compressed here (the sum of those wires is
    the aggregate all the same, merged by the dense ordered sum); and the
    guard's verdict, which in the unsharded round reads every new client
    row, reads the gathered ``rows_ok`` flags, since the rows stay with
    their shards (the caller keeps its own rows on a non-finite round)."""
    mcfg = cfg.mode

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in stacked.items() if k.startswith(prefix)}

    wire_sum = (modes.merge_partial_wires(mcfg, sub("wire/")) if modes.is_linear(mcfg)
                else {"dense": stacked["wire/dense"].sum(0)})
    part_eff = stacked["part_eff"].reshape(-1)
    agg = _normalize_merged_wire(mcfg, wire_sum, part_eff.sum().clamp_min(1.0))
    new_net_state, metrics = _merged_survivor_finalize(
        {k: v.sum(0) for k, v in sub("ns/").items()},
        {k: v.sum(0) for k, v in sub("m/").items()}, part_eff, state["net_state"])
    new_q = None
    if cfg.client_update_clip > 0:
        metrics["clients_quarantined"] = stacked["part"].sum() - part_eff.sum()
        lnorms = stacked.get("lnorms")
        new_q = _advance_quarantine_full(
            cfg, state["quarantine"], stacked["norms"].reshape(-1),
            None if lnorms is None else lnorms.reshape((-1,) + lnorms.shape[2:]), part_eff)
        metrics["quarantine_median"] = new_q["median"]
    raw_agg = agg  # the pre-guard wire: a health block shows the poison
    rows_ok = stacked["rows_ok"].all() if "rows_ok" in stacked else None
    agg, new_net_state, _, metrics, fin_ok = _guard_nonfinite(
        cfg, agg, new_net_state, state["net_state"], {}, {}, metrics, rows_ok)
    if cfg.dp_noise > 0:
        live = metrics["participants"]
        if fin_ok is not None:
            live = live * fin_ok.to(live.dtype)
        agg = _dp_noise_agg(cfg, agg, live, state["round"])
    server_lr = mcfg.server_lr if mcfg.uses_weight_delta else lr
    delta, mode_state = modes.server_step_sparse(mcfg, agg, state["mode_state"], server_lr)
    if mcfg.mode == "local_topk":
        metrics["down_support"] = modes.delta_support(mcfg.d, delta)
    new_state = {
        "params": modes.apply_delta(state["params"], delta),
        "net_state": new_net_state,
        "mode_state": mode_state,
        "round": state["round"] + 1,
    }
    if new_q is not None:
        new_state["quarantine"] = new_q
    if cfg.health and health_on:
        metrics.update(_health_metrics(cfg, raw_agg, delta, mode_state))
    metrics.update(_ledger_fingerprints(cfg, new_state))
    return new_state, metrics, fin_ok


def _group_info(cfg: EngineConfig, group) -> tuple[int, int]:
    """(S, this rank's shard) of a ``torch.distributed`` group, or
    (cfg.client_shards, 0) for the one-device emulation (group None)."""
    if group is None:
        return cfg.client_shards, 0
    import torch.distributed as dist

    S = dist.get_world_size(group)
    if cfg.client_shards > 1 and cfg.client_shards != S:
        raise ValueError(f"cfg.client_shards={cfg.client_shards} disagrees with the "
                         f"{S}-rank group")
    return S, dist.get_rank(group)


def _gather_in_shard_order(out: dict, group) -> dict:
    """Every rank's ``out`` (same keys, shapes and dtypes on each), stacked
    to [S, ...] in rank order: one ``all_gather`` of their bytes."""
    from ..parallel import distributed

    keys = sorted(out)
    return dict(zip(keys, distributed.all_gather_stacked([out[k] for k in keys], group)))


def make_sharded_round_step(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout,
                            group=None) -> Callable:
    """The data-parallel round as S shards, the twin of the reference's
    ``make_sharded_round_step``, with ``make_round_step``'s signature.

    Each shard runs the client phase on its W / S clients (its cohort
    slots, so its participation mask and dropout streams are the ones those
    clients have in the unsharded round) and reduces them to one weighted
    sum. A linear grad mode compresses that sum: for mode=sketch the shard's
    partial Count Sketch, one ``sketch_accumulate`` launch. local_topk
    compresses each client against its rows of the client state, row by row
    in cohort order, as ``_client_reduce`` does, and its partial is the sum
    of the densified wires; fedavg/localSGD sum the clients' weight deltas
    of ``num_local_iters`` local steps at ``lr``. The partials are merged by
    one ordered sum in ``_merged_sharded_tail`` (one ``sketch_query`` launch
    in the server step of mode=sketch).

    ``client_rows`` is {key: [W, d]} of the cohort's client state on the
    emulation, {key: [W / S, d]} of this rank's slots on a group ({} when
    the mode keeps none); the new rows come back at the same shape, the old
    ones where the non-finite guard skipped the round.

    ``group=None`` is the emulation on one device: a loop over the
    ``cfg.client_shards`` shards of the full [W] batch, stacked in shard
    order. Given a ``torch.distributed`` group of S ranks, the batch is the
    rank's own shard ([W / S] rows, cohort slots from rank * W / S), the
    rank runs its shard and ``all_gather``s every output (the wire, the
    statistic and metric sums, the effective mask, the quarantine's norms
    and the rows' finite flag) into the same stacks, and the tail runs
    replicated. Every rank runs the same ops at the same shapes as the
    emulation's loop body and the tail runs on identical stacks, so a given
    S gives the same bits on one device and on S ranks. Different S
    associate the sum differently: allclose, not bitwise, to the unsharded
    round. The reference's ``client_shards`` takes only the modes of
    ``supports_sharded_round``; it runs the others over a mesh by GSPMD, of
    which this is the port's form, and the emulation of them is that
    group's one-device twin."""
    mcfg = cfg.mode
    _robust_scope_check(cfg)
    S, shard = _group_info(cfg, group)
    if S <= 1:
        raise ValueError("sharded round needs client_shards > 1 (or a group of > 1 ranks); "
                         "use make_round_step for the unsharded round")
    updates = make_client_updates(loss_fn, cfg, layout)
    segments = layerwise.leaf_segments(layout)
    plan = _block_plan(cfg, layout)
    quarantine = cfg.client_update_clip > 0
    linear = modes.is_linear(mcfg)

    @obtrace.spanned("federated", "round.client")
    def shard_outputs(state: dict, batch_l: dict, rows_l: dict, lo: int, W: int, lr):
        """One shard's client phase over cohort slots [lo, lo + W / S):
        (its outputs for the merge, its clients' new rows)."""
        batch_l, _, part_l = _cohort_part(cfg, state, batch_l, W, lo)
        wsum, ns_sum, m_sum, part_eff, norms, lnorms, new_rows = _client_reduce(
            updates, cfg, state, batch_l, part_l, rows_l, lr, segments, slot0=lo)
        wire = _compress(mcfg, wsum, plan) if linear else {"dense": wsum}
        out = {"part_eff": part_eff, **{f"wire/{k}": v for k, v in wire.items()},
               **{f"ns/{k}": v for k, v in ns_sum.items()},
               **{f"m/{k}": v for k, v in m_sum.items()}}
        if quarantine:
            out.update(part=part_l, norms=norms)
            if lnorms is not None:
                out["lnorms"] = lnorms
        if new_rows and cfg.on_nonfinite == "skip":
            out["rows_ok"] = _all_finite(new_rows.values())
        return out, new_rows

    @obtrace.spanned("federated", "round.step")
    def step(state: dict, batch: dict, client_rows: dict, lr):
        batch, health_on = split_health(batch)
        lr_t = lr if torch.is_tensor(lr) else torch.tensor(lr, dtype=torch.float32,
                                                           device=state["params"].device)
        n = next(iter(batch.values())).shape[0]
        if group is None:
            if n % S:
                raise ValueError(f"sampled cohort ({n}) not divisible by client_shards={S}")
            wl = n // S
            res = [shard_outputs(state, {k: v[s * wl:(s + 1) * wl] for k, v in batch.items()},
                                 {k: v[s * wl:(s + 1) * wl] for k, v in client_rows.items()},
                                 s * wl, n, lr_t) for s in range(S)]
            stacked = {k: torch.stack([o[k] for o, _ in res]) for k in res[0][0]}
            new_rows = {k: torch.cat([r[k] for _, r in res]) for k in client_rows}
        else:
            out, new_rows = shard_outputs(state, batch, client_rows, shard * n, n * S, lr_t)
            stacked = _gather_in_shard_order(out, group)
        new_state, metrics, fin_ok = _merged_sharded_tail(cfg, state, stacked, lr_t, health_on)
        if fin_ok is not None:
            new_rows = {k: torch.where(fin_ok, v, client_rows[k]) for k, v in new_rows.items()}
        return new_state, new_rows, metrics

    return step


def make_multi_round_step(loss_fn: Callable, cfg: EngineConfig, layout: FlatLayout,
                          step: Callable | None = None) -> Callable:
    """K rounds in one call, the twin of the reference's
    ``make_multi_round_step``: multi(state, batches, lrs) -> (state',
    metrics) with every batch leaf [K, W, ...], ``lrs`` a float32 [K]
    tensor and every metric stacked to [K]. The reference scans the round
    step in one compiled program; eager PyTorch has no scan, so this is a
    loop over the same step, which keeps it bitwise equal to K single
    rounds. A health metric of the block's off-cadence rounds stacks as
    zeros, as the reference's off branch gives them. A mode with per-client
    state is refused, as in the reference: the session gathers and scatters
    its rows between rounds. ``step`` is the round to repeat (default
    ``make_round_step``'s; a sharded session passes its sharded step)."""
    if cfg.mode.needs_local_state:
        raise ValueError(
            "multi-round dispatch requires a mode without per-client persistent state "
            "(the session gathers/scatters those rows between rounds); use per-round "
            f"dispatch for mode={cfg.mode.mode!r} error_type={cfg.mode.error_type!r}")
    step = step or make_round_step(loss_fn, cfg, layout)

    def multi(state: dict, batches: dict, lrs: torch.Tensor):
        per_round = []
        for i in range(lrs.shape[0]):
            state, _, metrics = step(state, {k: v[i] for k, v in batches.items()}, {}, lrs[i])
            per_round.append(metrics)
        shapes = {k: v for m in per_round for k, v in m.items()}
        return state, {k: torch.stack([m.get(k, torch.zeros_like(v)) for m in per_round])
                       for k, v in shapes.items()}

    return multi


def make_eval_step(loss_fn: Callable, layout: FlatLayout) -> Callable:
    """eval(params_flat, net_state, batch) -> metric sums, forward only."""

    def evaluate(pflat: torch.Tensor, net_state: dict, batch: dict) -> dict:
        with torch.no_grad():
            _, aux = loss_fn(layout.unflatten(pflat), net_state, batch, None)
        return aux["metrics"]

    return evaluate
