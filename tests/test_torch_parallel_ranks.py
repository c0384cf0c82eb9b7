"""Rank functions and cases of the port's parallelism tests (the
collectives, tensor parallelism on the ``model`` axis, ring attention
and GPT-2 on a ``seq`` axis, the GPipe op, and ``--eval_f1`` and
``--serve`` on seq and model groups), started by
``distributed.launch_local`` from tests/test_torch_parallel_2rank.py and
tests/test_torch_parallel_4rank.py. Every spawned rank imports this
module, so it imports no JAX: the reference's numbers are computed in the
test process and its inputs come in as numpy arrays. It holds no test.

Each rank function saves what its rank computed to ``out_dir``; the test
files hold it against the reference, against the port's one-device runs
and across the ranks."""

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from commefficient_tpu_torch import gpt2_train
from commefficient_tpu_torch.federated import engine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models.generate import make_generate
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models.losses import make_lm_loss, make_lm_mc_loss
from commefficient_tpu_torch.modes.config import ModeConfig
from commefficient_tpu_torch.ops import pipeline
from commefficient_tpu_torch.ops import ring_attention as tring
from commefficient_tpu_torch.parallel import collectives as coll
from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel.mesh import ClientMesh

# the reference's TP round (tests/test_gpt2.py::
# test_tp_sharded_sketch_federated_round_matches_unsharded): TINY at
# T = 16 with dropout 0, FetchSGD rotation sketch, 4 clients x 2 rows, 2
# rounds at lr 0.1
TP_T, TP_W, TP_ROUNDS, TP_LR, TP_WD = 16, 4, 2, 0.1, 1e-4
TP_MODE = dict(mode="sketch", k=64, num_rows=3, num_cols=4096, hash_family="rotation",
               momentum_type="virtual", error_type="virtual")
# the same rows as 2 local steps of one row each (the full update rebuilt
# after every step)
FEDAVG_MODE = dict(mode="fedavg", num_local_iters=2, momentum_type="none", error_type="none")
# the reference's ring-in-a-round setup (tests/test_ring_attention.py::
# test_ring_inside_federated_round_matches_dense): T = 32, 2 clients x 2
# rows, one uncompressed round at lr 0.1
RING_T, RING_LR = 32, 0.1
RING_MODE = dict(mode="uncompressed", momentum_type="none", error_type="none")
# the port's own cases on a group against its one-device twin: MoE every
# second block, dropout 0.1 (the same masks on every rank), remat
OWN_T, OWN_W, OWN_V = 16, 4, 261
OWN_MODE = dict(mode="sketch", k=200, num_rows=3, num_cols=4096, hash_family="rotation",
                momentum=0.9, momentum_type="virtual", error_type="virtual")
PIPE_LAYERS = 4
CLI_ARGS = ["--device", "cpu", "--model_size", "tiny", "--seq_len", "32", "--num_clients", "8",
            "--num_workers", "2", "--local_batch_size", "2", "--num_rounds", "2", "--mode",
            "sketch", "--k", "500", "--num_cols", "4096", "--num_rows", "3", "--eval_every",
            "2", "--data_root", "/nonexistent", "--sync_loop"]
LOCAL_TOPK = ["--mode", "local_topk", "--num_workers", "4", "--k", "300"]
# --eval_f1 and --serve on seq and model groups: the mesh flags, the
# decode's flags (greedy), and the served runs by name
TP_FLAGS = ["--model_parallel", "2"]
SEQ_FLAGS = ["--seq_parallel", "2", "--attn_impl", "ring"]
F1_NEW = 6
F1_FLAGS = ["--eval_f1", "2", "--decode_max_new", str(F1_NEW)]
SKETCH_SERVE = ["--serve", "inproc", "--serve_payload", "sketch"]
SERVED = {"sketch": SKETCH_SERVE,
          "sketch_pipe": SKETCH_SERVE + ["--serve_pipeline"],
          "announce": ["--serve", "inproc"],
          "announce_pipe": ["--serve", "inproc", "--serve_pipeline"]}
# served variants run on the model group only: the buffered-async service,
# the fast path, the edge tree, and process shards behind the socket
SERVED_TP = {"async": SKETCH_SERVE + ["--serve_async"],
             "fastpath": SKETCH_SERVE + ["--serve_fastpath"],
             "edges": SKETCH_SERVE + ["--serve_edges", "2"],
             "procshards": ["--serve", "socket", "--serve_transport", "eventloop",
                            "--serve_payload", "sketch", "--serve_shards", "2",
                            "--serve_shard_mode", "process"]}
# the pipelined payload run whose worker computes beside an eval and an F1
# decode at every round
OVERLAP_FLAGS = SKETCH_SERVE + ["--serve_pipeline", "--eval_every", "1"] + F1_FLAGS


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def tp_round(flax_params, ids, axes=None, group=None, shard=0, shards=1, mode=None):
    """(params, loss_sum of each round) of the reference's TP round on the
    port (or in another ``mode``): one device (``axes`` None), or this
    rank's part of a group (the model's ``axes``, the client ``group`` of
    ``shards`` shards)."""
    mode = mode or TP_MODE
    cfg_m = dataclasses.replace(tgpt2.TINY, n_positions=TP_T, dropout=0.0)
    model = tgpt2.GPT2LMHead(cfg_m, axes=axes)
    tparams, _ = convert.params_from_flax(model, flax_params, {})
    layout = convert.FlatLayout(model)
    cfg = engine.EngineConfig(mode=ModeConfig(d=layout.d, **mode), weight_decay=TP_WD,
                              client_shards=shards)
    state = engine.init_server_state(cfg, layout.flatten(tparams), {})
    loss = make_lm_loss(model, train=True)
    step = (engine.make_sharded_round_step(loss, cfg, layout, group) if shards > 1
            else engine.make_round_step(loss, cfg, layout))
    wl = TP_W // shards
    rows = ids[shard * wl:(shard + 1) * wl]
    if mode["mode"] == "fedavg":  # [W, steps, rows a step, T]
        rows = rows.reshape(wl, mode["num_local_iters"], -1, rows.shape[-1])
    b = {"input_ids": _t(rows), "labels": _t(rows)}
    sums = []
    for _ in range(TP_ROUNDS):
        state, _, m = step(state, b, {}, torch.tensor(TP_LR))
        sums.append(float(m["loss_sum"]))
    return {"params": state["params"], "loss_sum": sums}


def ring_round(flax_params, batch, attn_impl, axes=None):
    """New params of the reference's ring-in-a-round setup on the port."""
    cfg_m = dataclasses.replace(tgpt2.TINY, n_positions=RING_T, attn_impl=attn_impl)
    model = tgpt2.GPT2LMHead(cfg_m, axes=axes)
    tparams, _ = convert.params_from_flax(model, flax_params, {})
    layout = convert.FlatLayout(model)
    cfg = engine.EngineConfig(mode=ModeConfig(d=layout.d, **RING_MODE))
    state = engine.init_server_state(cfg, layout.flatten(tparams), {})
    step = engine.make_round_step(make_lm_loss(model, train=True), cfg, layout)
    new, _, m = step(state, {k: _t(v) for k, v in batch.items()}, {}, torch.tensor(RING_LR))
    return {"params": new["params"], "loss_sum": float(m["loss_sum"])}


def own_case(name):
    """(model config, loss kind, batch) of one of the port's own group
    cases: ``moe`` (MoE, dropout 0.1, remat, LM loss) and ``mc`` (the
    double head, dropout 0.1), both at ring attention's form."""
    rng = np.random.RandomState(7)
    base = dataclasses.replace(tgpt2.TINY, vocab_size=OWN_V, n_positions=OWN_T, dropout=0.1,
                               attn_impl="ring")
    if name == "moe":
        cfg = dataclasses.replace(base, moe_experts=4, remat=True)
        ids = rng.randint(0, OWN_V, (OWN_W, 2, OWN_T)).astype(np.int64)
        labels = np.where(rng.rand(OWN_W, 2, OWN_T) < 0.3, -100, ids)
        return cfg, {"input_ids": ids, "labels": labels}
    cfg = dataclasses.replace(base, with_mc_head=True)
    ids = rng.randint(1, OWN_V, (OWN_W, 2, 2, OWN_T)).astype(np.int64)
    lengths = rng.randint(OWN_T // 4, OWN_T + 1, (OWN_W, 2, 2))
    ids = np.where(np.arange(OWN_T) < lengths[..., None], ids, 0)
    labels = np.where(rng.rand(*ids.shape) < 0.5, -100, ids)
    return cfg, {"input_ids": ids, "token_type_ids": ids % 3, "labels": labels,
                 "mc_label": rng.randint(0, 2, (OWN_W, 2))}


def own_round(name, axes=None, mesh=None, rounds=2):
    """(params, Verror, metrics of the last round) after ``rounds`` rounds
    of an own case, as a FederatedSession-free engine round: one device
    (``axes`` None) or this rank's part of the mesh's seq and model
    groups (every rank runs the whole cohort: clients = 1)."""
    cfg_m, batch = own_case(name)
    model = tgpt2.GPT2LMHead(cfg_m, axes=axes)
    tgpt2.init_weights(model, 0)
    layout = convert.FlatLayout(model)
    loss = (make_lm_loss(model, train=True, moe_aux_coef=0.01) if name == "moe"
            else make_lm_mc_loss(model, True, 1.0, 0))
    cfg = engine.EngineConfig(mode=ModeConfig(d=layout.d, **OWN_MODE), weight_decay=5e-4,
                              seed=3)
    p0 = layout.flatten({k: v.detach() for k, v in model.named_parameters()})
    state = engine.init_server_state(cfg, p0, {})
    step = engine.make_round_step(loss, cfg, layout)
    b = {k: _t(v) for k, v in batch.items()}
    for lr in (0.05, 0.1)[:rounds]:
        state, _, m = step(state, b, {}, torch.tensor(lr))
    return {"params": state["params"], "Verror": state["mode_state"]["Verror"],
            "metrics": {k: float(v) for k, v in m.items()}}


@contextlib.contextmanager
def reference_init(flax_params):
    """Inside the block, ``gpt2_train``'s random init gives GPT-2 the
    parameters the reference's CLI initialises from its seed
    (``flax_params``, numpy), carried across with ``models/convert.py``."""
    orig = gpt2_train.init_weights

    def init(model, seed):
        tparams, _ = convert.params_from_flax(model, flax_params, {})
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(tparams[name])

    gpt2_train.init_weights = init
    try:
        yield
    finally:
        gpt2_train.init_weights = orig


def served_cli(argv, flax_params=None) -> dict:
    """The final params and rows of ``gpt2_train.main(argv)`` (from the
    reference's initial params when given)."""
    ctx = reference_init(flax_params) if flax_params is not None else contextlib.nullcontext()
    with ctx:
        s = gpt2_train.main(argv)
    return {"params": s.state["params"].clone(), "round": s.round}


def f1_decode(argv, flat, one_device: bool = False) -> dict:
    """What ``F1Eval`` of the CLI ``argv`` decodes from the flat params
    ``flat`` on this rank (greedy): its inputs, the decoded ids and lengths,
    its score, and the logits of the final buffers at each step's position
    [B, max_new, V] (what a causal model read at each step); with
    ``one_device`` also the ids, lengths and logits of the one-device model
    on the same params (for a seq group, the ring form)."""
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    args = resolve_defaults(make_parser("gpt2").parse_args(argv))
    _, valid_set, extras = gpt2_train.build(args)
    tok = extras["tok"]
    f1 = gpt2_train.F1Eval(args, extras["model"], tok, valid_set, torch.device("cpu"))
    params = convert.FlatLayout(extras["model"]).unflatten(flat)
    T = f1.ids.shape[1]
    steps = torch.arange(args.decode_max_new)
    pos = (f1.plen[:, None] - 1 + steps[None]).clamp(max=T - 1)
    out = {"inputs": (f1.ids.numpy(), f1.types.numpy(), f1.prompt_len), "f1": f1(params, 0)}
    models = {"group": (extras["model"], f1.generate)}
    if one_device:
        one = tgpt2.GPT2LMHead(extras["model"].cfg)
        models["one"] = (one, make_generate(one, eos_id=tok.eos_id, pad_id=tok.pad_id,
                                            reply_type_id=tok.speaker2_id,
                                            max_new=args.decode_max_new))
    for key, (model, generate) in models.items():
        with torch.no_grad():
            ids, lengths = generate(params, f1.ids, f1.types, f1.plen)
        # the final cursor: past a written <eos>, else at the length
        at = lengths.clamp(max=T - 1)
        ended = (lengths < T) & (ids[torch.arange(len(ids)), at] == tok.eos_id)
        cur = lengths + ended.long()
        cols = torch.arange(T)[None]
        types = torch.where((cols >= f1.plen[:, None]) & (cols < cur[:, None]),
                            torch.full_like(f1.types, tok.speaker2_id), f1.types)
        with torch.no_grad():
            logits = torch.stack([functional_call(
                model, params, (ids,), {"train": False, "token_type_ids": types,
                                        "logit_positions": pos[:, s]}) for s in steps], 1)
        out[key] = {"ids": ids, "lengths": lengths, "types": types, "logits": logits}
    return out


def _gather_blocks(x, axis, dim):
    """The group's blocks of ``x`` concatenated along ``dim`` (outside any
    autograd)."""
    return torch.cat(distributed.all_gather_stacked([x.detach()], axis.group)[0].unbind(), dim)


def ring_op(qkv, w, axis):
    """This group's ring attention of the whole [B, T, H, D] q, k, v (each
    rank its block), and the gradients of sum(out * w), gathered whole."""
    q, k, v = (_t(a).requires_grad_() for a in qkv)
    Tl = q.shape[1] // axis.size
    blk = [t.narrow(1, axis.index * Tl, Tl) for t in (q, k, v)]
    out = tring.ring_attention(*blk, axis)
    (out * _t(w).narrow(1, axis.index * Tl, Tl)).sum().backward()
    grads = [t.grad.narrow(1, axis.index * Tl, Tl) for t in (q, k, v)]
    return {"out": _gather_blocks(out, axis, 1),
            "grads": [_gather_blocks(g, axis, 1) for g in grads]}


def _layer_fn(p, h):
    # the reference's residual MLP block (tests/test_pipeline.py)
    return h + torch.tanh(h @ p["w"] + p["b"])


def pipe_op(layers, x, axis):
    """The pipeline over ``axis`` of the reference's toy layers [L, ...] on
    microbatches x: (output, mean(y**2), this stage's gradients)."""
    staged = pipeline.local_stage(pipeline.stack_stages(
        {k: _t(v) for k, v in layers.items()}, axis.size), axis)
    staged = {k: v.requires_grad_() for k, v in staged.items()}
    y = pipeline.pipeline_apply(pipeline.scan_stage(_layer_fn), staged, _t(x), axis)
    loss = torch.mean(y ** 2)
    loss.backward()
    return {"y": y.detach(), "loss": float(loss), "grads": {k: v.grad for k, v in staged.items()}}


def pipe_gpt2(block_params, x, axis):
    """The pipeline over ``axis`` of GPT-2 blocks (the reference's flax
    block params stacked [L, ...]) on x [M, mb, T, C]: output and this
    stage's gradients of mean(y**2), by the port's names."""
    cfg = dataclasses.replace(tgpt2.TINY, n_positions=x.shape[2], dropout=0.0)
    block = tgpt2.Block(cfg)
    L = PIPE_LAYERS
    layers = [convert.params_from_flax(
        block, {k: _index_tree(v, i) for k, v in block_params.items()}, {})[0]
        for i in range(L)]
    stacked = {n: torch.stack([lp[n] for lp in layers]) for n in layers[0]}
    staged = pipeline.local_stage(pipeline.stack_stages(stacked, axis.size), axis)
    staged = {k: v.requires_grad_() for k, v in staged.items()}

    def layer_fn(p, h):
        return functional_call(block, p, (h, None))

    y = pipeline.pipeline_apply(pipeline.scan_stage(layer_fn), staged, _t(x), axis)
    torch.mean(y ** 2).backward()
    return {"y": y.detach(), "grads": {k: v.grad for k, v in staged.items()}}


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def collectives_case(axis):
    """Every collective under ``vmap(grad(...))`` over a batch of 3 inputs,
    with what the same function computed whole on one process gives:

    - ``tp``: a replicated loss over a column-parallel product
      (copy-to-group, reduce-from-group); each rank's loss and input
      gradient are the whole function's, and its rows of the weight's;
    - ``seq``: partial losses over token blocks (shift, all_gather,
      sum_partial, stack); their sums over the ranks are the whole's;
    - ``bcast``: a replicated loss of the last rank's block
      (broadcast_from); the ranks' input gradients sum to the whole's."""
    S, r = axis.size, axis.index
    g = torch.Generator().manual_seed(0)
    w = torch.randn(2 * S, 3, generator=g)  # column-parallel rows, 2 a rank
    xs = torch.randn(3, 2 * S, 3, generator=g)  # [C, T, 3], a block of 2 rows a rank
    a, b = torch.randn(2 * S, 3, generator=g), torch.randn(S, 2 * S, 3, generator=g)
    blocks = slice(2 * r, 2 * r + 2)

    def tp(w, x):
        h = coll.copy_to_group(x, axis)
        return coll.reduce_from_group(torch.tanh(h @ w[blocks].T).sum(), axis)

    def tp_whole(w, x):
        return torch.tanh(x @ w.T).sum()

    def seq(x):
        xb = x[blocks]
        prev = coll.shift(xb, axis)
        full = coll.all_gather(xb, axis, 0)
        sq = coll.sum_partial((xb ** 2).sum(), axis)
        return (xb * prev * a[blocks]).sum() + (full * b[r]).sum() + sq * float(r + 1) \
            + (coll.stack(xb.sum(0), axis) ** 2).sum()

    def seq_whole(x):
        xb = x.reshape(S, 2, 3)
        prev = torch.roll(xb, 1, 0)
        return sum((xb[q] * prev[q] * a[2 * q:2 * q + 2]).sum() + (x * b[q]).sum()
                   + (x ** 2).sum() * float(q + 1) + (xb.sum(1) ** 2).sum() for q in range(S))

    def bcast(x):
        return (coll.broadcast_from(x[blocks] * float(r + 1), axis, S - 1) ** 2).sum()

    def bcast_whole(x):
        return ((x[2 * S - 2:] * float(S)) ** 2).sum()

    def both(f, *args, argnums=0):
        dims = (None,) * (len(args) - 1) + (0,)
        return (torch.func.vmap(f, in_dims=dims)(*args),
                torch.func.vmap(torch.func.grad(f, argnums=argnums), in_dims=dims)(*args))

    (tv, (tgw, tgx)), (wv, (wgw, wgx)) = (both(f, w, xs, argnums=(0, 1))
                                          for f in (tp, tp_whole))
    (sv, sgx), (swv, swgx) = both(seq, xs), both(seq_whole, xs)
    (bv, bgx), (bwv, bwgx) = both(bcast, xs), both(bcast_whole, xs)
    return {"tp": (tv, tgx, tgw[:, blocks], tgw.sum() - tgw[:, blocks].sum()),
            "tp_want": (wv, wgx, wgw[:, blocks]),
            "seq": (coll.reduce_from_group(sv.detach(), axis),
                    coll.reduce_from_group(sgx.detach(), axis)),
            "seq_want": (swv, swgx),
            "bcast": (bv, coll.reduce_from_group(bgx.detach(), axis)),
            "bcast_want": (bwv, bwgx)}


def _mesh_axes(mesh):
    distributed.join_mesh(mesh)
    return distributed.parallel_axes()


def ranks_2(out_dir, ref):
    """Rank function of the 2-rank launch: the collectives, TP on model=2,
    ring attention and rounds on seq=2, the pipeline at S = 2 and the CLI
    with each flag."""
    distributed.initialize(force=True, device="cpu")
    torch.set_num_threads(1)
    rank = dist.get_rank()
    world = coll.Axis(dist.group.WORLD, 2, rank)
    got = {"collectives": collectives_case(world),
           "ring_op": ring_op(ref["qkv"], ref["qkv_w"], world),
           "pipe": pipe_op(ref["layers"], ref["pipe_x"], world)}
    axes = _mesh_axes(ClientMesh(clients=1, model=2))
    got["tp"] = tp_round(ref["tp_params"], ref["tp_ids"], axes)
    got["tp_fedavg"] = tp_round(ref["tp_params"], ref["tp_ids"], axes, mode=FEDAVG_MODE)
    axes = _mesh_axes(ClientMesh(clients=1, seq=2))
    got["ring_round"] = ring_round(ref["ring_params"], ref["ring_batch"], "ring", axes)
    got["own_mc"] = own_round("mc", axes)
    got["own_moe"] = own_round("moe", axes)
    for name, flags in (("cli_tp", ["--model_parallel", "2"]),
                        ("cli_ring", ["--seq_parallel", "2", "--attn_impl", "ring"])):
        rows = os.path.join(out_dir, f"{name}.jsonl")
        s = gpt2_train.main(CLI_ARGS + flags + ["--log_jsonl", rows])
        got[name] = {"params": s.state["params"], "axes": s.train_loss_fn.parallel is not None}
    got.update(eval_and_serve_runs(out_dir, ref))
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


def eval_and_serve_runs(out_dir, ref) -> dict:
    """--eval_f1 and --serve on model = 2 and on seq = 2: the CLI's F1 run
    on each group and its decode of the final params (the seq group's
    beside the one-device ring form), the served runs of ``SERVED`` on
    each group and of ``SERVED_TP`` on the model group, and the pipelined
    run with an eval and a decode at every round, all from the
    reference's initial params."""
    got = {}
    for mesh, flags in (("tp", TP_FLAGS), ("seq", SEQ_FLAGS)):
        rows = os.path.join(out_dir, f"f1_{mesh}.jsonl")
        s = gpt2_train.main(CLI_ARGS + flags + F1_FLAGS + ["--log_jsonl", rows])
        got[f"f1_{mesh}"] = {"params": s.state["params"].clone(), **f1_decode(
            CLI_ARGS + flags + F1_FLAGS, s.state["params"], one_device=mesh == "seq")}
        served = dict(SERVED, **SERVED_TP) if mesh == "tp" else SERVED
        for name, serve in served.items():
            got[f"serve_{mesh}_{name}"] = served_cli(CLI_ARGS + flags + serve, ref["cli_params"])
    got["serve_tp_overlap"] = served_cli(
        CLI_ARGS + TP_FLAGS + OVERLAP_FLAGS + ["--log_jsonl",
                                               os.path.join(out_dir, "overlap.jsonl")],
        ref["cli_params"])
    return got


def ranks_4(out_dir, ref):
    """Rank function of the 4-rank launch: TP on clients=2 x model=2 (the
    sharded round), seq x model = 2 x 2 with the MoE and remat, ring
    attention and the pipeline at S = 4, and the GPT-2 blocks' pipeline."""
    distributed.initialize(force=True, device="cpu")
    torch.set_num_threads(1)
    rank = dist.get_rank()
    world = coll.Axis(dist.group.WORLD, 4, rank)
    got = {"ring_op": ring_op(ref["qkv"], ref["qkv_w"], world),
           "pipe": pipe_op(ref["layers"], ref["pipe_x"], world),
           "pipe_one": pipe_op(ref["layers"], ref["pipe_x"][:1], world),
           "pipe_uneven": pipe_op(ref["layers"], ref["pipe_x"][:3], world),
           "pipe_gpt2": pipe_gpt2(ref["blocks"], ref["blocks_x"], world)}
    mesh = ClientMesh(clients=2, model=2)
    axes = _mesh_axes(mesh)
    got["tp"] = tp_round(ref["tp_params"], ref["tp_ids"], axes,
                         distributed.axis_group("clients"), mesh.shard_index(rank), 2)
    axes = _mesh_axes(ClientMesh(clients=1, seq=2, model=2))
    got["own_moe"] = own_round("moe", axes)
    got["own_mc"] = own_round("mc", axes, rounds=1)
    # the CLI on clients=2 x model=2 in a mode with client state (its rows
    # split over the client groups, gathered to rank 0 for the checkpoint)
    s = gpt2_train.main(CLI_ARGS + LOCAL_TOPK + [
        "--mesh", "clients=2", "--model_parallel", "2", "--checkpoint_dir",
        os.path.join(out_dir, "ckpt"), "--log_jsonl", os.path.join(out_dir, "local_topk.jsonl")])
    got["cli_local_topk"] = {"params": s.state["params"], "client_block": s.client_block,
                             "rows": {k: v.clone() for k, v in s.client_state.items()}}
    # the served payload round on clients=2 x model=2: the client step's
    # gather on the serve cycle's client-axis group
    got["serve_clients_tp"] = served_cli(CLI_ARGS + SKETCH_SERVE + [
        "--mesh", "clients=2", "--model_parallel", "2"])
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()
