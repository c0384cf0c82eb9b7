"""The port's parallelism on two gloo ranks on the CPU (one
``launch_local`` of ``test_torch_parallel_ranks.ranks_2``), held against
the JAX package and against the port's one-device runs:

- every collective under ``vmap(grad(...))``: tensor-parallel values and
  gradients equal the whole function's on each rank, sequence-parallel
  and broadcast ones sum over the ranks to the whole function's (rtol
  1e-5);
- ``ring_attention`` at S = 2 against the reference's ring and its
  ``_dense_causal``, output and gradients (rtol 2e-4 / atol 2e-4);
- the reference's TP round (sketch, 2 rounds) at model = 2 against the
  reference's unsharded and ``clients=4 x model=2`` rounds on the
  8-device CPU mesh and against the port's one-device round (rtol 2e-4 /
  atol 2e-5); the two ranks bitwise;
- fedavg at model = 2 (2 local steps) against the port's one-device
  run, the ranks bitwise;
- the reference's ring-in-a-round setup at seq = 2 against the
  reference's dense round (rtol 2e-4 / atol 2e-5);
- the mixture of experts with remat and the double head, dropout 0.1, at
  seq = 2 against the port's one-device ring form (rtol 2e-4 / atol 2e-5;
  the same masks on every rank), ranks bitwise;
- the GPipe op at S = 2 against the reference's pipeline;
- ``gpt2_train.main`` with ``--model_parallel 2`` and with
  ``--seq_parallel 2 --attn_impl ring``: rows within rtol 1e-4 of the
  one-device CLI's, the ranks' params bitwise;
- ``--eval_f1`` on model = 2 (greedy): the decode of the run's final
  params against the reference's ``make_f1_eval`` on the CPU mesh with
  model = 2 (its inputs and ids exact, the step logits within rtol 2e-4 /
  atol 2e-5, the score equal to the logged ``val_f1``), the ranks
  bitwise; on seq = 2 bitwise the port's one-device ring-form decode and
  against the reference's unsharded ``make_f1_eval`` with ring attention
  (its ``_dense_causal``): ids exact, logits within 1e-5;
- ``--serve inproc`` with the sketch and the announce payload, serial and
  ``--serve_pipeline``, on model = 2 and on seq = 2, and the buffered-async
  service, the fast path, the edge tree and process shards behind the
  socket on model = 2, from the reference's initial params: the ranks and
  pipelined and serial bitwise, the params within
  rtol 2e-4 / atol 2e-5 of the port's one-device served run and, on
  model = 2, of the reference's served CLI run on its CPU mesh;
- a pipelined served run on model = 2 with an eval and an F1 decode at
  every round ends, bitwise its serial twin."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh

import gpt2_train as jg2
from commefficient_tpu.data import personachat as jpc
from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models import generate as jgen
from commefficient_tpu.models import gpt2 as jgpt2
from commefficient_tpu.models.losses import make_lm_loss as jloss
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu.ops import pipeline as jpipe
from commefficient_tpu.ops import ring_attention as jring
from commefficient_tpu.parallel import mesh as jmesh
from commefficient_tpu.parallel import tp as jtp
from commefficient_tpu_torch import gpt2_train as tg2
from commefficient_tpu_torch.parallel import distributed
import test_torch_parallel_ranks as R

torch.set_num_threads(2)
WORLD = 2


def tree_np(t):
    return jax.tree.map(np.asarray, t)


def ref_inputs():
    """The reference's inputs of every case, as numpy."""
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    qkv = [np.asarray(jax.random.normal(k, (2, 64, 4, 16), jnp.float32)) for k in ks[:3]]
    qkv_w = np.asarray(jax.random.normal(ks[3], (2, 64, 4, 16), jnp.float32))
    L, d = R.PIPE_LAYERS, 8
    lk = jax.random.split(jax.random.PRNGKey(2), L)
    layers = {"w": np.asarray(jnp.stack([0.1 * jax.random.normal(k, (d, d)) for k in lk])),
              "b": np.zeros((L, d), np.float32)}
    pipe_x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (6, 2, d)))
    cfg_tp = dataclasses.replace(jgpt2.TINY, n_positions=R.TP_T, dropout=0.0)
    tp_params = tree_np(jgpt2.GPT2LMHead(cfg_tp).init(
        jax.random.PRNGKey(0), jnp.zeros((1, R.TP_T), jnp.int32), train=False)["params"])
    tp_ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (R.TP_W, 2, R.TP_T), 0,
                                           cfg_tp.vocab_size, jnp.int32))
    T = R.RING_T
    ring_batch = {
        "input_ids": np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 2, T), 0, 512)),
        "labels": np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 2, T), 0, 512)),
        "mask": np.ones((2, 2, T), np.float32)}
    cfg_ring = dataclasses.replace(jgpt2.TINY, n_positions=T)
    ring_params = tree_np(jgpt2.GPT2LMHead(cfg_ring).init(
        jax.random.PRNGKey(1), jnp.zeros((1, T), jnp.int32), train=False)["params"])
    # the reference CLI's initial GPT-2 at R.CLI_ARGS (its seed 42, the
    # byte tokenizer's vocabulary)
    cfg_cli = dataclasses.replace(jgpt2.TINY, vocab_size=R.OWN_V, n_positions=32)
    cli_params = tree_np(jgpt2.GPT2LMHead(cfg_cli).init(
        jax.random.PRNGKey(42), jnp.zeros((1, 32), jnp.int32), train=False)["params"])
    return {"qkv": qkv, "qkv_w": qkv_w, "layers": layers, "pipe_x": pipe_x,
            "tp_params": tp_params, "tp_ids": tp_ids, "ring_batch": ring_batch,
            "ring_params": ring_params, "cli_params": cli_params}


def ref_argv(flags):
    """R.CLI_ARGS and ``flags`` for the reference's CLI (which has no
    --device)."""
    i = R.CLI_ARGS.index("--device")
    return R.CLI_ARGS[:i] + R.CLI_ARGS[i + 2:] + flags


def ref_decode(ref, flat, flags, model_parallel, final):
    """The reference's F1 decode of the port's flat params (unravelled in
    ``ravel_pytree`` order, sharded by ``tp.shard_params`` on a clients=1 x
    model=2 CPU mesh when ``model_parallel``): ``make_f1_eval``'s score at
    round 2, the inputs, ids and lengths its generate saw and returned
    (recorded), and the logits of the port's ``final`` buffers at each
    step's position."""
    args = jg2.resolve_defaults(jg2.make_parser("gpt2").parse_args(ref_argv(flags)))
    _, valid, tok = jpc.load_personachat_fed(args.data_root, args.num_clients, args.seq_len,
                                             args.seed)
    cfg = dataclasses.replace(jgpt2.TINY, vocab_size=tok.vocab_size, n_positions=args.seq_len,
                              attn_impl=args.attn_impl)
    model = jgpt2.GPT2LMHead(cfg)
    params = ravel_pytree(ref["cli_params"])[1](jnp.asarray(flat.numpy()))
    if model_parallel:
        params = jtp.shard_params(jmesh.make_mesh(2, model_parallel=2), params)
    seen, real = {}, jgen.make_generate

    def recording(*a, **kw):
        generate = real(*a, **kw)

        def run(*args):
            seen["inputs"] = [np.asarray(x) for x in args[1:4]]
            seen["out"] = [np.asarray(x) for x in generate(*args)]
            return seen["out"]

        return run

    jgen.make_generate = recording
    try:
        f1 = jg2.make_f1_eval(args, model, tok, valid)(params, 2)
    finally:
        jgen.make_generate = real
    step = jax.jit(lambda p, i, t, pos: model.apply(
        {"params": p}, i, train=False, token_type_ids=t, logit_positions=pos))
    ids, types = (jnp.asarray(final[k].numpy()) for k in ("ids", "types"))
    T = ids.shape[1]
    plen = seen["inputs"][2]
    logits = np.stack([np.asarray(step(params, ids, types, np.minimum(plen - 1 + s, T - 1)))
                       for s in range(args.decode_max_new)], 1)
    return {"f1": f1, "inputs": seen["inputs"], "ids": seen["out"][0],
            "lengths": seen["out"][1], "logits": logits}


def ref_ring_op(ref, n):
    """The reference's ring attention over an n-device seq mesh and its
    dense attention: outputs and the gradients of sum(out * w)."""
    q, k, v = (jnp.asarray(a) for a in ref["qkv"])
    w = jnp.asarray(ref["qkv_w"])
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))

    def loss(fn, q, k, v):
        return jnp.sum(fn(q, k, v) * w)

    def ring(q, k, v):
        return jring.ring_attention(q, k, v, mesh=mesh)

    out = {}
    for name, fn in (("ring", ring), ("dense", jring._dense_causal)):
        out[name] = (np.asarray(jax.jit(fn)(q, k, v)),
                     [np.asarray(g) for g in jax.jit(jax.grad(
                         lambda q, k, v: loss(fn, q, k, v), argnums=(0, 1, 2)))(q, k, v)])
    return out


def ref_tp_round(ref, model_parallel):
    """The reference's TP round: new flat params and each round's
    loss_sum, unsharded (model_parallel 0) or on clients=4 x model=2."""
    cfg_m = dataclasses.replace(jgpt2.TINY, n_positions=R.TP_T, dropout=0.0)
    model = jgpt2.GPT2LMHead(cfg_m)
    params = jax.tree.map(jnp.asarray, ref["tp_params"])
    d = ravel_pytree(params)[0].size
    cfg = jengine.EngineConfig(mode=JModeConfig(d=d, **R.TP_MODE), weight_decay=R.TP_WD)
    batch = {"input_ids": jnp.asarray(ref["tp_ids"]), "labels": jnp.asarray(ref["tp_ids"])}
    if model_parallel:
        mesh = jmesh.make_mesh(8, model_parallel=model_parallel)
        params = jtp.shard_params(mesh, params)
        batch = jax.device_put(batch, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(jmesh.CLIENT_AXIS)))
    state = jengine.init_server_state(cfg, params, {})
    step = jax.jit(jengine.make_round_step(jloss(model, train=True), cfg))
    sums = []
    for i in range(R.TP_ROUNDS):
        state, _, m = step(state, batch, {}, jnp.float32(R.TP_LR), jax.random.PRNGKey(i))
        sums.append(float(m["loss_sum"]))
    return np.asarray(ravel_pytree(state["params"])[0]), sums


def ref_ring_round(ref):
    """The reference's dense round of the ring-in-a-round setup."""
    cfg_m = dataclasses.replace(jgpt2.TINY, n_positions=R.RING_T)
    model = jgpt2.GPT2LMHead(cfg_m)
    params = jax.tree.map(jnp.asarray, ref["ring_params"])
    d = ravel_pytree(params)[0].size
    ecfg = jengine.EngineConfig(mode=JModeConfig(d=d, **R.RING_MODE))
    state = jengine.init_server_state(ecfg, params, {})
    step = jax.jit(jengine.make_round_step(jloss(model, train=True), ecfg))
    new, _, _ = step(state, jax.tree.map(jnp.asarray, ref["ring_batch"]), {},
                     jnp.float32(R.RING_LR), jax.random.PRNGKey(2))
    return np.asarray(ravel_pytree(new["params"])[0])


def ref_pipe(ref, S, M=None):
    """The reference's pipeline over S stages: y, mean(y**2), staged grads."""
    layers = jax.tree.map(jnp.asarray, ref["layers"])
    x = jnp.asarray(ref["pipe_x"][:M])
    mesh = Mesh(np.array(jax.devices()[:S]), ("pipe",))
    staged = jpipe.stack_stages(layers, S)

    def layer_fn(p, h):
        return h + jnp.tanh(h @ p["w"] + p["b"])

    def loss(p):
        y = jpipe.pipeline_apply(jpipe.scan_stage(layer_fn), p, x, mesh=mesh)
        return jnp.mean(y ** 2), y

    (val, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(staged)
    return np.asarray(y), float(val), tree_np(g)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("par2")
    ref = ref_inputs()
    codes = distributed.launch_local(R.ranks_2, WORLD, args=(str(out), ref), timeout_s=600)
    assert codes == [0] * WORLD, codes
    got = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    return ref, got, out


def _close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=msg)


def test_collectives_under_vmap_grad(run):
    _, got, _ = run
    for g in got:
        for have, want in zip(g["collectives"]["tp"][:3], g["collectives"]["tp_want"]):
            _close(have, want, 1e-5, 1e-6)
        assert float(g["collectives"]["tp"][3]) == 0.0  # other ranks' rows get nothing
        for key in ("seq", "bcast"):
            for have, want in zip(g["collectives"][key], g["collectives"][f"{key}_want"]):
                _close(have, want, 1e-5, 1e-6, key)


def test_ring_attention_matches_reference(run):
    ref, got, _ = run
    want = ref_ring_op(ref, WORLD)
    for g in got:
        for name in ("ring", "dense"):
            out, grads = want[name]
            _close(g["ring_op"]["out"], out, 2e-4, 2e-4, name)
            for have, w in zip(g["ring_op"]["grads"], grads):
                _close(have, w, 2e-4, 2e-4, name)


def test_tp_round_matches_reference_and_one_device(run):
    ref, got, _ = run
    assert torch.equal(got[0]["tp"]["params"], got[1]["tp"]["params"])
    one = R.tp_round(ref["tp_params"], ref["tp_ids"])
    _close(got[0]["tp"]["params"], one["params"], 2e-4, 2e-5)
    for mp in (0, 2):
        params, sums = ref_tp_round(ref, mp)
        _close(got[0]["tp"]["params"], params, 2e-4, 2e-5, f"reference mp={mp}")
        _close(got[0]["tp"]["loss_sum"], sums, 1e-5, 0.0)


def test_tp_fedavg_matches_one_device(run):
    """fedavg under tensor parallelism rebuilds the full update after each
    of its 2 local steps: the ranks bitwise, the one-device run within
    rtol 2e-4 / atol 2e-5."""
    ref, got, _ = run
    assert torch.equal(got[0]["tp_fedavg"]["params"], got[1]["tp_fedavg"]["params"])
    one = R.tp_round(ref["tp_params"], ref["tp_ids"], mode=R.FEDAVG_MODE)
    _close(got[0]["tp_fedavg"]["params"], one["params"], 2e-4, 2e-5)
    _close(got[0]["tp_fedavg"]["loss_sum"], one["loss_sum"], 1e-5, 0.0)


def test_ring_round_matches_reference_dense(run):
    ref, got, _ = run
    assert torch.equal(got[0]["ring_round"]["params"], got[1]["ring_round"]["params"])
    _close(got[0]["ring_round"]["params"], ref_ring_round(ref), 2e-4, 2e-5)


@pytest.mark.parametrize("case", ["own_moe", "own_mc"])
def test_seq_group_matches_one_device(run, case):
    """MoE (tokens gathered, aux counted once) with remat, and the double
    head (the mc score from the rank that holds the position), dropout 0.1
    with the masks sliced by token."""
    _, got, _ = run
    assert torch.equal(got[0][case]["params"], got[1][case]["params"])
    one = R.own_round(case[4:])
    _close(got[0][case]["params"], one["params"], 2e-4, 2e-5)
    _close(got[0][case]["Verror"], one["Verror"], 2e-4, 2e-6)
    for k, v in one["metrics"].items():
        _close(got[0][case]["metrics"][k], v, 1e-4, 1e-6, k)


def test_pipeline_two_stages_matches_reference(run):
    ref, got, _ = run
    y, val, g_ref = ref_pipe(ref, WORLD)
    for r, g in enumerate(got):
        _close(g["pipe"]["y"], y, 1e-5, 1e-6)
        _close(g["pipe"]["loss"], val, 1e-6, 0.0)
        for k in ("w", "b"):
            _close(g["pipe"]["grads"][k][0], g_ref[k][r], 1e-5, 1e-6, k)


@pytest.mark.parametrize("name,flags", [("cli_tp", ["--model_parallel", "2"]),
                                        ("cli_ring", ["--seq_parallel", "2", "--attn_impl",
                                                      "ring"])])
def test_cli_runs_each_flag(run, name, flags, tmp_path):
    """The port's gpt2_train on 2 ranks with the flag against the one-device
    CLI (dense attention; TINY's dropout is 0): every row value within rtol
    1e-4 but time_s, the ranks' params bitwise."""
    _, got, out = run
    assert got[0][name]["axes"] and got[1][name]["axes"]
    assert torch.equal(got[0][name]["params"], got[1][name]["params"])
    rows = str(tmp_path / "one.jsonl")
    tg2.main(R.CLI_ARGS + ["--log_jsonl", rows])
    want = [json.loads(x) for x in open(rows)]
    have = [json.loads(x) for x in open(os.path.join(out, f"{name}.jsonl"))]
    assert len(have) == len(want) == 1
    for k, v in want[0].items():
        if k != "time_s":
            _close(have[0][k], v, 1e-4, 1e-6, k)


@pytest.fixture(scope="module")
def twins(run):
    """The port's one-device served runs of R.SERVED and R.SERVED_TP from
    the reference's initial params (dense attention: the seq runs' twin
    too)."""
    ref = run[0]
    return {name: R.served_cli(R.CLI_ARGS + flags, ref["cli_params"])["params"]
            for name, flags in {**R.SERVED, **R.SERVED_TP}.items() if not name.endswith("_pipe")}


def _rows(out, name):
    return [json.loads(x) for x in open(os.path.join(out, f"{name}.jsonl"))]


def _same_decode(a, b):
    for k in ("ids", "lengths", "types", "logits"):
        assert torch.equal(a[k], b[k]), k


def _against_reference(have, want, logit_rtol, logit_atol):
    for h, w in zip(have["inputs"], want["inputs"]):
        np.testing.assert_array_equal(np.asarray(h), w)
    np.testing.assert_array_equal(have["group"]["ids"].numpy(), want["ids"])
    np.testing.assert_array_equal(have["group"]["lengths"].numpy(), want["lengths"])
    _close(have["group"]["logits"], want["logits"], logit_rtol, logit_atol)
    assert have["f1"] == want["f1"]


def test_f1_decode_on_model_group_matches_reference(run):
    """(i): every rank decodes in lockstep, bitwise alike; the logged
    val_f1 is the decode's score; the reference on its model = 2 mesh
    decodes the same ids from the same inputs."""
    ref, got, out = run
    have = got[0]["f1_tp"]
    _same_decode(have["group"], got[1]["f1_tp"]["group"])
    assert have["f1"] == got[1]["f1_tp"]["f1"] == _rows(out, "f1_tp")[-1]["val_f1"]
    assert (have["group"]["lengths"] > torch.from_numpy(have["inputs"][2])).any()
    want = ref_decode(ref, have["params"], R.TP_FLAGS + R.F1_FLAGS, True, have["group"])
    _against_reference(have, want, 2e-4, 2e-5)


def test_f1_decode_on_seq_group_matches_one_device_and_reference(run):
    """(ii): on seq = 2 each rank decodes whole rows, bitwise the
    one-device ring form (``_dense_causal``) and the other rank; the
    reference's unsharded decode with ring attention within 1e-5."""
    ref, got, out = run
    have = got[0]["f1_seq"]
    _same_decode(have["group"], got[1]["f1_seq"]["group"])
    _same_decode(have["group"], have["one"])
    assert have["f1"] == _rows(out, "f1_seq")[-1]["val_f1"]
    want = ref_decode(ref, have["params"], R.SEQ_FLAGS + R.F1_FLAGS, False, have["group"])
    _against_reference(have, want, 1e-5, 1e-5)


@pytest.mark.parametrize("payload", ["sketch", "announce"])
@pytest.mark.parametrize("mesh", ["tp", "seq"])
def test_served_group_matches_one_device(run, twins, mesh, payload):
    """(iii): a served run on a model or seq group: the ranks, and
    pipelined and serial, bitwise; the one-device served run within rtol
    2e-4 / atol 2e-5."""
    _, got, _ = run
    serial, piped = f"serve_{mesh}_{payload}", f"serve_{mesh}_{payload}_pipe"
    want = got[0][serial]["params"]
    for g in got:
        assert g[serial]["round"] == g[piped]["round"] == 2
        assert torch.equal(g[serial]["params"], want)
        assert torch.equal(g[piped]["params"], want)
    _close(want, twins[payload], 2e-4, 2e-5)


def test_served_model_group_matches_reference(run):
    """(iii): the payload round on model = 2 against the reference's
    served CLI on its clients=1 x model=2 CPU mesh, from the same initial
    params."""
    _, got, _ = run
    s = jg2.main(ref_argv(R.TP_FLAGS + ["--num_devices", "2"] + R.SKETCH_SERVE))
    _close(got[0]["serve_tp_sketch"]["params"],
           np.asarray(ravel_pytree(jax.device_get(s.state["params"]))[0]), 2e-4, 2e-5)


def test_pipelined_served_eval_every_round_finishes(run):
    """(iv): the worker's client step on the serve cycle's groups beside
    the main thread's eval and F1 decode at every round: the run ends with
    a row a round, bitwise its serial twin (an eval changes no state)."""
    _, got, out = run
    rows = _rows(out, "overlap")
    assert [r["round"] for r in rows] == [1, 2] and all("val_f1" in r for r in rows)
    for g in got:
        assert g["serve_tp_overlap"]["round"] == 2
        assert torch.equal(g["serve_tp_overlap"]["params"], got[0]["serve_tp_sketch"]["params"])


@pytest.mark.parametrize("name", sorted(R.SERVED_TP))
def test_served_variants_on_model_group(run, twins, name):
    """The buffered-async service, the fast path (its ring upload), the
    edge tree (its partials in rank 0's broadcast) and process shards
    (rank 0's ingest) on model = 2, the same client step: the ranks
    bitwise, the one-device twin within rtol 2e-4 / atol 2e-5."""
    _, got, _ = run
    key = f"serve_tp_{name}"
    assert got[0][key]["round"] == 2
    assert torch.equal(got[0][key]["params"], got[1][key]["params"])
    _close(got[0][key]["params"], twins[name], 2e-4, 2e-5)
