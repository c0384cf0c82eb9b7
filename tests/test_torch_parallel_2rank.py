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
  one-device CLI's, the ranks' params bitwise."""

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

from commefficient_tpu.federated import engine as jengine
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
    return {"qkv": qkv, "qkv_w": qkv_w, "layers": layers, "pipe_x": pipe_x,
            "tp_params": tp_params, "tp_ids": tp_ids, "ring_batch": ring_batch,
            "ring_params": ring_params}


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
