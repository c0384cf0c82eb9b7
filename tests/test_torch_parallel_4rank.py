"""The port's parallelism on four gloo ranks on the CPU (one
``launch_local`` of ``test_torch_parallel_ranks.ranks_4``):

- the reference's TP round on ``clients=2 x model=2`` (the sharded round
  on each model coordinate's client group) against the reference's
  ``clients=4 x model=2`` round on the 8-device CPU mesh and against the
  port's one-device round (rtol 2e-4 / atol 2e-5); all four ranks
  bitwise;
- ``seq x model = 2 x 2``: the mixture of experts with remat and the
  double head, dropout 0.1, ring attention over the seq groups and the
  heads, hidden units and experts split over the model groups, against
  the port's one-device ring form (rtol 2e-4 / atol 2e-5); all ranks
  bitwise;
- ``ring_attention`` at S = 4 against the reference's ring and dense
  attention (rtol 2e-4 / atol 2e-4);
- the GPipe op at S = 4 against the reference's ``pipeline_apply``:
  forward and backward at M = 6, one microbatch, M = 3 (not a multiple of
  S), and over GPT-2 blocks (rtol 2e-4 / atol 2e-5), each stage's
  gradients equal to the reference's slice of that stage;
- ``gpt2_train.main`` in local_topk (client state) on ``--mesh clients=2
  --model_parallel 2``: every rank's params bitwise, each model pair's
  client rows bitwise, the params within rtol 1e-4 of the one-device
  CLI's, and rank 0's checkpoint holding every client's rows;
- ``--serve inproc --serve_payload sketch`` on ``--mesh clients=2
  --model_parallel 2`` (the client step's gather on the serve cycle's
  client-axis group, its model on the serve cycle's model groups): every
  rank's params bitwise, within rtol 2e-4 / atol 2e-5 of the one-device
  served run."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from commefficient_tpu.models import gpt2 as jgpt2
from commefficient_tpu.ops import pipeline as jpipe
from commefficient_tpu_torch.parallel import distributed
import test_torch_parallel_2rank as P2
import test_torch_parallel_ranks as R

torch.set_num_threads(2)
WORLD = 4


def ref_inputs():
    """P2's inputs plus the reference's GPT-2 blocks for the pipeline."""
    ref = P2.ref_inputs()
    cfg = dataclasses.replace(jgpt2.TINY, n_positions=16, dropout=0.0)
    block = jgpt2.Block(cfg)
    x0 = jnp.zeros((2, 16, cfg.n_embd))
    keys = jax.random.split(jax.random.PRNGKey(0), R.PIPE_LAYERS)
    ref["blocks"] = P2.tree_np(jax.vmap(lambda k: block.init(k, x0, False)["params"])(keys))
    ref["blocks_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                   (3, 2, 16, cfg.n_embd)))
    return ref


def ref_pipe_gpt2(ref):
    cfg = dataclasses.replace(jgpt2.TINY, n_positions=16, dropout=0.0)
    block = jgpt2.Block(cfg)
    params = jax.tree.map(jnp.asarray, ref["blocks"])
    x = jnp.asarray(ref["blocks_x"])
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("pipe",))

    def layer_fn(p, h):
        return block.apply({"params": p}, h, False)

    def loss(p):
        y = jpipe.pipeline_apply(jpipe.scan_stage(layer_fn), p, x, mesh=mesh)
        return jnp.mean(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jpipe.stack_stages(params, WORLD))
    return np.asarray(y), P2.tree_np(g)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("par4")
    ref = ref_inputs()
    codes = distributed.launch_local(R.ranks_4, WORLD, args=(str(out), ref), timeout_s=600)
    assert codes == [0] * WORLD, codes
    got = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    return ref, got, out


def _close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=msg)


def test_tp_clients_by_model_matches_reference_and_one_device(run):
    ref, got, _ = run
    for g in got[1:]:
        assert torch.equal(g["tp"]["params"], got[0]["tp"]["params"])
    one = R.tp_round(ref["tp_params"], ref["tp_ids"])
    _close(got[0]["tp"]["params"], one["params"], 2e-4, 2e-5)
    params, sums = P2.ref_tp_round(ref, 2)
    _close(got[0]["tp"]["params"], params, 2e-4, 2e-5)
    _close(got[0]["tp"]["loss_sum"], sums, 1e-5, 0.0)


@pytest.mark.parametrize("case", ["own_moe", "own_mc"])
def test_seq_by_model_matches_one_device(run, case):
    _, got, _ = run
    for g in got[1:]:
        assert torch.equal(g[case]["params"], got[0][case]["params"])
        assert torch.equal(g[case]["Verror"], got[0][case]["Verror"])
    one = R.own_round(case[4:], rounds=2 if case == "own_moe" else 1)
    _close(got[0][case]["params"], one["params"], 2e-4, 2e-5)
    _close(got[0][case]["Verror"], one["Verror"], 2e-4, 2e-6)
    for k, v in one["metrics"].items():
        _close(got[0][case]["metrics"][k], v, 1e-4, 1e-6, k)


def test_ring_attention_four_ranks_matches_reference(run):
    ref, got, _ = run
    want = P2.ref_ring_op(ref, WORLD)
    for g in got:
        for name in ("ring", "dense"):
            out, grads = want[name]
            _close(g["ring_op"]["out"], out, 2e-4, 2e-4, name)
            for have, w in zip(g["ring_op"]["grads"], grads):
                _close(have, w, 2e-4, 2e-4, name)


@pytest.mark.parametrize("case,M", [("pipe", None), ("pipe_one", 1), ("pipe_uneven", 3)])
def test_pipeline_four_stages_matches_reference(run, case, M):
    ref, got, _ = run
    y, val, g_ref = P2.ref_pipe(ref, WORLD, M)
    for r, g in enumerate(got):
        _close(g[case]["y"], y, 1e-5, 1e-6)
        _close(g[case]["loss"], val, 1e-6, 0.0)
        for k in ("w", "b"):
            _close(g[case]["grads"][k][0], g_ref[k][r], 1e-5, 1e-6, k)


def test_pipeline_gpt2_blocks_match_reference(run):
    from commefficient_tpu_torch.models import convert

    ref, got, _ = run
    y, g_ref = ref_pipe_gpt2(ref)
    for r, g in enumerate(got):
        _close(g["pipe_gpt2"]["y"], y, 2e-4, 2e-5)
        for name, grad in g["pipe_gpt2"]["grads"].items():
            want = g_ref
            for key in convert.flax_path(name):
                want = want[key]
            want = np.asarray(want)[r]  # [1, ...] stage slice, flax layout
            have = grad[0].numpy()  # [L / S, ...] of this stage
            if have.ndim == 3:  # a linear weight [1, out, in] -> flax [1, in, out]
                have = have.transpose(0, 2, 1)
            _close(have, want, 2e-4, 2e-5, name)


def test_pipeline_refuses_like_the_reference():
    """No microbatch, an unstaged per-layer stack, and layers that do not
    split into the stages raise with the reference's words."""
    from commefficient_tpu_torch.ops import pipeline
    from commefficient_tpu_torch.parallel.collectives import Axis

    axis = Axis(None, 2, 0)
    layers = {"w": torch.zeros(4, 3, 3)}
    with pytest.raises(ValueError, match="need at least one microbatch"):
        pipeline.pipeline_apply(lambda p, h: h, pipeline.local_stage(
            pipeline.stack_stages(layers, 2), axis), torch.zeros(0, 2, 3), axis)
    with pytest.raises(ValueError, match="leading axis .* stack_stages"):
        pipeline.pipeline_apply(lambda p, h: h, layers, torch.zeros(2, 2, 3), axis)
    with pytest.raises(ValueError, match="4 layers not divisible by 3 stages"):
        pipeline.stack_stages(layers, 3)
    with pytest.raises(ValueError, match="4 layers not divisible by 3 stages"):
        jpipe.stack_stages({"w": jnp.zeros((4, 3, 3))}, 3)


def test_cli_local_topk_on_clients_by_model(run, tmp_path):
    from commefficient_tpu_torch import gpt2_train

    _, got, out = run
    cli = [g["cli_local_topk"] for g in got]
    for g in cli[1:]:
        assert torch.equal(g["params"], cli[0]["params"])
    # ranks 0, 1 hold client shard 0 (model 0, 1); ranks 2, 3 shard 1
    for a, b in ((0, 1), (2, 3)):
        assert cli[a]["client_block"] == cli[b]["client_block"]
        for k in cli[a]["rows"]:
            assert torch.equal(cli[a]["rows"][k], cli[b]["rows"][k])
    one = gpt2_train.main(R.CLI_ARGS + R.LOCAL_TOPK + ["--log_jsonl", str(tmp_path / "r.jsonl")])
    _close(cli[0]["params"], one.state["params"], 1e-4, 1e-6)
    ckpts = sorted(os.listdir(os.path.join(out, "ckpt")))
    payload = torch.load(os.path.join(out, "ckpt", ckpts[-1], "state.pt"), weights_only=False)
    B = cli[0]["client_block"][1]
    for k, rows in payload["client_state"].items():
        assert rows.shape[0] == one.train_set.num_clients
        for shard, rank in ((0, 0), (1, 2)):
            assert torch.equal(rows[shard * B:(shard + 1) * B], cli[rank]["rows"][k][:len(
                rows[shard * B:(shard + 1) * B])])


def test_served_clients_by_model_matches_one_device(run):
    """(v): the payload round's tables gathered over the serve cycle's
    client-axis group of each model coordinate."""
    _, got, _ = run
    have = got[0]["serve_clients_tp"]
    for g in got:
        assert g["serve_clients_tp"]["round"] == 2
        assert torch.equal(g["serve_clients_tp"]["params"], have["params"])
    one = R.served_cli(R.CLI_ARGS + R.SKETCH_SERVE)
    _close(have["params"], one["params"], 2e-4, 2e-5)
