"""Differential privacy in the port (``--dp_clip``, ``--dp_noise``), after
the DP tests of the reference's tests/test_engine.py and
tests/test_dropout.py: each client's update is clipped to an L2 norm
before the fold, and central Gaussian noise scaled to the survivors is
added to the aggregate.

Tolerances: the clip against the reference's, 1e-6 relative; a clipped
round against the reference round as in tests/test_torch_round.py (atol
1e-5 on the params, a top-k swap only at a near-tie); the noise, drawn
from torch generators where the reference draws threefry, distributional:
its std within 2% of ``dp_noise * sens`` in both packages."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models.losses import make_classification_loss as jloss
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu_torch import cv_train as tcv
from commefficient_tpu_torch import gpt2_train as tg2
from commefficient_tpu_torch.federated import engine
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.modes.config import ModeConfig
from test_torch_client_dropout import NONE, _port, _t, tiny  # noqa: F401
from test_torch_cohort_faults import SKETCH, UNCOMPRESSED, _image_batch
from test_torch_runner import _argv, _assert_state_equal, _rows, tiny_cv  # noqa: F401

torch.set_num_threads(2)

TRUE_TOPK = dict(mode="true_topk", k=100, momentum=0.9, momentum_type="virtual",
                 error_type="virtual")


@pytest.mark.parametrize("scale", [1e-4, 1.0, 30.0])
def test_clip_matches_the_reference(scale):
    """min(1, clip / max(||u||, 1e-12)) on the same float32 updates: the
    norm sums in another order than XLA's, so 1e-6 relative."""
    rng = np.random.RandomState(0)
    u = (scale * rng.standard_normal((4, 98_666))).astype(np.float32)
    clip = 2.5
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=u.shape[1], **NONE), dp_clip=clip)
    want = np.asarray(jengine._clip_updates(jcfg, jnp.asarray(u)))
    for w in range(4):
        t = torch.from_numpy(u[w])
        got = (t * engine.clip_factor(t, clip)).numpy()
        np.testing.assert_allclose(got, want[w], rtol=1e-6, atol=0)
        np.testing.assert_allclose(float(engine.clip_factor(t, clip)),
                                   min(1.0, clip / np.linalg.norm(u[w].astype(np.float64))),
                                   rtol=1e-6)


def test_dp_clip_bounds_every_clients_update(tiny):
    """One client at a time (the others masked): with a tiny clip the
    server delta is at most lr * clip in norm, for every client; a huge
    clip is the unclipped round, bitwise."""
    W, lr, clip = 4, 0.5, 1e-3
    batch = _t(_image_batch(W))
    step, state = _port(tiny, NONE, dp_clip=clip)
    for w in range(W):
        valid = torch.zeros(W)
        valid[w] = 1.0
        new, _, _ = step(state, {**batch, "_valid": valid}, {}, lr)
        norm = torch.linalg.vector_norm(new["params"] - state["params"]).item()
        assert 0 < norm <= lr * clip * 1.001, (w, norm)
    huge, s1 = _port(tiny, NONE, dp_clip=1e9)
    plain, s2 = _port(tiny, NONE)
    assert torch.equal(huge(s1, batch, {}, lr)[0]["params"], plain(s2, batch, {}, lr)[0]["params"])


@pytest.mark.parametrize("mode_kw", [SKETCH, TRUE_TOPK, UNCOMPRESSED],
                         ids=["sketch", "true_topk", "uncompressed"])
def test_dp_clip_round_matches_the_reference(tiny, mode_kw):
    """A round with a binding clip (and a masked client) through both
    engines from the same params, state and batch."""
    fmodel, params, _ = tiny
    W, clip = 5, 0.05
    batch = _image_batch(W)
    batch["_valid"] = np.array([1, 1, 0, 1, 1], np.float32)
    step, state = _port(tiny, mode_kw, dp_clip=clip)
    _, unclipped = _port(tiny, mode_kw)
    g, _, _ = engine.reduce_clients(*_reduce_args(tiny, mode_kw, {}), unclipped,
                                    _t(batch))
    assert g.norm().item() > clip  # the clip binds
    tnew, _, tm = step(state, _t(batch), {}, 0.1)
    d = state["params"].numel()
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=5e-4,
                                dp_clip=clip)
    jnew, _, jm = jax.jit(jengine.make_round_step(jloss(fmodel, True), jcfg))(
        jengine.init_server_state(jcfg, params, {}), jax.tree.map(jnp.asarray, batch), {},
        jnp.float32(0.1), jax.random.PRNGKey(0))
    for k in ("loss_sum", "count", "participants"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    p0 = state["params"].numpy()
    jp, tp = np.asarray(ravel_pytree(jnew["params"])[0]), tnew["params"].numpy()
    if mode_kw["mode"] == "uncompressed":
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
        return
    j_set, t_set = set(np.flatnonzero(jp != p0)), set(np.flatnonzero(tp != p0))
    assert len(t_set) == mode_kw["k"] and len(j_set ^ t_set) <= 2
    same = np.array(sorted(j_set & t_set))
    np.testing.assert_allclose(tp[same], jp[same], rtol=0, atol=1e-5)


def _reduce_args(tiny, mode_kw, eng_kw):
    from commefficient_tpu_torch.models import convert
    from commefficient_tpu_torch.models.losses import make_classification_loss as tloss

    _, _, tmodel = tiny
    layout = convert.FlatLayout(tmodel)
    cfg = engine.EngineConfig(mode=ModeConfig(d=layout.d, **mode_kw), weight_decay=5e-4,
                              **eng_kw)
    return tloss(tmodel, True), cfg, layout


def _noise(step_noisy, step_clean, s1, s2, batch, lr):
    """The aggregate's noise of an uncompressed round without momentum:
    delta = lr * aggregate, so the params' difference over lr."""
    a, _, m = step_noisy(s1, batch, {}, lr)
    b, _, _ = step_clean(s2, batch, {}, lr)
    return ((b["params"] - a["params"]) / lr).double(), m


@pytest.mark.parametrize("agg_op", ["mean", "sum"])
def test_dp_noise_std_is_dp_noise_times_sensitivity(tiny, agg_op):
    """Noised minus noiseless aggregate over d = 98,666 coordinates: std
    within 2% of dp_noise * dp_clip / participants (mean) or dp_noise *
    dp_clip (sum), mean within 4 standard errors of 0; the reference's
    noise, measured the same way, too."""
    mode_kw = dict(NONE, agg_op=agg_op)
    W, lr, clip, mult = 4, 0.5, 1.0, 1.5
    batch = _image_batch(W)
    batch["_valid"] = np.array([1, 0, 1, 1], np.float32)
    noisy, s1 = _port(tiny, mode_kw, dp_clip=clip, dp_noise=mult)
    clean, s2 = _port(tiny, mode_kw, dp_clip=clip)
    noise, m = _noise(noisy, clean, s1, s2, _t(batch), lr)
    want = mult * clip / (1.0 if agg_op == "sum" else m["participants"].item())
    d = noise.numel()
    assert abs(noise.std().item() / want - 1) < 0.02
    assert abs(noise.mean().item()) < 4 * want / d ** 0.5

    fmodel, params, _ = tiny
    jnew = {}
    for noise_mult in (mult, 0.0):
        jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=5e-4,
                                    dp_clip=clip, dp_noise=noise_mult)
        jnew[noise_mult], _, _ = jax.jit(jengine.make_round_step(jloss(fmodel, True), jcfg))(
            jengine.init_server_state(jcfg, params, {}), jax.tree.map(jnp.asarray, batch),
            {}, jnp.float32(lr), jax.random.PRNGKey(0))
    jn = (np.asarray(ravel_pytree(jnew[0.0]["params"])[0], np.float64)
          - np.asarray(ravel_pytree(jnew[mult]["params"])[0], np.float64)) / lr
    assert abs(jn.std() / want - 1) < 0.02


def test_dp_noise_is_a_function_of_seed_and_round(tiny):
    batch = _t(_image_batch(4))
    step, s = _port(tiny, NONE, dp_clip=1.0, dp_noise=1.0)
    a, b = step(s, batch, {}, 0.1)[0], step(s, batch, {}, 0.1)[0]
    assert torch.equal(a["params"], b["params"])
    later = step(dict(s, round=1), batch, {}, 0.1)[0]
    assert not torch.equal(a["params"], later["params"])


REFUSALS = {
    "noise_without_clip": (NONE, dict(dp_noise=1.0), "requires dp_clip"),
    "noise_with_sketch": (SKETCH, dict(dp_clip=1.0, dp_noise=1.0), "mode=sketch"),
    "noise_with_local_state": (dict(mode="local_topk", k=8, momentum_type="none",
                                    error_type="local"),
                               dict(dp_clip=1.0, dp_noise=1.0), "client-local"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_dp_refusals_match_the_reference(case):
    mode_kw, eng_kw, why = REFUSALS[case]
    with pytest.raises(ValueError, match=why):
        engine.EngineConfig(mode=ModeConfig(d=100, **mode_kw), **eng_kw)
    with pytest.raises(ValueError, match=why):
        jengine.EngineConfig(mode=JModeConfig(d=100, **mode_kw), **eng_kw)


def test_dp_noise_with_batch_norm_is_refused():
    cfg = engine.EngineConfig(mode=ModeConfig(d=10, **NONE), dp_clip=1.0, dp_noise=0.1)
    with pytest.raises(ValueError, match="mutable model collections"):
        engine.init_server_state(cfg, torch.zeros(10), {"bn.running_mean": torch.zeros(3)})
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=10, **NONE), dp_clip=1.0, dp_noise=0.1)
    with pytest.raises(ValueError, match="mutable model collections"):
        jengine.init_server_state(jcfg, {"w": jnp.zeros(10)}, {"batch_stats": {"m": jnp.zeros(3)}})
    # through the CLI: ResNet-9 keeps batch-norm statistics
    with pytest.raises(ValueError, match="mutable model collections"):
        tcv.main(["--device", "cpu", "--mode", "uncompressed", "--dp_clip", "1",
                  "--dp_noise", "1", "--num_rounds", "1", "--synthetic_train", "16",
                  "--num_clients", "4", "--data_root", "/nonexistent"])


def test_cv_cli_true_topk_with_dp_async_equals_sync(tiny_cv, tmp_path):
    argv = ("--mode", "true_topk", "--k", "200", "--num_workers", "4", "--num_rounds", "4",
            "--dp_clip", "0.5", "--dp_noise", "0.3", "--client_dropout", "0.25")
    a = tcv.main(_argv((*argv, "--sync_loop", "--log_jsonl", str(tmp_path / "a.jsonl"))))
    b = tcv.main(_argv((*argv, "--log_jsonl", str(tmp_path / "b.jsonl"))))
    _assert_state_equal(a, b)
    assert _rows(tmp_path / "a.jsonl") == _rows(tmp_path / "b.jsonl")


def test_gpt2_cli_with_dp_dropout_and_a_drop_async_equals_sync(monkeypatch, tmp_path):
    """GPT-2 tiny (no batch norm, dropout on) through gpt2_train: DP noise,
    client dropout and a dropped client, async against sync, bitwise."""
    monkeypatch.setattr(tg2, "TINY", dataclasses.replace(tgpt2.TINY, dropout=0.1))
    argv = ["--model_size", "tiny", "--seq_len", "32", "--num_clients", "12",
            "--num_workers", "4", "--local_batch_size", "2", "--num_rounds", "3",
            "--eval_every", "3", "--eval_batch_size", "8", "--data_root", "/nonexistent",
            "--device", "cpu", "--mode", "uncompressed", "--dp_clip", "1.0",
            "--dp_noise", "0.5", "--client_dropout", "0.25", "--requeue_policy", "aged",
            "--fault_plan", "client_drop@1:clients=0+2"]
    logs = [str(tmp_path / f"{n}.jsonl") for n in ("s", "a")]
    s = tg2.main(argv + ["--sync_loop", "--log_jsonl", logs[0]])
    a = tg2.main(argv + ["--log_jsonl", logs[1]])
    assert torch.equal(s.state["params"], a.state["params"])
    rows = [[{k: v for k, v in json.loads(line).items() if k != "time_s"}
             for line in open(p)] for p in logs]
    assert rows[0] == rows[1]
    assert s.run_stats.clients_dropped == 2 and torch.isfinite(s.state["params"]).all()
