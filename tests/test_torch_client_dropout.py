"""``--client_dropout`` in the port, after the reference's
tests/test_dropout.py: each sampled client independently drops before
aggregation. The port draws the mask from a generator of its own, seeded
from (seed, round) (``engine.participation_mask``); the reference draws it
from threefry keys, which torch cannot reproduce, so the draw itself is
held distributionally (the rate within 3 sigma of its Bernoulli mean) and
everything given the mask is held bitwise inside the port and against the
reference round with the same mask as its validity mask (atol 1e-5, as in
tests/test_torch_round.py)."""

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
from commefficient_tpu_torch.federated import engine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models.losses import make_classification_loss as tloss
from commefficient_tpu_torch.modes.config import ModeConfig
from test_torch_cohort_faults import SKETCH, UNCOMPRESSED, _image_batch, _tiny_pair
from test_torch_loop_parity import TINY_PATHS
from test_torch_runner import LR, _args, tiny_cv  # noqa: F401

torch.set_num_threads(2)

NONE = dict(mode="uncompressed", momentum=0.0, momentum_type="none", error_type="none")
SEED = 5


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", TINY_PATHS.__getitem__)
    return _tiny_pair()


def _port(tiny, mode_kw, **eng_kw):
    """(step, state) of the torch twin."""
    _, _, tmodel = tiny
    layout = convert.FlatLayout(tmodel)
    cfg = engine.EngineConfig(mode=ModeConfig(d=layout.d, **mode_kw), weight_decay=5e-4,
                              seed=SEED, **eng_kw)
    state = engine.init_server_state(
        cfg, layout.flatten({k: v.detach() for k, v in tmodel.named_parameters()}), {})
    return engine.make_round_step(tloss(tmodel, True), cfg, layout), state


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _same_round(a, b):
    (sa, ra, ma), (sb, rb, mb) = a, b
    assert torch.equal(sa["params"], sb["params"])
    for k in sa["mode_state"]:
        assert torch.equal(sa["mode_state"][k], sb["mode_state"][k]), k
    for k in ra:
        assert torch.equal(ra[k], rb[k]), k
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_dropout_zero_is_identity(tiny):
    batch = _t(_image_batch(8))
    step0, s0 = _port(tiny, UNCOMPRESSED)
    step1, s1 = _port(tiny, UNCOMPRESSED, client_dropout=0.0)
    _same_round(step0(s0, batch, {}, 0.1), step1(s1, batch, {}, 0.1))


def _dropout_vs_survivors(tiny, mode_kw, chunk):
    """(the dropout round, the round over the survivors alone, the mask),
    both at ``client_chunk`` = ``chunk``, after holding the dropout round
    bitwise against the round with the mask as its validity."""
    W = 8
    batch = _image_batch(W)
    mask = engine.participation_mask(SEED, 0, W, 0.4)
    assert 0 < mask.sum() < W  # the seed gives a non-trivial mask
    step, state = _port(tiny, mode_kw, client_dropout=0.4, client_chunk=chunk)
    dropped = step(state, _t(batch), {}, 0.1)
    plain, state0 = _port(tiny, mode_kw, client_chunk=chunk)
    _same_round(dropped, plain(state0, {**_t(batch), "_valid": mask}, {}, 0.1))
    surv = np.flatnonzero(mask.numpy())
    alone = plain(state0, _t({k: v[surv] for k, v in batch.items()}), {}, 0.1)
    assert dropped[2]["count"].item() == mask.sum().item() * 4
    return dropped, alone, mask, batch, state


@pytest.mark.parametrize("mode_kw", [UNCOMPRESSED, SKETCH], ids=["uncompressed", "sketch"])
def test_dropout_equals_survivor_only_round(tiny, mode_kw):
    """Given the mask: the dropout round is, bitwise, the round with that
    mask as its validity and (at client_chunk=1, one client a chunk, as the
    reference pins its own) the round over the survivors alone; and it is
    the reference round with the same validity."""
    dropped, alone, mask, batch, state = _dropout_vs_survivors(tiny, mode_kw, 1)
    assert torch.equal(dropped[0]["params"], alone[0]["params"])

    fmodel, params, _ = tiny
    d = state["params"].numel()
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **mode_kw), weight_decay=5e-4)
    jnew, _, jm = jax.jit(jengine.make_round_step(jloss(fmodel, True), jcfg))(
        jengine.init_server_state(jcfg, params, {}),
        {**jax.tree.map(jnp.asarray, batch), "_valid": jnp.asarray(mask.numpy())}, {},
        jnp.float32(0.1), jax.random.PRNGKey(0))
    assert float(jm["participants"]) == dropped[2]["participants"].item()
    jp, tp = np.asarray(ravel_pytree(jnew["params"])[0]), dropped[0]["params"].numpy()
    p0 = state["params"].numpy()
    if mode_kw["mode"] == "sketch":
        j_set, t_set = set(np.flatnonzero(jp != p0)), set(np.flatnonzero(tp != p0))
        assert len(j_set ^ t_set) <= 2  # a near-tie swap at most
        same = np.array(sorted(j_set & t_set))
        np.testing.assert_allclose(tp[same], jp[same], rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)


def test_dropout_equals_survivor_only_round_at_chunk_0(tiny):
    """At client_chunk=0 the dropout round is still bitwise the round with
    the mask as its validity (the same W), and the survivors-alone round
    (a vmap of fewer clients, whose products sum in another order) within
    atol 1e-6 of its params."""
    dropped, alone, _, _, _ = _dropout_vs_survivors(tiny, UNCOMPRESSED, 0)
    torch.testing.assert_close(dropped[0]["params"], alone[0]["params"], rtol=0, atol=1e-6)


def test_dropout_preserves_dropped_local_state(tiny):
    """local_topk with local error: a dropped client's error row comes back
    bitwise; a survivor's changes."""
    W = 8
    mode_kw = dict(mode="local_topk", k=8, momentum_type="none", error_type="local")
    step, state = _port(tiny, mode_kw, client_dropout=0.5)
    mask = engine.participation_mask(SEED, 0, W, 0.5)
    assert 0 < mask.sum() < W
    d = state["params"].numel()
    rows = {"error": torch.arange(W * d, dtype=torch.float32).reshape(W, d)}
    _, new_rows, _ = step(state, _t(_image_batch(W)), rows, 0.1)
    for i in range(W):
        assert torch.equal(new_rows["error"][i], rows["error"][i]) == (mask[i] == 0), i


def test_full_dropout_round_is_a_noop_update(tiny):
    step, state = _port(tiny, NONE, client_dropout=0.999999)
    new, _, m = step(state, _t(_image_batch(4)), {}, 0.5)
    assert torch.equal(new["params"], state["params"])
    assert m["count"].item() == 0.0 and m["participants"].item() == 0.0


def test_full_dropout_with_dp_noise_applies_no_update(tiny):
    """An empty cohort transmits nothing, so with DP noise on it releases
    nothing: no pure-noise update at full sensitivity."""
    step, state = _port(tiny, NONE, client_dropout=0.999999, dp_clip=1.0, dp_noise=2.0)
    new, _, m = step(state, _t(_image_batch(4)), {}, 0.5)
    assert torch.equal(new["params"], state["params"])
    assert m["participants"].item() == 0.0


def test_partial_dropout_with_dp_noise_still_noises(tiny):
    batch = _t(_image_batch(8))
    noisy, s = _port(tiny, NONE, client_dropout=0.4, dp_clip=1.0, dp_noise=1.0)
    clean, c = _port(tiny, NONE, client_dropout=0.4, dp_clip=1.0)
    a, _, m = noisy(s, batch, {}, 0.1)
    b, _, _ = clean(c, batch, {}, 0.1)
    assert 0 < m["participants"].item() < 8
    assert not torch.allclose(a["params"], b["params"])


@pytest.mark.parametrize("rate", [1.0, -0.1])
def test_invalid_dropout_rejected(tiny, rate):
    with pytest.raises(ValueError, match="client_dropout"):
        _port(tiny, NONE, client_dropout=rate)
    with pytest.raises(ValueError, match="client_dropout"):
        jengine.EngineConfig(mode=JModeConfig(d=10, **NONE), client_dropout=rate)


def test_dropout_comm_accounting_charges_survivors_only(tiny_cv):
    """Uplink for the clients that took part, with dropout or with a
    masked client; the down-link still reaches the whole cohort."""
    # --seed 5: round 0's mask at p = 0.5 is non-trivial (seed 42's keeps all 8)
    argv = ("--num_workers", "8", "--mode", "uncompressed", "--seed", "5")
    base, _ = tcv.build(_args(argv))
    b = base.run_round(LR)
    s, _ = tcv.build(_args((*argv, "--client_dropout", "0.5")))
    m = s.run_round(LR)
    assert 0 < m["participants"] < 8
    assert m["comm_up_mb"] == pytest.approx(b["comm_up_mb"] * m["participants"] / 8)
    assert m["comm_down_mb"] == pytest.approx(b["comm_down_mb"])
    assert m["comm_total_mb"] == pytest.approx(m["comm_up_mb"] + m["comm_down_mb"])
    assert m["clients_dropped"] == 0.0  # random dropout is not a masked client
    f, _ = tcv.build(_args((*argv, "--fault_plan", "client_drop@0:clients=1+2+5")))
    m = f.run_round(LR)
    assert (m["participants"], m["clients_dropped"]) == (5.0, 3.0)
    assert m["comm_up_mb"] == pytest.approx(b["comm_up_mb"] * 5 / 8)
    assert b["clients_dropped"] == 0.0 and b["comm_up_mb"] > 0


def test_participation_mask_is_a_pure_function_of_seed_and_round():
    """The same (seed, round) draws the same mask on every call without
    touching torch's or numpy's global streams; rounds and seeds differ;
    over many rounds the survival rate is 1 - p within 3 sigma."""
    torch_state, np_state = torch.random.get_rng_state(), np.random.get_state()
    a = engine.participation_mask(3, 7, 8, 0.25)
    assert torch.equal(a, engine.participation_mask(3, 7, 8, 0.25))
    assert torch.equal(torch.random.get_rng_state(), torch_state)
    assert np.array_equal(np.random.get_state()[1], np_state[1])
    assert a.dtype == torch.float32 and set(a.tolist()) <= {0.0, 1.0}
    assert torch.equal(engine.participation_mask(3, 7, 8, 0.0), torch.ones(8))
    rounds, W, p = 2000, 8, 0.25
    draws = torch.stack([engine.participation_mask(3, r, W, p) for r in range(rounds)])
    n = rounds * W
    assert abs(draws.mean().item() - (1 - p)) <= 3 * (p * (1 - p) / n) ** 0.5
    assert not all(torch.equal(draws[0], draws[r]) for r in range(1, 20))
    other = torch.stack([engine.participation_mask(4, r, W, p) for r in range(20)])
    assert not torch.equal(other, draws[:20])
    # the dropout streams of the clients' forwards are other seeds
    seeds = {engine.dropout_seed(3, 7, slot, step) for slot in range(64) for step in range(4)}
    assert engine.dropout_seed(3, 7, engine.PARTICIPATION_TAG, 0) not in seeds


@pytest.mark.cuda
def test_participation_mask_same_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for r in range(5):
        m = engine.participation_mask(3, r, 8, 0.3, torch.device("cuda"))
        assert m.is_cuda and torch.equal(m.cpu(), engine.participation_mask(3, r, 8, 0.3))


def test_dropout_in_blocks_of_rounds_equals_single_rounds(tiny_cv, tmp_path):
    """The mask is a function of the round, so a block of rounds in one
    dispatch (--rounds_per_dispatch 3) draws what single rounds draw."""
    from test_torch_runner import _argv, _assert_state_equal, _rows

    argv = ("--num_workers", "4", "--num_rounds", "6", "--client_dropout", "0.3",
            "--dp_clip", "2.0", "--seed", "5")
    a = tcv.main(_argv((*argv, "--sync_loop", "--log_jsonl", str(tmp_path / "a.jsonl"))))
    b = tcv.main(_argv((*argv, "--rounds_per_dispatch", "3", "--log_jsonl",
                        str(tmp_path / "b.jsonl"))))
    _assert_state_equal(a, b)
    assert _rows(tmp_path / "a.jsonl") == _rows(tmp_path / "b.jsonl")
    assert a.comm_mb_total == b.comm_mb_total < 6 * a.comm_per_round["comm_total_mb"]
