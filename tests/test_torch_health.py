"""Sketch health in the port (``obs/health.py``, the engine's health block,
the session's cadence) against the JAX package's.

- Every device-half estimator on the same numpy tables (a heavy-tailed
  vector sketched by the JAX package), rotation and random families, r in
  {1, 2, 5}, a clean and a saturated geometry: relative 1e-5, absolute
  1e-7 near 0. The split estimator single-shot and chunked (the
  single-shot budget lowered by monkeypatch in both packages).
- A round's "health/" block on the same params, state and batches as the
  JAX round (tests/test_torch_runner.py's tiny MLP, W = 4): the fused
  step, a 2-round block and the payload merge, relative 1e-5 (absolute
  1e-7 near 0).
- A health-armed CLI run is bitwise an unarmed one; the cadence, the
  registry gauges, the recall proxy's bracket against the truth, and the
  refusal without mode=sketch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models.losses import make_classification_loss as jloss
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu.obs import health as jhealth
from commefficient_tpu.obs import registry as jreg
from commefficient_tpu.sketch import csvec as jcsvec
from commefficient_tpu_torch import cv_train
from commefficient_tpu_torch.federated import engine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models.losses import make_classification_loss
from commefficient_tpu_torch.modes.config import ModeConfig
from commefficient_tpu_torch.obs import health as thealth
from commefficient_tpu_torch.obs import registry as treg
from commefficient_tpu_torch.obs import trace as ttrace
from commefficient_tpu_torch.sketch import csvec
from test_torch_cohort_faults import _tiny_pair
from test_torch_loop_parity import TINY_PATHS
from test_torch_runner import _argv, _assert_state_equal, _rows, tiny_cv  # noqa: F401

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-7
W, B, K = 4, 4, 100
LR, WD = 0.05, 5e-4
SKETCH = dict(mode="sketch", k=K, num_rows=3, num_cols=2000, error_type="virtual",
              momentum=0.9, momentum_type="virtual")


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    monkeypatch.setattr(treg, "_DEFAULT", treg.Registry())
    monkeypatch.setattr(jreg, "_DEFAULT", jreg.Registry())
    yield
    ttrace.configure()


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=name)


# ------------------------------------------------ the device half, alone


def _specs(family, r, c, d, k=64):
    kw = dict(mode="sketch", d=d, k=k, num_rows=r, num_cols=c, momentum=0.0,
              momentum_type="none", error_type="virtual", hash_family=family)
    return ModeConfig(**kw).sketch_spec, JModeConfig(**kw).sketch_spec


# clean: c well above the support; saturated: c far below it
GEOMETRIES = {"clean": 4096, "saturated": 64}


def _table(family, r, geometry, d=6000, seed=0):
    """(port spec, JAX spec, numpy table, numpy vector): a heavy-tailed
    vector from a numpy seed, sketched by the JAX package."""
    spec, jspec = _specs(family, r, GEOMETRIES[geometry], d)
    g = np.random.RandomState(seed).standard_t(3.0, size=d).astype(np.float32)
    return spec, jspec, np.array(jcsvec.sketch_vec(jspec, jnp.asarray(g))), g


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("r", [1, 2, 5])
@pytest.mark.parametrize("family", ["rotation", "random"])
def test_estimators_match_jax(family, r, geometry):
    spec, jspec, tab, g = _table(family, r, geometry)
    t, j = torch.from_numpy(tab), jnp.asarray(tab)
    for name in ("table_row_masses", "table_mass_estimate", "row_mass_cv", "table_occupancy"):
        _close(getattr(thealth, name)(t), getattr(jhealth, name)(j), name)
    vals = g[:200]
    _close(thealth.topk_energy(torch.from_numpy(vals)), jhealth.topk_energy(jnp.asarray(vals)))
    mass_t, mass_j = thealth.table_mass_estimate(t), jhealth.table_mass_estimate(j)
    _close(thealth.energy_fraction(mass_t / 3, mass_t), jhealth.energy_fraction(mass_j / 3, mass_j))
    _close(thealth.energy_fraction(torch.tensor(1.0), torch.tensor(0.0)),
           jhealth.energy_fraction(jnp.float32(1.0), jnp.float32(0.0)), "eps clamp")
    idx = np.random.RandomState(1).randint(0, spec.d, 500)
    _close(thealth.per_row_estimates(spec, t, torch.from_numpy(idx)),
           jhealth.per_row_estimates(jspec, j, jnp.asarray(idx, jnp.int32)), "per_row")
    if r >= 2:
        _close(thealth.split_topk_energy_fraction(spec, t, 64, mass_t),
               jhealth.split_topk_energy_fraction(jspec, j, 64, mass_j), "split")


@pytest.mark.parametrize("path", ["single", "chunked"])
@pytest.mark.parametrize("family", ["rotation", "random"])
def test_split_estimator_paths_match_jax(monkeypatch, family, path):
    """Single-shot, and the chunked scan with its running top-k carry
    (both packages' budget lowered to 4000 coordinates a chunk), against
    the JAX package's same path; the two paths agree with each other."""
    spec, jspec, tab, _ = _table(family, 5, "clean", d=30_000)
    t, j = torch.from_numpy(tab), jnp.asarray(tab)
    mass_t, mass_j = thealth.table_mass_estimate(t), jhealth.table_mass_estimate(j)
    single = float(thealth.split_topk_energy_fraction(spec, t, 256, mass_t))
    if path == "chunked":
        budget = 4 * spec.r * 4000
        monkeypatch.setattr(csvec, "UNSKETCH_SINGLE_SHOT_BYTES", budget)
        monkeypatch.setattr(jcsvec, "UNSKETCH_SINGLE_SHOT_BYTES", budget)
    got = thealth.split_topk_energy_fraction(spec, t, 256, mass_t)
    _close(got, jhealth.split_topk_energy_fraction(jspec, j, 256, mass_j), path)
    assert abs(float(got) - single) < 1e-4


def test_top_k_orders_as_lax_top_k():
    """Descending, ties toward the lower index, -inf below every finite
    value: jax.lax.top_k's selection and order."""
    x = np.array([1.0, 3.0, -np.inf, 3.0, 0.0, 2.0, 3.0, -1.0, -np.inf, 2.0], np.float32)
    for k in (1, 3, 5, 9):
        vals, idx = csvec.top_k(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_recall_proxy_brackets_the_truth():
    """On a moderate geometry the bracket's midpoint is within 0.05 of the
    true top-k energy fraction (the reference's bar) and of the JAX
    package's proxy; saturating the table (c = 1,024 for k = 512) widens
    the bracket."""
    d = 50_000
    g = np.random.RandomState(0).standard_t(3.0, size=d).astype(np.float32)
    gsq = float(np.sum(g.astype(np.float64) ** 2))

    def bracket(k, c):
        spec, jspec = _specs("rotation", 5, c, d, k)
        tab = csvec.sketch_vec(spec, torch.from_numpy(g))
        mass = thealth.table_mass_estimate(tab)
        _, pv = csvec.unsketch_topk(spec, tab, k)
        naive = float(thealth.topk_energy(pv) / mass)
        pess = float(thealth.split_topk_energy_fraction(spec, tab, k, mass))
        true = float(np.sum(g[np.argsort(-np.abs(g), kind="stable")[:k]].astype(np.float64)
                            ** 2) / gsq)
        jtab = jnp.asarray(tab.numpy())
        jmass = jhealth.table_mass_estimate(jtab)
        jpess = float(jhealth.split_topk_energy_fraction(jspec, jtab, k, jmass))
        return naive, pess, 0.5 * (naive + pess), true, jpess

    naive, pess, proxy, true, jpess = bracket(512, 16_384)
    assert abs(proxy - true) <= 0.05, (proxy, true)
    assert naive >= pess and abs(pess - jpess) <= RTOL * abs(jpess)
    naive2, pess2, _, _, _ = bracket(512, 1_024)
    assert naive2 - pess2 > naive - pess


# ------------------------------------------ a round's block against JAX


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", TINY_PATHS.__getitem__)
    return _tiny_pair()


def _batch(seed=1, health=1.0):
    rng = np.random.RandomState(seed)
    mask = np.ones((W, B), np.float32)
    mask[1, 1] = 0.0
    return {"x": rng.standard_normal((W, B, 32, 32, 3)).astype(np.float32),
            "y": rng.randint(0, 10, (W, B)).astype(np.int32), "mask": mask,
            "_valid": np.ones(W, np.float32), "_health_on": np.full(W, health, np.float32)}


def _mode_state(d, seed=2):
    spec = ModeConfig(d=d, **SKETCH).sketch_spec
    rng = np.random.RandomState(seed)
    return {"Vvelocity": (1e-3 * rng.standard_normal(spec.table_shape)).astype(np.float32),
            "Verror": (1e-4 * rng.standard_normal(spec.table_shape)).astype(np.float32)}


def _both(tiny, **eng_kw):
    fmodel, params, tmodel = tiny
    d = ravel_pytree(params)[0].size
    ms = _mode_state(d)
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=d, **SKETCH), weight_decay=WD,
                                on_nonfinite="skip", health=True, **eng_kw)
    jstate = jengine.init_server_state(jcfg, params, {})
    jstate["mode_state"] = {k: jnp.asarray(v) for k, v in ms.items()}
    layout = convert.FlatLayout(tmodel)
    cfg = engine.EngineConfig(mode=ModeConfig(d=d, **SKETCH), weight_decay=WD,
                              on_nonfinite="skip", health=True, **eng_kw)
    tstate = engine.init_server_state(
        cfg, layout.flatten({k: v.detach() for k, v in tmodel.named_parameters()}), {})
    tstate["mode_state"] = {k: torch.from_numpy(v.copy()) for k, v in ms.items()}
    return (fmodel, jcfg, jstate), (tmodel, cfg, layout, tstate)


def _health_equal(tm, jm, expect_keys):
    th = {k: v for k, v in tm.items() if k.startswith("health/")}
    jh = {k: v for k, v in jm.items() if k.startswith("health/")}
    assert th.keys() == jh.keys() == {f"health/{k}" for k in expect_keys}
    for k in th:
        _close(th[k].numpy(), np.asarray(jh[k]), k)
    return th


FUSED_KEYS = thealth.SCALAR_KEYS + thealth.ARRAY_KEYS
WIRE_KEYS = tuple(k for k in thealth.SCALAR_KEYS if k not in ("grad_norm_true", "topk_mass_true"))


def test_fused_round_health_block_matches_jax(tiny):
    (fmodel, jcfg, jstate), (tmodel, cfg, layout, tstate) = _both(tiny)
    batch = _batch()
    _, _, jm = jax.jit(jengine.make_round_step(jloss(fmodel, True), jcfg))(
        jstate, jax.tree.map(jnp.asarray, batch), {}, jnp.float32(LR), jax.random.PRNGKey(0))
    _, _, tm = engine.make_round_step(make_classification_loss(tmodel, True), cfg, layout)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, {}, LR)
    th = _health_equal(tm, jm, FUSED_KEYS)
    assert th["health/leaf_norms"].shape == (len(layout.leaves),)
    for k in ("grad_mass_est", "topk_mass_proxy", "release_energy", "verror_ratio"):
        assert float(th[f"health/{k}"]) > 0, k  # every estimator read real state


def test_block_dispatch_health_matches_jax(tiny):
    """Rounds 0 (armed) and 1 (off cadence) in one block: the armed
    round's block as the JAX scan's, the off round's zeros."""
    (fmodel, jcfg, jstate), (tmodel, cfg, layout, tstate) = _both(tiny)
    batches = [_batch(1, 1.0), _batch(3, 0.0)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    _, jm = jax.jit(jengine.make_multi_round_step(jloss(fmodel, True), jcfg))(
        jstate, jax.tree.map(jnp.asarray, stacked), jnp.full(2, LR, jnp.float32),
        jax.random.split(jax.random.PRNGKey(0), 2))
    _, tm = engine.make_multi_round_step(make_classification_loss(tmodel, True), cfg, layout)(
        tstate, {k: torch.from_numpy(v) for k, v in stacked.items()},
        torch.full((2,), LR))
    th = _health_equal(tm, jm, FUSED_KEYS)
    for k, v in th.items():
        assert not v[1].any(), k


def test_payload_merge_health_matches_jax(tiny):
    (fmodel, jcfg, jstate), (tmodel, cfg, layout, tstate) = _both(tiny, wire_payloads=True)
    batch = _batch()
    jclient, jmerge = jengine.make_payload_round_steps(jloss(fmodel, True), jcfg)
    jt, jns, jmv, jpart, nrng, _ = jax.jit(jclient)(
        jstate, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    _, jm = jax.jit(jmerge)(jstate, jt, jns, jmv, jpart, jnp.ones(W), jnp.float32(LR), nrng,
                            health_on=jnp.float32(1.0))
    tclient, tmerge = engine.make_payload_round_steps(
        make_classification_loss(tmodel, True), cfg, layout)
    tt, tns, tmv, tpart, _ = tclient(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    _, tm = tmerge(tstate, tt, tns, tmv, tpart, torch.ones(W), torch.tensor(LR),
                   health_on=True)
    _health_equal(tm, jm, WIRE_KEYS)
    # and the composed batch round reads the batch's flag
    step = engine.compose_payload(tclient, tmerge)
    _, _, tm2 = step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, {}, LR)
    assert {k: float(v) for k, v in tm2.items()} == {k: float(v) for k, v in tm.items()}


def test_health_reads_and_never_writes(tiny):
    """Armed and unarmed steps on the same inputs: new params, state and
    every shared metric bitwise equal; the armed step's inputs untouched."""
    _, (tmodel, cfg, layout, tstate) = _both(tiny)
    loss = make_classification_loss(tmodel, True)
    before = {k: v.clone() for k, v in tstate["mode_state"].items()}
    armed = engine.make_round_step(loss, cfg, layout)(
        tstate, {k: torch.from_numpy(v) for k, v in _batch().items()}, {}, LR)
    plain = engine.make_round_step(loss, dataclasses.replace(cfg, health=False), layout)(
        tstate, {k: torch.from_numpy(v) for k, v in _batch().items() if k != "_health_on"},
        {}, LR)
    for k, v in before.items():
        assert torch.equal(tstate["mode_state"][k], v)
    assert torch.equal(armed[0]["params"], plain[0]["params"])
    for k in plain[0]["mode_state"]:
        assert torch.equal(armed[0]["mode_state"][k], plain[0]["mode_state"][k])
    for k, v in plain[2].items():
        assert torch.equal(armed[2][k], v), k


def test_cadence_flag_must_be_host_data():
    with pytest.raises(ValueError, match="host"):
        engine.split_health({"_health_on": torch.ones(4, device="meta")})
    assert engine.split_health({"x": 1}) == ({"x": 1}, False)
    assert engine.split_health({"_health_on": torch.zeros(4)})[1] is False


# ------------------------------------------------ through the session/CLI


HEALTH_ARGS = ("--num_rounds", "6", "--eval_every", "3")


@pytest.mark.parametrize("extra", [
    ["--sync_loop"], ["--rounds_per_dispatch", "3"],
    ["--serve", "inproc", "--serve_payload", "sketch", "--serve_quorum", "2",
     "--serve_deadline", "30", "--sync_loop"]], ids=["fused", "blocks", "served-payload"])
def test_health_armed_run_bitwise_equal_to_unarmed(tiny_cv, tmp_path, extra):  # noqa: F811
    base = _argv(HEALTH_ARGS + tuple(extra), "sketch")
    la, lb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    a = cv_train.main(base + ["--log_jsonl", la])
    b = cv_train.main(base + ["--log_jsonl", lb, "--health_every", "1"])
    _assert_state_equal(a, b)
    assert _rows(la) == _rows(lb)
    assert [r for r, _ in b.health_monitor.history] == list(range(6))


class _Capturing(thealth.HealthMonitor):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.calls = []

    def on_round(self, rnd, health, metrics):
        block = super().on_round(rnd, health, metrics)
        self.calls.append((rnd, block))
        return block


@pytest.mark.parametrize("rpd", [1, 2])
def test_cadence_and_registry_gauges(tiny_cv, rpd):  # noqa: F811
    """health_every=3: blocks on rounds 0 and 3 only (one dispatch a round
    or blocks of 2, whose off-cadence rounds stack zeros), the health_*
    gauges and the health_rounds_total counter."""
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    args = resolve_defaults(make_parser().parse_args(_argv(("--health_every", "3"), "sketch")))
    session, _ = cv_train.build(args)
    mon = _Capturing(mode_cfg=session.cfg.mode, num_workers=session.num_workers,
                     health_every=3)
    session.health_monitor = mon
    for _ in range(0, 6, rpd):
        session.run_rounds([LR] * rpd)
    assert [r for r, _ in mon.calls] == [0, 3]
    reg = treg.default()
    assert reg.counter("health_rounds_total").value == 2
    _, block = mon.calls[-1]
    for key in WIRE_KEYS + ("grad_norm_true", "topk_mass_true", "uplink_vs_dense"):
        assert isinstance(block[key], float), key
        assert reg.gauge(f"health_{key}").value == block[key]
    assert len(block["leaf_norms"]) == len(session.layout.leaves)
    assert block["uplink_bytes"] == 3 * 2000 * 4 * session.num_workers


def test_monitor_block_matches_jax_monitor():
    """The host half: the same health values and metrics give the JAX
    monitor's block, gauges included."""
    health = {"grad_mass_est": 2.5, "topk_mass_proxy": 0.25, "leaf_norms": [1.0, 0.5]}
    spec_kw = dict(mode="sketch", d=5000, k=10, num_rows=3, num_cols=100, momentum=0.0,
                   momentum_type="none", error_type="virtual")
    t = thealth.HealthMonitor(mode_cfg=ModeConfig(**spec_kw), num_workers=4,
                              registry=treg.Registry())
    j = jhealth.HealthMonitor(mode_cfg=JModeConfig(**spec_kw), num_workers=4,
                              registry=jreg.Registry())
    for m in ({"participants": 3.0}, {"participants": 0.0}, {}):
        assert t.on_round(0, health, m) == j.on_round(0, health, m)
    assert t.registry.snapshot() == j.registry.snapshot()
    assert thealth.SCALAR_KEYS == jhealth.SCALAR_KEYS and thealth.ARRAY_KEYS == jhealth.ARRAY_KEYS


def test_health_needs_sketch_mode(tiny_cv):  # noqa: F811
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    with pytest.raises(ValueError, match="sketch"):
        engine.EngineConfig(mode=ModeConfig(mode="uncompressed", d=10, momentum_type="none",
                                            error_type="none"), health=True)
    with pytest.raises(SystemExit, match="SKETCH"):
        resolve_defaults(make_parser().parse_args(["--health_every", "2"]))
    with pytest.raises(SystemExit, match=">= 0"):
        resolve_defaults(make_parser().parse_args(["--health_every", "-1", "--mode", "sketch"]))
    args = resolve_defaults(make_parser().parse_args(_argv((), "sketch")))
    session, _ = cv_train.build(args)
    with pytest.raises(ValueError, match="health_every"):
        type(session)(session.train_loss_fn, session.train_loss_fn, session.params(), {},
                      session.layout, session.cfg.mode, session.train_set, 2, 4,
                      device="cpu", health_every=-1)


def test_gpt2_cli_chunked_health_bitwise_equal_to_unarmed(tmp_path, monkeypatch):
    """GPT-2 (tiny, seq_len 32) through its CLI with the single-shot budget
    lowered between d and r·d floats, so the health block takes the
    chunked split estimator (3 chunks): armed (--health_every 1 --ledger
    --trace) and plain runs are bitwise equal, and every round's block is
    finite and recorded in the ledger."""
    from commefficient_tpu_torch import gpt2_train
    from commefficient_tpu_torch.obs import ledger as tledger
    from commefficient_tpu_torch.utils.config import make_parser, resolve_defaults

    argv = ["--model_size", "tiny", "--seq_len", "32", "--num_clients", "12",
            "--num_workers", "2", "--local_batch_size", "2", "--num_rounds", "2",
            "--eval_every", "2", "--eval_batch_size", "8", "--data_root", "/nonexistent",
            "--mode", "sketch", "--k", "5000", "--num_cols", "8192", "--device", "cpu",
            "--sync_loop"]
    d = gpt2_train.build(resolve_defaults(make_parser("gpt2").parse_args(argv)))[0].layout.d
    monkeypatch.setattr(csvec, "UNSKETCH_SINGLE_SHOT_BYTES", 4 * 2 * d)
    la, lb, led = (str(tmp_path / n) for n in ("a.jsonl", "b.jsonl", "led.jsonl"))
    a = gpt2_train.main(argv + ["--log_jsonl", la])
    b = gpt2_train.main(argv + ["--log_jsonl", lb, "--health_every", "1", "--ledger", led,
                                "--trace", str(tmp_path / "t.json")])
    _assert_state_equal(a, b)
    assert _rows(la) == _rows(lb)
    recs = tledger.round_records(led)
    assert [r["round"] for r in recs] == [0, 1]
    for r in recs:
        assert all(np.isfinite(v).all() for v in r["health"].values())
        assert len(r["health"]["leaf_norms"]) == len(b.layout.leaves)
