"""The port's server step and delta apply against the JAX package's, on
identical tables, learning rate and state: FetchSGD's sketch branch and the
uncompressed control must agree bitwise on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.modes import config as jmodes_config
from commefficient_tpu.modes import modes as jmodes
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu_torch.modes import modes as tmodes
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig

torch.set_num_threads(2)


def _cfgs(**kw):
    return JModeConfig(**kw), TModeConfig(**kw)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("momentum_type", ["virtual", "none"])
def test_sketch_server_step_bitwise(momentum_type):
    jc, tc = _cfgs(mode="sketch", d=5000, k=50, num_rows=5, num_cols=1024,
                   momentum_type=momentum_type, seed=7)
    rng = np.random.RandomState(0)
    agg = {"table": _f32(rng, 5, 1024)}
    state = {"Vvelocity": _f32(rng, 5, 1024), "Verror": _f32(rng, 5, 1024)}
    lr = np.float32(0.37)
    jd, js = jmodes.server_step_sparse(jc, _j(agg), _j(state), jnp.float32(lr))
    td, ts = tmodes.server_step_sparse(tc, _t(agg), _t(state), torch.tensor(lr))
    jo, to = np.argsort(np.asarray(jd["idx"])), np.argsort(td["idx"].numpy())
    np.testing.assert_array_equal(td["idx"].numpy()[to], np.asarray(jd["idx"])[jo])
    np.testing.assert_array_equal(td["vals"].numpy()[to], np.asarray(jd["vals"])[jo])
    for k in ("Vvelocity", "Verror"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def test_uncompressed_server_step_bitwise():
    jc, tc = _cfgs(mode="uncompressed", d=3000, momentum_type="virtual",
                   error_type="none")
    rng = np.random.RandomState(1)
    agg = {"dense": _f32(rng, 3000)}
    state = {"Vvelocity": _f32(rng, 3000), "Verror": np.zeros(3000, np.float32)}
    lr = np.float32(0.05)
    jd, js = jmodes.server_step_sparse(jc, _j(agg), _j(state), jnp.float32(lr))
    td, ts = tmodes.server_step_sparse(tc, _t(agg), _t(state), torch.tensor(lr))
    np.testing.assert_array_equal(td["dense"].numpy(), np.asarray(jd["dense"]))
    np.testing.assert_array_equal(ts["Vvelocity"].numpy(), np.asarray(js["Vvelocity"]))


def test_apply_delta_honours_padding_and_out_of_range():
    rng = np.random.RandomState(2)
    p = _f32(rng, 10)
    idx = np.array([-1, 3, 10, 12, 9], dtype=np.int64)
    vals = np.array([5.0, 1.5, 7.0, 8.0, -2.0], dtype=np.float32)
    got = tmodes.apply_delta(torch.from_numpy(p), {"idx": torch.from_numpy(idx),
                                                   "vals": torch.from_numpy(vals)}).numpy()
    want = p.copy()
    want[3] -= 1.5
    want[9] += 2.0
    np.testing.assert_array_equal(got, want)
    jgot = jmodes.apply_delta(jnp.asarray(p), {"idx": jnp.asarray(idx.astype(np.int32)),
                                               "vals": jnp.asarray(vals)})
    np.testing.assert_array_equal(got, np.asarray(jgot))
    dense = _f32(rng, 10)
    np.testing.assert_array_equal(
        tmodes.apply_delta(torch.from_numpy(p), {"dense": torch.from_numpy(dense)}).numpy(),
        p - dense)


def test_aggregate_survivor_mean_matches_reference():
    jc, tc = _cfgs(mode="uncompressed", d=64, momentum_type="none", error_type="none")
    rng = np.random.RandomState(3)
    wires = {"dense": _f32(rng, 4, 64)}
    wires["dense"][2] = np.nan  # a dead client's poison must not leak
    w = np.array([1, 1, 0, 1], np.float32)
    got = tmodes.aggregate(tc, _t(wires), torch.from_numpy(w))["dense"].numpy()
    want = np.asarray(jmodes.aggregate(jc, _j(wires), jnp.asarray(w))["dense"])
    np.testing.assert_array_equal(got, want)


def test_unported_modes_raise():
    """Every mode is ported; what is not (the approximate top-k selections,
    DP, the cohort-fault kinds) raises by name, never runs as something
    else."""
    from commefficient_tpu_torch.resilience import FaultPlan
    from commefficient_tpu_torch.sketch import csvec
    from commefficient_tpu_torch.utils.config import make_parser

    assert make_parser().parse_args([]).mode == "uncompressed"
    for mode in jmodes_config.MODES:
        assert make_parser().parse_args(["--mode", mode]).mode == mode
    x = torch.arange(10, dtype=torch.float32)
    for impl in ("approx", "oversample"):
        cfg = TModeConfig(mode="true_topk", d=10, k=2, topk_impl=impl)
        with pytest.raises(NotImplementedError, match=f"topk_impl='{impl}' is not ported"):
            tmodes.server_step_sparse(cfg, {"dense": x}, tmodes.init_server_state(cfg, "cpu"),
                                      0.1)
        with pytest.raises(NotImplementedError, match=impl):
            csvec.topk_abs(x, 2, impl=impl)
    for flag in ("--dp_noise", "--dp_clip"):
        with pytest.raises(SystemExit):
            make_parser().parse_args([flag, "1.0"])
    for kind in ("client_drop", "client_straggle", "client_poison"):
        with pytest.raises(ValueError, match=kind):
            FaultPlan.parse(f"{kind}@1")
