"""The port's baseline modes against the JAX package's, function by
function on identical numpy inputs, on the CPU: every branch of
``server_step_sparse`` (true_topk, local_topk with virtual or no error,
fedavg/localSGD, and the sketched server state of true_topk and
local_topk), local_topk's ``client_compress`` with client rows, the
sparse-wire ``aggregate``, ``delta_support``, the dense ``server_step``
and the client-state allocation. All of these are the same sequence of
float32 operations in both packages, so every comparison is bitwise (top-k
indices in the same order, ties included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.modes import modes as jmodes
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu_torch.modes import modes as tmodes
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig

torch.set_num_threads(2)

D, K = 5000, 64


def _cfgs(**kw):
    return JModeConfig(**kw), TModeConfig(**kw)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _assert_wire_equal(tw: dict, jw: dict):
    assert tw.keys() == jw.keys()
    for k in tw:
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]), err_msg=k)


def _server_case(kw: dict, lr: float, zeros: bool = False, seed: int = 0):
    """Both packages' server step on one aggregate and state; returns
    (torch delta, torch state, jax delta, jax state)."""
    jc, tc = _cfgs(d=D, k=K, seed=7, **kw)
    rng = np.random.RandomState(seed)
    shape = jmodes.init_server_state(jc)["Vvelocity"].shape
    agg = {"dense": np.zeros(D, np.float32) if zeros else _f32(rng, D)}
    state = {"Vvelocity": np.zeros(shape, np.float32) if zeros else _f32(rng, *shape),
             "Verror": np.zeros(shape, np.float32) if zeros else _f32(rng, *shape)}
    jd, js = jmodes.server_step_sparse(jc, _j(agg), _j(state), jnp.float32(lr))
    td, ts = tmodes.server_step_sparse(tc, _t(agg), _t(state), torch.tensor(np.float32(lr)))
    return td, ts, jd, js


DENSE_STATE = {
    "true_topk-virtual-virtual": dict(mode="true_topk", momentum_type="virtual",
                                      error_type="virtual"),
    "true_topk-virtual-none": dict(mode="true_topk", momentum_type="virtual",
                                   error_type="none"),
    "true_topk-none-virtual": dict(mode="true_topk", momentum_type="none",
                                   error_type="virtual"),
    "local_topk-virtual-virtual": dict(mode="local_topk", momentum_type="virtual",
                                       error_type="virtual"),
    "local_topk-virtual-none": dict(mode="local_topk", momentum_type="virtual",
                                    error_type="none"),
    "local_topk-local-local": dict(mode="local_topk", momentum_type="local",
                                   error_type="local", num_clients=4),
    "fedavg-virtual": dict(mode="fedavg", momentum_type="virtual", error_type="none"),
    "fedavg-server_lr": dict(mode="fedavg", momentum_type="none", error_type="none",
                             server_lr=0.5),
    "localSGD-local": dict(mode="localSGD", momentum_type="local", error_type="none",
                           num_local_iters=3),
}


@pytest.mark.parametrize("case", list(DENSE_STATE))
def test_dense_state_server_step_bitwise(case):
    td, ts, jd, js = _server_case(DENSE_STATE[case], lr=0.37)
    _assert_wire_equal(td, jd)
    _assert_wire_equal(ts, js)


@pytest.mark.parametrize("mode", ["true_topk", "local_topk"])
def test_first_round_at_lr_zero_selects_like_lax_top_k(mode):
    """FetchSGD's schedule starts at lr 0, where the error vector is all
    exact zeros: the release must pick the same k zeros, in the same order,
    as ``lax.top_k``."""
    kw = dict(mode=mode, momentum_type="virtual", error_type="virtual")
    td, ts, jd, js = _server_case(kw, lr=0.0, zeros=True)
    np.testing.assert_array_equal(td["idx"].numpy(), np.asarray(jd["idx"]))
    np.testing.assert_array_equal(td["idx"].numpy(), np.arange(K))
    _assert_wire_equal(ts, js)
    # and on a dense vector with exact zeros among its values
    x = np.zeros(D, np.float32)
    x[::7] = np.random.RandomState(1).standard_normal(len(x[::7])).astype(np.float32)
    ti, tv = tmodes.topk_dense(torch.from_numpy(x), 2000)
    ji, jv = jmodes.topk_dense(jnp.asarray(x), 2000)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


SKETCH_STATE = {
    "true_topk-virtual": dict(mode="true_topk", momentum_type="virtual",
                              error_type="virtual"),
    "true_topk-noerror": dict(mode="true_topk", momentum_type="virtual", error_type="none"),
    "local_topk-virtual": dict(mode="local_topk", momentum_type="virtual",
                               error_type="virtual"),
}


@pytest.mark.parametrize("cols", [1024, 8192])  # c < d and c >= d
@pytest.mark.parametrize("case", list(SKETCH_STATE))
def test_sketch_state_server_step_bitwise(case, cols):
    kw = dict(SKETCH_STATE[case], server_state="sketch", num_rows=5, num_cols=cols,
              hash_family="rotation")
    td, ts, jd, js = _server_case(kw, lr=0.37)
    assert tuple(ts["Vvelocity"].shape) == (5, cols)
    _assert_wire_equal(td, jd)
    _assert_wire_equal(ts, js)


@pytest.mark.parametrize("case", ["true_topk-virtual", "local_topk-virtual"])
def test_sketch_state_at_c_ge_d_equals_dense_state(case):
    """With c >= d every rotation row is a signed permutation, so the
    sketched state releases exactly the dense state's delta (the
    reference's own pin): from zero state, over two rounds."""
    kw = dict(SKETCH_STATE[case], d=D, k=K, seed=7)
    dense = TModeConfig(**kw)
    sk = TModeConfig(**kw, server_state="sketch", num_rows=3, num_cols=8192,
                     hash_family="rotation")
    sd, ss = tmodes.init_server_state(dense, "cpu"), tmodes.init_server_state(sk, "cpu")
    rng = np.random.RandomState(4)
    for lr in (0.2, 0.3):
        agg = {"dense": torch.from_numpy(_f32(rng, D))}
        dd, sd = tmodes.server_step_sparse(dense, agg, sd, lr)
        ds, ss = tmodes.server_step_sparse(sk, agg, ss, lr)
        np.testing.assert_array_equal(ds["idx"].numpy(), dd["idx"].numpy())
        np.testing.assert_array_equal(ds["vals"].numpy(), dd["vals"].numpy())


@pytest.mark.parametrize("mom,err", [("local", "local"), ("none", "local"),
                                     ("local", "none"), ("virtual", "virtual")])
def test_local_topk_client_compress_with_rows_bitwise(mom, err):
    jc, tc = _cfgs(mode="local_topk", d=D, k=K, momentum_type=mom, error_type=err,
                   num_clients=3)
    rng = np.random.RandomState(5)
    trow = tmodes.empty_client_row(tc)
    assert trow.keys() == jmodes.empty_client_row(jc).keys()
    row = {k: _f32(rng, D, scale=0.3) for k in trow}
    for _ in range(2):  # the second call starts from the first's rows
        u = _f32(rng, D)
        jw, jrow = jmodes.client_compress(jc, jnp.asarray(u), _j(row))
        tw, trow = tmodes.client_compress(tc, torch.from_numpy(u), _t(row))
        _assert_wire_equal(tw, jw)
        _assert_wire_equal(trow, jrow)
        row = {k: np.asarray(v) for k, v in jrow.items()}


def test_local_topk_aggregate_of_sparse_wires_bitwise():
    jc, tc = _cfgs(mode="local_topk", d=D, k=K, momentum_type="none", error_type="none")
    rng = np.random.RandomState(6)
    W = 4
    idx = np.stack([rng.choice(D, K, replace=False) for _ in range(W)]).astype(np.int64)
    idx[1, -3:] = -1  # padding contributes nothing
    wires = {"idx": idx, "vals": _f32(rng, W, K)}
    wires["vals"][2] = np.nan  # a dead client's poison must not leak
    w = np.array([1, 1, 0, 1], np.float32)
    for weights in (None, w):
        jw = jmodes.aggregate(jc, {"idx": jnp.asarray(idx.astype(np.int32)),
                                   "vals": jnp.asarray(wires["vals"])},
                              None if weights is None else jnp.asarray(weights))
        tw = tmodes.aggregate(tc, _t(wires), None if weights is None
                              else torch.from_numpy(weights))
        if weights is None:
            assert np.isnan(tw["dense"].numpy()).any()
            np.testing.assert_array_equal(np.isnan(tw["dense"].numpy()),
                                          np.isnan(np.asarray(jw["dense"])))
        else:
            _assert_wire_equal(tw, jw)


@pytest.mark.parametrize("case", ["true_topk-virtual-virtual", "local_topk-virtual-none",
                                  "fedavg-virtual"])
def test_delta_support_and_dense_server_step_match(case):
    jc, tc = _cfgs(d=D, k=K, seed=7, **DENSE_STATE[case])
    rng = np.random.RandomState(8)
    agg = {"dense": _f32(rng, D)}
    agg["dense"][:100] = 0.0
    state = {"Vvelocity": np.zeros(D, np.float32), "Verror": np.zeros(D, np.float32)}
    jdelta, js = jmodes.server_step(jc, _j(agg), _j(state), jnp.float32(0.1))
    tdelta, ts = tmodes.server_step(tc, _t(agg), _t(state), 0.1)
    np.testing.assert_array_equal(tdelta.numpy(), np.asarray(jdelta))
    _assert_wire_equal(ts, js)
    jdw, _ = jmodes.server_step_sparse(jc, _j(agg), _j(state), jnp.float32(0.1))
    tdw, _ = tmodes.server_step_sparse(tc, _t(agg), _t(state), 0.1)
    assert float(tmodes.delta_support(D, tdw)) == float(jmodes.delta_support(D, jdw))


@pytest.mark.parametrize("mom,err", [("local", "local"), ("none", "local"), ("local", "none"),
                                     ("virtual", "virtual")])
def test_client_state_allocation_matches(mom, err):
    jc, tc = _cfgs(mode="local_topk", d=300, k=8, momentum_type=mom, error_type=err,
                   num_clients=5)
    js, ts = jmodes.init_client_state(jc), tmodes.init_client_state(tc)
    if js is None:
        assert ts is None and not tc.needs_local_state
        return
    assert ts.keys() == js.keys()
    for k in ts:
        assert tuple(ts[k].shape) == js[k].shape == (5, 300)
        assert not ts[k].any()
    with pytest.raises(ValueError, match="num_clients > 0"):
        tmodes.init_client_state(tc, 0)
