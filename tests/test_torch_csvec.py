"""The port's plain Count-Sketch operations against the JAX package.

Rotation-family ``sketch_vec``/``query_all`` are ordered adds, rolls, +-1
multiplies and sorts, so on the CPU they must equal the JAX oracle bitwise;
they are also held within 1e-5 of the Pallas TPU kernels run in interpret
mode (as tests/test_pallas.py runs them), at the shapes those kernels take
(c a multiple of 128). The random family's dense accumulate scatters in
another order, so it gets 1e-6. The sparse scatter, point query and masking
tail are bitwise; ``unsketch_topk`` is compared as an index set with equal
values, and ``topk_abs`` index for index (ties go to the lower index, as
``lax.top_k`` orders them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.sketch import csvec as jcs
from commefficient_tpu.sketch import pallas_kernels as pk
from commefficient_tpu_torch.sketch import csvec as tcs

torch.set_num_threads(2)

# (d, c, r): d not a multiple of c; d < c; d = 2c; even r (lower median);
# c not a multiple of 1024 (the JAX oracle takes it, the Pallas kernel not)
ROTATION_SHAPES = [(3000, 1024, 3), (700, 1024, 3), (2048, 1024, 3),
                   (1500, 1024, 4), (1500, 1000, 4)]


def _specs(d, c, r, family="rotation", num_blocks=1, seed=13):
    kw = dict(d=d, c=c, r=r, seed=seed, family=family, num_blocks=num_blocks)
    return jcs.CSVecSpec(**kw), tcs.CSVecSpec(**kw)


def _vec(n, seed=0):
    return np.random.RandomState(seed).standard_normal(n).astype(np.float32)


def _table(d, c, r, seed=1):
    js, _ = _specs(d, c, r)
    return np.array(jcs.sketch_vec(js, jnp.asarray(_vec(d, seed))))


@pytest.mark.parametrize("d,c,r", ROTATION_SHAPES)
def test_rotation_sketch_vec_bitwise_and_pallas(d, c, r):
    js, ts = _specs(d, c, r)
    v = _vec(d)
    got = tcs.sketch_vec(ts, torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcs.sketch_vec(js, jnp.asarray(v))))
    if c % 128 == 0:
        pallas = np.asarray(pk.sketch_vec(js, jnp.asarray(v), interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,c,r", ROTATION_SHAPES)
def test_rotation_query_all_bitwise_and_pallas(d, c, r):
    js, ts = _specs(d, c, r)
    t = _table(d, c, r)
    got = tcs.query_all(ts, torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcs.query_all(js, jnp.asarray(t))))
    if c % 128 == 0:
        pallas = np.asarray(pk.query_all(js, jnp.asarray(t), interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_blocks", [1, 3])
def test_random_family_sketch_vec_within_1e6(num_blocks):
    js, ts = _specs(3000, 512, 5, family="random", num_blocks=num_blocks)
    v = _vec(3000, 2)
    got = tcs.sketch_vec(ts, torch.from_numpy(v)).numpy()
    want = np.array(jcs.sketch_vec(js, jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    q_got = tcs.query_all(ts, torch.from_numpy(want)).numpy()
    np.testing.assert_array_equal(q_got, np.asarray(jcs.query_all(js, jnp.asarray(want))))


@pytest.mark.parametrize("family", ["rotation", "random"])
def test_sparse_query_and_mask_bitwise(family):
    js, ts = _specs(3000, 1024, 5, family=family)
    rng = np.random.RandomState(3)
    idx = rng.choice(3000, size=64, replace=False).astype(np.int64)
    idx[:3] = [-1, 3000, 3005]  # padding and out-of-range entries are ignored
    vals = rng.standard_normal(64).astype(np.float32)
    V, E = _table(3000, 1024, 5, 4), _table(3000, 1024, 5, 5)
    ji, jv = jnp.asarray(idx.astype(np.int32)), jnp.asarray(vals)
    ti, tv = torch.from_numpy(idx), torch.from_numpy(vals)

    np.testing.assert_array_equal(tcs.sketch_sparse(ts, ti, tv).numpy(),
                                  np.asarray(jcs.sketch_sparse(js, ji, jv)))
    q_idx = idx[3:]
    np.testing.assert_array_equal(
        tcs.query(ts, torch.from_numpy(V), torch.from_numpy(q_idx)).numpy(),
        np.asarray(jcs.query(js, jnp.asarray(V), jnp.asarray(q_idx.astype(np.int32)))))
    tV, tE = tcs.mask_transmitted(ts, torch.from_numpy(V), torch.from_numpy(E), ti, tv)
    jV, jE = jcs.mask_transmitted(js, jnp.asarray(V), jnp.asarray(E), ji, jv)
    np.testing.assert_array_equal(tV.numpy(), np.asarray(jV))
    np.testing.assert_array_equal(tE.numpy(), np.asarray(jE))


@pytest.mark.parametrize("family", ["rotation", "random"])
def test_unsketch_topk_same_set_and_values(family):
    js, ts = _specs(5000, 1024, 5, family=family)
    v = _vec(5000, 6)
    v[[10, 999, 4321]] *= 50.0  # heavy hitters
    t = np.array(jcs.sketch_vec(js, jnp.asarray(v)))
    ji, jv = jcs.unsketch_topk(js, jnp.asarray(t), 40)
    ti, tv = tcs.unsketch_topk(ts, torch.from_numpy(t), 40)
    jo, to = np.argsort(np.asarray(ji)), np.argsort(ti.numpy())
    np.testing.assert_array_equal(ti.numpy()[to], np.asarray(ji)[jo])
    np.testing.assert_array_equal(tv.numpy()[to], np.asarray(jv)[jo])


@pytest.mark.parametrize("case", ["zeros", "rounded", "distinct", "signed_ties_and_inf"])
def test_topk_abs_orders_like_lax_top_k(case):
    """The same indices in the same order as ``lax.top_k`` of |x|, ties
    included: FetchSGD's first round (lr 0) selects among exact zeros."""
    rng = np.random.RandomState(3)
    x = {"zeros": np.zeros(1000, np.float32),
         "rounded": np.round(3 * rng.standard_normal(5000)).astype(np.float32),
         "distinct": rng.standard_normal(20000).astype(np.float32),
         "signed_ties_and_inf": np.array([0.0, -0.0, 1.0, -1.0, 1.0, np.inf, -np.inf, 2.0],
                                         np.float32)}[case]
    for k in (1, 7, len(x) // 2, len(x)):
        want = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)[1])
        np.testing.assert_array_equal(tcs.topk_abs(torch.from_numpy(x), k).numpy(), want)


def test_to_dense_ignores_out_of_range():
    idx = np.array([-1, 0, 5, 9, 10, 12], dtype=np.int64)
    vals = np.arange(1, 7, dtype=np.float32)
    got = tcs.to_dense(10, torch.from_numpy(idx), torch.from_numpy(vals)).numpy()
    want = np.asarray(jcs.to_dense(10, jnp.asarray(idx.astype(np.int32)), jnp.asarray(vals)))
    np.testing.assert_array_equal(got, want)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    from commefficient_tpu_torch.sketch import kernels

    kernels.reset_launch_counts()
    _, ts = _specs(3000, 1024, 3)
    t = tcs.sketch_vec(ts, torch.from_numpy(_vec(3000)))
    tcs.query_all(ts, t)
    from commefficient_tpu_torch.sketch import layerwise

    v = torch.from_numpy(_vec(3000))
    assert torch.equal(layerwise.sketch_tree(ts, [v[:1000], v[1000:]]), t)
    assert kernels.launch_counts == {"sketch_accumulate": 0, "sketch_query": 0,
                                     "sketch_accumulate_tree": 0}


def test_kernel_wrappers_reject_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor is refused, never run on a
    plain version behind the caller's back."""
    from commefficient_tpu_torch.sketch import kernels

    _, ts = _specs(3000, 1024, 3)
    shifts, ks = tcs._rotation_keys(ts, "cpu")
    with pytest.raises(ValueError, match="must be on"):
        kernels.accumulate(torch.zeros(3000), shifts, ks, 1024)
    with pytest.raises(ValueError, match="must be on"):
        kernels.query(torch.zeros(3, 1024), shifts, ks, 3000)
    with pytest.raises(ValueError, match="must be on"):
        kernels.accumulate_tree(torch.zeros(3, 1024), [torch.zeros(10)], [0], shifts, ks, 1024,
                                3000)


@pytest.mark.parametrize("d, c, num_blocks",
                         [(200000, 4096, 1), (100000, 64, 1), (120000, 4096, 3)],
                         ids=["one_block", "crowded", "three_blocks"])
def test_random_family_sketch_vec_bitwise_on_eight_threads(d, c, num_blocks):
    """The random family's scatter adds each bucket's entries in index
    order on any number of threads (``csvec.scatter_add_ordered``): ten runs
    at 8 threads each equal the reference bitwise, the dense accumulate and
    the sparse sketch alike. With 3 blocks the reference's scan adds the
    block tables in another association (within 1e-6 above), so there the
    ten runs equal each other bitwise."""
    js, ts = _specs(d, c, 5, family="random", num_blocks=num_blocks)
    v = _vec(d, 4) * np.exp(2 * _vec(d, 5))
    want = np.asarray(jcs.sketch_vec(js, jnp.asarray(v))) if num_blocks == 1 else None
    idx = np.random.RandomState(6).choice(d, d // 3, replace=False).astype(np.int32)
    want_sparse = np.asarray(jcs.sketch_sparse(js, jnp.asarray(idx), jnp.asarray(v[idx])))
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        for _ in range(10):
            got = tcs.sketch_vec(ts, torch.from_numpy(v)).numpy()
            want = got if want is None else want
            np.testing.assert_array_equal(got, want)
            got = tcs.sketch_sparse(ts, torch.from_numpy(idx.astype(np.int64)),
                                    torch.from_numpy(v[idx]))
            np.testing.assert_array_equal(got.numpy(), want_sparse)
    finally:
        torch.set_num_threads(threads)
