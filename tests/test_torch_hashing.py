"""The port's Count-Sketch hashes are integer-exact against the JAX
package's: int64-with-mask arithmetic must reproduce uint32 wrap-around for
indices up to 2**31 - 1, seeds at and above 2**32, and several row counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.sketch import hashing as jh
from commefficient_tpu.sketch import pallas_kernels as pk
from commefficient_tpu_torch.sketch import csvec as tcs
from commefficient_tpu_torch.sketch import hashing as th

torch.set_num_threads(2)

SEEDS = [0, 42, 2**31 - 1, 2**32, 2**32 + 7, 2**40 + 12345]
ROWS = [1, 4, 5]


def _idx():
    rng = np.random.RandomState(0)
    edge = np.array([0, 1, 2, 1023, 1024, 2**16, 2**24 + 3, 2**31 - 2, 2**31 - 1])
    return np.concatenate([edge, rng.randint(0, 2**31 - 1, size=4000)]).astype(np.int64)


def _j(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return x.numpy().astype(np.int64)


def test_fmix32_integer_exact():
    rng = np.random.RandomState(1)
    x = np.concatenate([[0, 1, 2**31, 2**32 - 1],
                        rng.randint(0, 2**32, size=5000, dtype=np.uint64)]).astype(np.uint32)
    want = _j(jh.fmix32(jnp.asarray(x)))
    got = _t(th.fmix32(torch.from_numpy(x.astype(np.int64))))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("r", ROWS)
def test_row_keys_integer_exact(seed, r):
    jkb, jks = jh.row_keys(seed, r)
    tkb, tks = th.row_keys(seed, r)
    np.testing.assert_array_equal(_t(tkb), _j(jkb))
    np.testing.assert_array_equal(_t(tks), _j(jks))


@pytest.mark.parametrize("seed", [42, 2**32 + 7])
@pytest.mark.parametrize("c", [1000, 1024, 524_288])
def test_bucket_and_sign_hash_integer_exact(seed, c):
    idx = _idx()
    jkb, jks = jh.row_keys(seed, 5)
    tkb, tks = th.row_keys(seed, 5)
    jidx, tidx = jnp.asarray(idx.astype(np.int32)), torch.from_numpy(idx)
    for j in range(5):
        np.testing.assert_array_equal(
            _t(th.bucket_hash(tidx, tkb[j], c)), _j(jh.bucket_hash(jidx, jkb[j], c)))
        np.testing.assert_array_equal(
            th.sign_hash(tidx, tks[j]).numpy(), np.asarray(jh.sign_hash(jidx, jks[j])))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("r", ROWS)
def test_slab_shifts_integer_exact(seed, r):
    for num_slabs, c in [(1, 1024), (13, 524_288), (4, 1000)]:
        want = _j(jh.slab_shifts(seed, r, num_slabs, c))
        got = _t(th.slab_shifts(seed, r, num_slabs, c))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("d,c,r", [(6_573_130, 524_288, 5), (5000, 777, 1), (40000, 4096, 16)])
def test_cached_kernel_keys_equal_the_pallas_kernels_inputs(seed, d, c, r):
    """The CUDA kernels' hash inputs, computed once per (spec, device), are
    bit for bit the Pallas kernels' scalar-prefetch inputs: int32 shifts and
    the uint32 sign keys (held as int32 bit patterns)."""
    spec = tcs.CSVecSpec(d=d, c=c, r=r, seed=seed, family="rotation")
    shifts, ks = tcs._rotation_keys(spec, torch.device("cpu"))
    again = tcs._rotation_keys(spec, torch.device("cpu"))
    assert again[0] is shifts and again[1] is ks
    assert shifts.dtype == ks.dtype == torch.int32
    want_shifts = np.asarray(pk.slab_shifts(seed, r, spec.num_slabs, c).astype(jnp.int32))
    want_ks = np.asarray(pk.row_keys(seed, r)[1])
    np.testing.assert_array_equal(shifts.numpy(), want_shifts)
    assert want_ks.dtype == np.uint32
    np.testing.assert_array_equal(ks.numpy().view(np.uint32), want_ks)
