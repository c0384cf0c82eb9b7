"""The port's CUDA sketch kernels on the card: each must equal its plain
PyTorch version bitwise (up to the sign of zero) at edge shapes, count its
launches, and refuse what it does not take. Skips without a GPU; run on the
card with
    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
(the repository's conftest.py sets up JAX, which the GPU machine lacks)."""

import pytest
import torch

from commefficient_tpu_torch.sketch import csvec, kernels

pytestmark = pytest.mark.cuda

SHAPES = [(3000, 1024, 3), (700, 1024, 3), (2048, 1024, 3), (1500, 1000, 4),
          (5000, 777, 1), (40000, 4096, 16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("d,c,r", SHAPES)
def test_kernels_equal_plain_versions(cuda, d, c, r):
    spec = csvec.CSVecSpec(d=d, c=c, r=r, seed=11, family="rotation")
    v = torch.randn(d, generator=torch.Generator(device=cuda).manual_seed(d), device=cuda)
    kernels.reset_launch_counts()
    table = csvec.sketch_vec(spec, v)
    assert torch.equal(table, csvec._sketch_vec_rotation(spec, v))
    assert torch.equal(csvec.query_all(spec, table), csvec._query_all_rotation(spec, table))
    assert kernels.launch_counts == {"sketch_accumulate": 1, "sketch_query": 1}


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    spec = csvec.CSVecSpec(d=3000, c=1024, r=3, family="rotation")
    shifts, ks = csvec._rotation_keys(spec, cuda)
    v = torch.randn(3000, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        kernels.accumulate(v.double(), shifts, ks, 1024)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.accumulate(torch.randn(6000, device=cuda)[::2], shifts, ks, 1024)
    with pytest.raises(ValueError, match="shape"):
        kernels.accumulate(v, shifts[:, :2].contiguous(), ks, 1024)
    with pytest.raises(ValueError, match="r <= 16"):
        kernels.query(torch.zeros(17, 1024, device=cuda), shifts, ks, 3000)
