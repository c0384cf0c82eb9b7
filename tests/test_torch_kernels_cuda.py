"""The port's CUDA sketch kernels on the card: each must equal its plain
PyTorch version bitwise (up to the sign of zero) at edge shapes, count its
launches, and refuse what it does not take. Skips without a GPU; run on the
card with
    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
(the repository's conftest.py sets up JAX, which the GPU machine lacks)."""

import contextlib
import ctypes

import pytest
import torch

from commefficient_tpu_torch.sketch import csvec, kernels

pytestmark = pytest.mark.cuda

TILE = 2048  # buckets or coordinates per block: kTile in csrc/sketch_kernels.cu

# (d, c, r): ragged last slab; d < c; whole slabs; c < TILE; c not a multiple
# of 4; r = 16; c far below TILE; a last slab shorter than TILE (500 of 4096)
SHAPES = [(3000, 1024, 3), (700, 1024, 3), (2048, 1024, 3), (1500, 1000, 4),
          (5000, 777, 1), (40000, 4096, 16), (2500, 300, 2), (8692, 4096, 5)]


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


def test_windows_wrap_in_the_short_last_slab_case():
    """At (8692, 4096, 5) some shift is not a multiple of the tile, so the
    window of some block wraps at the slab end, in every slab."""
    spec = csvec.CSVecSpec(d=8692, c=4096, r=5, seed=11, family="rotation")
    shifts, _ = csvec._rotation_keys(spec, torch.device("cpu"))
    assert spec.d - (spec.num_slabs - 1) * spec.c < TILE
    assert (shifts % TILE != 0).any(dim=0).all()


class _MemLocation(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _AllocFlags(ctypes.Structure):
    _fields_ = [("compressionType", ctypes.c_ubyte), ("gpuDirectRDMACapable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort), ("reserved", ctypes.c_ubyte * 4)]


class _AllocationProp(ctypes.Structure):  # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("requestedHandleTypes", ctypes.c_int),
                ("location", _MemLocation), ("win32HandleMetaData", ctypes.c_void_p),
                ("allocFlags", _AllocFlags)]


class _AccessDesc(ctypes.Structure):  # CUmemAccessDesc
    _fields_ = [("location", _MemLocation), ("flags", ctypes.c_int)]


class _DeviceArray:
    """A float32 [n] array at a raw device address, for torch.as_tensor."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": "<f4",
                                         "data": (ptr, False), "version": 2}


@contextlib.contextmanager
def _guarded(n: int, at: str, device):
    """A float32 [n] tensor that starts (at="start") or ends (at="end") on
    the edge of mapped device memory: the driver's virtual memory API maps
    whole granules in the middle of a reserved address range and leaves a
    granule on either side unmapped, so a read one element past the tensor
    faults. With n not a multiple of 4, an "end" tensor also starts off a
    16-byte boundary."""
    cu = ctypes.CDLL("libcuda.so.1")
    u64, size_t = ctypes.c_uint64, ctypes.c_size_t

    def check(name, *args):
        err = getattr(cu, name)(*args)
        assert err == 0, f"{name} returned CUDA driver error {err}"

    torch.empty(1, device=device)  # the driver and the device's context are up
    index = torch.cuda.current_device() if device.index is None else device.index
    loc = _MemLocation(1, index)  # CU_MEM_LOCATION_TYPE_DEVICE
    prop = _AllocationProp(type=1, location=loc)  # CU_MEM_ALLOCATION_TYPE_PINNED
    gran = size_t()
    check("cuMemGetAllocationGranularity", ctypes.byref(gran), ctypes.byref(prop), 0)
    g = gran.value
    size = -(-4 * n // g) * g
    base, handle = u64(), u64()
    check("cuMemAddressReserve", ctypes.byref(base), size_t(size + 2 * g), size_t(0),
          u64(0), u64(0))
    mapped = base.value + g
    try:
        check("cuMemCreate", ctypes.byref(handle), size_t(size), ctypes.byref(prop), u64(0))
        try:
            check("cuMemMap", u64(mapped), size_t(size), size_t(0), handle, u64(0))
            try:
                access = _AccessDesc(loc, 3)  # CU_MEM_ACCESS_FLAGS_PROT_READWRITE
                check("cuMemSetAccess", u64(mapped), size_t(size), ctypes.byref(access),
                      size_t(1))
                ptr = mapped if at == "start" else mapped + size - 4 * n
                yield torch.as_tensor(_DeviceArray(ptr, n), device=device)
                torch.cuda.synchronize()
            finally:
                check("cuMemUnmap", u64(mapped), size_t(size))
        finally:
            check("cuMemRelease", handle)
    finally:
        check("cuMemAddressFree", base, size_t(size + 2 * g))


@pytest.mark.parametrize("at", ["start", "end"])
@pytest.mark.parametrize("d,c,r", [(40003, 777, 3), (8693, 4096, 16)])
def test_kernels_read_nothing_past_their_inputs(cuda, d, c, r, at):
    """v and the table start or end on the edge of mapped memory: an aligned
    superset read outside either faults at the synchronize."""
    spec = csvec.CSVecSpec(d=d, c=c, r=r, seed=5, family="rotation")
    gen = torch.Generator(device=cuda).manual_seed(d)
    with _guarded(d, at, cuda) as v, _guarded(r * c, at, cuda) as flat:
        table = flat.view(r, c)
        v.copy_(torch.randn(d, generator=gen, device=cuda))
        table.copy_(torch.randn(r, c, generator=gen, device=cuda))
        got_table = csvec.sketch_vec(spec, v)
        got_est = csvec.query_all(spec, table)
        torch.cuda.synchronize()
        assert torch.equal(got_table, csvec._sketch_vec_rotation(spec, v))
        assert torch.equal(got_est, csvec._query_all_rotation(spec, table))


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
