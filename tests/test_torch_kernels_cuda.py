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

from commefficient_tpu_torch.sketch import _build, csvec, kernels, layerwise

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
    assert kernels.launch_counts == {"sketch_accumulate": 1, "sketch_query": 1,
                                     "sketch_accumulate_tree": 0}


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


# (d, c, r, leaf sizes): a leaf that starts mid-slab and spans 3 slabs, a
# 1-element leaf, a last leaf with padding past d; c not a multiple of 4;
# r = 16; c below the tile
LEAF_TREES = [(3000, 1024, 3, (100, 2500, 1, 399)), (5003, 777, 1, (5, 1600, 1, 3397)),
              (40000, 4096, 16, (4096, 1, 30000, 5903)), (2500, 300, 2, (299, 2, 2199))]


def _plain_fold(spec, table, leaves, offsets):
    """The tree kernel's plain version: the per-leaf fold in ravel order."""
    for v, off in zip(leaves, offsets):
        layerwise._accumulate_leaf_rotation(spec, table, v,
                                            layerwise._leaf_block(spec, off, v.numel()))
    return table


def _offsets(sizes):
    return [sum(sizes[:m]) for m in range(len(sizes))]


def _launches(n_leaves):
    return -(-n_leaves // kernels.TREE_MAX_LEAVES)


@pytest.mark.parametrize("d,c,r,sizes", LEAF_TREES)
def test_leaf_kernel_equals_plain_after_every_leaf(cuda, d, c, r, sizes):
    """The whole tree in one launch, and the same leaves one launch each in
    place (``accumulate_leaf``), against the plain fold: after the tree,
    and after every leaf."""
    spec = csvec.CSVecSpec(d=d, c=c, r=r, seed=11, family="rotation")
    v = torch.randn(d, generator=torch.Generator(device=cuda).manual_seed(d), device=cuda)
    leaves = list(torch.split(v, list(sizes)))
    plan = layerwise.make_block_plan(spec, leaves)
    kernels.reset_launch_counts()
    tree = layerwise.sketch_tree(spec, leaves, plan)
    assert kernels.launch_counts["sketch_accumulate_tree"] == 1
    got, want = csvec.zero_table(spec, cuda), csvec.zero_table(spec, cuda)
    for leaf, blk in zip(leaves, plan.blocks):
        layerwise.accumulate_leaf(spec, got, leaf, blk.offset)
        layerwise._accumulate_leaf_rotation(spec, want, leaf, blk)
        assert torch.equal(got, want), blk
    assert kernels.launch_counts["sketch_accumulate_tree"] == 1 + len(sizes)
    assert torch.equal(tree, want)
    assert torch.equal(tree, csvec.sketch_vec(spec, v))


@pytest.mark.parametrize("d,c,r,sizes", LEAF_TREES)
def test_tree_of_separate_leaves_at_every_alignment(cuda, d, c, r, sizes):
    """Each leaf a separate allocation starting at element offset 1, 2, 3,
    1, ... mod 4 (so off the 16 bytes its ravel offset would give it): the
    fold equals the plain fold and sketch_accumulate of the concatenation."""
    spec = csvec.CSVecSpec(d=d, c=c, r=r, seed=7, family="rotation")
    v = torch.randn(d, generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    leaves = []
    for m, (off, n) in enumerate(zip(_offsets(sizes), sizes)):
        k = 1 + m % 3
        leaf = torch.empty(n + 4, device=cuda)[k:k + n]
        assert leaf.data_ptr() % 16 == 4 * k
        leaves.append(leaf.copy_(v[off:off + n]))
    kernels.reset_launch_counts()
    got = layerwise.sketch_tree(spec, leaves)
    assert kernels.launch_counts["sketch_accumulate_tree"] == 1
    assert torch.equal(got, _plain_fold(spec, csvec.zero_table(spec, cuda), leaves,
                                        _offsets(sizes)))
    assert torch.equal(got, csvec.sketch_vec(spec, v))


@pytest.mark.parametrize("c,r", [(1000, 5), (777, 3)])
def test_tree_of_more_leaves_than_one_launch_takes(cuda, c, r):
    """500 leaves of 1-37 coordinates: ceil(500 / TREE_MAX_LEAVES) launches,
    each continuing the fold in place, bitwise the plain fold and
    sketch_accumulate."""
    sizes = torch.randint(1, 38, (500,), generator=torch.Generator().manual_seed(c)).tolist()
    d = sum(sizes)
    spec = csvec.CSVecSpec(d=d, c=c, r=r, seed=5, family="rotation")
    v = torch.randn(d, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    leaves = list(torch.split(v, sizes))
    kernels.reset_launch_counts()
    got = layerwise.sketch_tree(spec, leaves)
    assert kernels.launch_counts["sketch_accumulate_tree"] == _launches(500) > 1
    assert torch.equal(got, _plain_fold(spec, csvec.zero_table(spec, cuda), leaves,
                                        _offsets(sizes)))
    assert torch.equal(got, csvec.sketch_vec(spec, v))


def test_one_leaf_folds_in_place_onto_a_nonzero_table(cuda):
    spec = csvec.CSVecSpec(d=9001, c=777, r=3, seed=5, family="rotation")
    gen = torch.Generator(device=cuda).manual_seed(2)
    table = torch.randn(3, 777, generator=gen, device=cuda)
    leaf = torch.randn(2999, generator=gen, device=cuda)
    want = _plain_fold(spec, table.clone(), [leaf], [1234])
    kernels.reset_launch_counts()
    assert layerwise.accumulate_leaf(spec, table, leaf, 1234) is table
    assert kernels.launch_counts["sketch_accumulate_tree"] == 1
    assert torch.equal(table, want)


def test_fresh_mode_equals_in_place_from_zeros_and_reads_no_table(cuda):
    """fresh=True on a NaN-filled table equals the in-place fold onto zeros,
    so it reads nothing of the table; leaves with gaps between them (and
    before the first, after the last) add nothing there."""
    spec = csvec.CSVecSpec(d=30000, c=2000, r=5, seed=3, family="rotation")
    shifts, ks = csvec._rotation_keys(spec, cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    offsets, sizes = [1234, 5000, 9000, 20000], [3000, 1, 7000, 9999]
    leaves = [torch.randn(n, generator=gen, device=cuda) for n in sizes]
    fresh = kernels.accumulate_tree(torch.full((5, 2000), float("nan"), device=cuda), leaves,
                                    offsets, shifts, ks, 2000, 30000, fresh=True)
    in_place = kernels.accumulate_tree(torch.zeros(5, 2000, device=cuda), leaves, offsets,
                                       shifts, ks, 2000, 30000)
    assert torch.equal(fresh, in_place)
    assert torch.equal(fresh, _plain_fold(spec, csvec.zero_table(spec, cuda), leaves, offsets))


@pytest.mark.parametrize("at", ["start", "end"])
def test_leaf_kernel_reads_nothing_past_its_leaf(cuda, at):
    """Every leaf of a tree starts or ends on the edge of mapped memory (so
    an "end" leaf of odd length also starts off 16 bytes): a read outside
    any leaf faults at the synchronize."""
    spec = csvec.CSVecSpec(d=9001, c=777, r=3, seed=5, family="rotation")
    v = torch.randn(9001, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    offsets, sizes = [0, 1234, 4233, 4234, 8000], [1234, 2999, 1, 3766, 1001]
    with contextlib.ExitStack() as stack:
        leaves = [stack.enter_context(_guarded(n, at, cuda)) for n in sizes]
        for leaf, off, n in zip(leaves, offsets, sizes):
            leaf.copy_(v[off:off + n])
        got = layerwise.sketch_tree(spec, leaves)
        one = layerwise.accumulate_leaf(spec, csvec.zero_table(spec, cuda), leaves[1], 1234)
        torch.cuda.synchronize()
        assert torch.equal(got, csvec.sketch_vec(spec, v))
        assert torch.equal(one, _plain_fold(spec, csvec.zero_table(spec, cuda), [v[1234:4233]],
                                            [1234]))


def test_leaf_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    spec = csvec.CSVecSpec(d=3000, c=1024, r=3, family="rotation")
    shifts, ks = csvec._rotation_keys(spec, cuda)
    table = torch.zeros(3, 1024, device=cuda)
    leaf = torch.randn(100, device=cuda)

    def tree(leaves, offsets, t=table):
        return kernels.accumulate_tree(t, leaves, offsets, shifts, ks, 1024, 3000)

    with pytest.raises(ValueError, match="lie in"):
        tree([leaf], [2950])  # past d
    with pytest.raises(ValueError, match="lie in"):
        tree([leaf], [-1])
    with pytest.raises(ValueError, match="lie in"):
        tree([leaf[:0]], [0])
    with pytest.raises(ValueError, match="previous leaf"):
        tree([leaf, leaf], [500, 0])  # unsorted
    with pytest.raises(ValueError, match="previous leaf"):
        tree([leaf, leaf], [0, 50])  # overlapping
    with pytest.raises(ValueError, match="one offset per leaf"):
        tree([leaf], [0, 100])
    with pytest.raises(ValueError, match="one offset per leaf"):
        tree([], [])
    with pytest.raises(ValueError, match="1-D"):
        tree([leaf.view(10, 10)], [0])
    with pytest.raises(ValueError, match="contiguous"):
        tree([leaf], [0], table.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        tree([torch.randn(200, device=cuda)[::2]], [0])
    with pytest.raises(ValueError, match="float32"):
        tree([leaf.double()], [0])
    with pytest.raises(ValueError, match="must be on"):
        tree([leaf.cpu()], [0])
    with pytest.raises(ValueError, match="shape"):
        tree([leaf], [0], torch.zeros(3, 512, device=cuda))
    # the C entry refuses what the wrapper would: more leaves than a launch
    # takes, unsorted ranges
    lib = _build.load()
    assert lib.sketch_tree_max_leaves() == kernels.TREE_MAX_LEAVES
    n = kernels.TREE_MAX_LEAVES + 1
    arr = (ctypes.c_int64 * (3 * n))(*[leaf.data_ptr()] * n, *range(n), *range(1, n + 1))
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.sketch_accumulate_tree(table.data_ptr(), arr, n, shifts.data_ptr(),
                                      ks.data_ptr(), 3000, 1024, 3, 3, 0, stream) != 0
    arr = (ctypes.c_int64 * 6)(leaf.data_ptr(), leaf.data_ptr(), 500, 0, 600, 100)
    assert lib.sketch_accumulate_tree(table.data_ptr(), arr, 2, shifts.data_ptr(),
                                      ks.data_ptr(), 3000, 1024, 3, 3, 0, stream) != 0
