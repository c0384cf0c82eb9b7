"""The port's client mesh (``commefficient_tpu_torch/parallel/mesh.py``)
against the JAX package's ``parallel/mesh.py``: ``parse_mesh_spec`` and
``merge_comm_bytes`` are value-equal to the reference's over a grid, with
every one of its error messages (exact); the shard order is row-major over
(slices, clients) as the reference's ``_shard_index``, and a rank's
coordinates over (slices, clients, seq, model) are where the reference's
``make_mesh`` puts that device; the CLIs' mesh agrees with the job's rank
count or raises."""

import argparse

import jax
import pytest

from commefficient_tpu.parallel import mesh as jmesh
from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel import mesh as tmesh

GOOD_SPECS = ["clients=8", "clients=4,slices=2", " clients = 2 , slices = 3 ", "slices=2,clients=1",
              "clients=1", "clients=16,", ",clients=3"]
BAD_SPECS = ["", "clients", "clients=0", "clients=-2", "clients=x", "slices=2",
             "clients=2,clients=4", "model=2,clients=2", "seq=2", "clients=2,slices=0",
             "clients=2;slices=2", "clients=2,slices"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_mesh_spec_equals_the_reference(spec):
    assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_mesh_spec_errors_equal_the_reference(spec):
    """Every error case raises ValueError with the reference's message,
    word for word."""
    with pytest.raises(ValueError) as want:
        jmesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError) as got:
        tmesh.parse_mesh_spec(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shards", [0, 1, 2, 3, 4, 8, 64])
def test_merge_comm_bytes_equals_the_reference(shards):
    """Over ResNet-9's and GPT-2's shapes and small ones: every key equal
    (the same float64 arithmetic)."""
    for r, c, d in [(5, 524_288, 6_573_130), (5, 1_000_000, 85_453_056), (1, 16, 100),
                    (3, 2000, 98_666)]:
        assert tmesh.merge_comm_bytes(shards, r, c, d) == jmesh.merge_comm_bytes(shards, r, c, d)


def test_client_mesh_shape_shards_and_row_major_order():
    flat, hybrid = tmesh.ClientMesh(clients=8), tmesh.ClientMesh(clients=4, slices=2)
    assert (flat.shards, hybrid.shards) == (8, 8)
    assert tmesh.client_shards(hybrid) == 8
    assert flat.shape == {"clients": 8}
    assert hybrid.shape == {"slices": 2, "clients": 4}
    # row-major over (slices, clients): slice r // clients, client r % clients
    assert [hybrid.shard_index(r) for r in range(8)] == list(range(8))
    for r in range(8):
        s, c = divmod(r, 4)
        assert hybrid.shard_index(r) == s * 4 + c
    with pytest.raises(ValueError, match="outside"):
        hybrid.shard_index(8)
    for bad in (dict(clients=0), dict(clients=2, slices=0), dict(clients=1.5)):
        with pytest.raises(ValueError, match="positive int"):
            tmesh.ClientMesh(**bad)


def test_mesh_info_keys_equal_the_reference():
    """The start-up line's keys and values, as the reference's
    ``mesh_info`` gives them for the same shape."""
    assert distributed.mesh_info(tmesh.ClientMesh(clients=4, slices=2)) == {
        "axes": {"slices": 2, "clients": 4}, "client_shards": 8, "merge_crosses_dcn": True}
    assert distributed.mesh_info(tmesh.ClientMesh(clients=4)) == {
        "axes": {"clients": 4}, "client_shards": 4, "merge_crosses_dcn": False}


def _args(mesh="", num_devices=0):
    return argparse.Namespace(mesh=mesh, num_devices=num_devices)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_cli_mesh_follows_the_rank_count(world):
    """No flag: one shard per rank of the job (none for one process);
    --num_devices 0 or the rank count; --mesh whose shard count is the rank
    count."""
    m = tmesh.mesh_from_args(_args(), world)
    assert (m is None) if world == 1 else (m == tmesh.ClientMesh(clients=world))
    assert tmesh.mesh_from_args(_args(num_devices=world), world) == m
    assert tmesh.mesh_from_args(_args(mesh=f"clients={world}"), world) == tmesh.ClientMesh(world)


@pytest.mark.parametrize("args, world", [(_args(mesh="clients=4"), 1),
                                         (_args(mesh="clients=2,slices=2"), 2),
                                         (_args(mesh="clients=2"), 4),
                                         (_args(num_devices=2), 1),
                                         (_args(num_devices=1), 4)])
def test_cli_mesh_disagreeing_with_the_ranks_raises(args, world):
    """A --mesh or --num_devices that names another rank count raises, as
    the reference's ``make_mesh_from_spec`` raises when too few devices are
    visible."""
    with pytest.raises(ValueError, match="rank"):
        tmesh.mesh_from_args(args, world)


@pytest.mark.parametrize("sizes", [dict(clients=2, seq=2, model=2), dict(clients=1, model=2),
                                   dict(clients=2, slices=2, seq=2),
                                   dict(clients=1, seq=4, model=2)])
def test_seq_and_model_axes_follow_the_reference(sizes):
    """Axes outermost first (slices, clients, seq, model), a rank's
    coordinates row-major with model innermost, as the reference's
    ``make_mesh`` lays its devices out; the cohort splits over slices x
    clients; every axis group holds the ranks that differ only along it;
    the start-up line's keys equal the reference's ``mesh_info``."""
    from commefficient_tpu.parallel.distributed import mesh_info as jmesh_info

    m = tmesh.ClientMesh(**sizes)
    ref = jmesh.make_mesh(m.ranks, model_parallel=m.model, num_slices=m.slices,
                          seq_parallel=m.seq)
    assert distributed.mesh_info(m) == jmesh_info(ref)
    assert m.ranks == ref.devices.size and m.shards == jmesh.client_shards(ref)
    for r in range(m.ranks):
        c = m.coords(r)
        # the reference puts its r-th device at these coordinates
        assert ref.devices[tuple(c[a] for a in ref.axis_names)] == jax.devices()[r]
        assert m.shard_index(r) == c["slices"] * m.clients + c["clients"]
    for axis in ("clients", "seq", "model"):
        groups = m.axis_ranks(axis)
        assert sorted(r for g in groups for r in g) == list(range(m.ranks))
        along = ("slices", "clients") if axis == "clients" else (axis,)
        for g in groups:
            cs = [m.coords(r) for r in g]
            assert all({a: v for a, v in c.items() if a not in along}
                       == {a: v for a, v in cs[0].items() if a not in along} for c in cs)


def test_seq_and_model_flags_size_the_mesh():
    args = argparse.Namespace(mesh="", num_devices=0, model_parallel=2, seq_parallel=2)
    assert tmesh.mesh_from_args(args, 8) == tmesh.ClientMesh(clients=2, seq=2, model=2)
    args.mesh = "clients=1,slices=2"
    assert tmesh.mesh_from_args(args, 8) == tmesh.ClientMesh(clients=1, slices=2, seq=2,
                                                             model=2)
    with pytest.raises(ValueError, match=r"x model_parallel=2 x seq_parallel=2\) needs 8"):
        tmesh.mesh_from_args(args, 4)
    args.mesh = ""
    with pytest.raises(ValueError, match="6 devices not divisible"):
        tmesh.mesh_from_args(args, 6)
