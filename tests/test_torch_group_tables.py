"""The per-client-table round on a group of ranks (``engine.
make_payload_round_steps(group=...)``): the round behind a robust
``--merge_policy``, ``--serve_payload sketch``'s batch twin and the
adversarial fault kinds, with the quarantine, on the CPU: four gloo ranks
started by ``distributed.launch_local``, one launch for the whole file.

Each rank computes its group's W / S per-client tables (W / S sketches a
round), one ordered ``all_gather`` makes the [W, r, c] stack in slot order
on every rank, and the merge runs replicated. What is held, over 3 rounds
of the MLP session at W = 8 on 4 ranks:

- every rank equals the one-device table round at ``client_shards`` 4 (the
  S groups one after another) **bitwise**: params, optimizer state, the
  quarantine's rings and every metric, in a trimmed merge with the clip
  and a 50x client, a median merge under layer-scope quarantine with a
  sign-flipper, the sum under colluders, the trimmed merge's residual
  with a norm-rider, and the wire-payload round with client dropout;
- the one-device round at ``client_shards`` 4 is within atol 1e-5 of the
  reference's single-device table round at ``client_shards`` 4
  (``make_payload_round_steps(mesh=None)``, a ``lax.map`` over the
  groups), with the counts exact, as tests/test_torch_byzantine.py holds
  the table round;
- each rank sketches its W / S clients a round and nothing more.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel.mesh import ClientMesh
from commefficient_tpu_torch.sketch import csvec
from test_torch_distributed import _equal
from test_torch_group_client_state import _jparams, _jsession, _session

torch.set_num_threads(2)

WORLD, NUM_CLIENTS, ROUNDS, LR = 4, 12, 3, 0.05
SKETCH = dict(mode="sketch", k=8, num_rows=3, num_cols=128, momentum=0.9,
              momentum_type="virtual", error_type="virtual")
# name -> session knobs (a fault plan as its text)
CASES = {
    "trimmed_scale_clip": dict(merge_policy="trimmed", merge_trim=1, client_update_clip=3.0,
                               fault_plan="client_scale@1:clients=1,factor=50"),
    "median_signflip_layer": dict(merge_policy="median", client_update_clip=3.0,
                                  quarantine_scope="layer",
                                  fault_plan="client_signflip@1,2:clients=0"),
    "sum_collude": dict(fault_plan="seed=3;client_collude@1,2:frac=0.25"),
    "residual_normride": dict(merge_policy="trimmed", merge_trim=1, robust_residual=True,
                              client_update_clip=3.0,
                              fault_plan="client_normride@1,2:clients=0,ride=0.9"),
    "wire_dropout": dict(wire_payloads=True, client_dropout=0.25),
}


def _run(s):
    return [s.run_round(LR) for _ in range(ROUNDS)]


def _ranks(out_dir):
    """Rank function: every case on the group, counting this rank's
    sketches of a table round."""
    distributed.initialize(force=True, device="cpu")
    rank = dist.get_rank()
    calls = [0]
    sketch_vec = csvec.sketch_vec

    def counted(*a, **kw):
        calls[0] += 1
        return sketch_vec(*a, **kw)

    csvec.sketch_vec = counted
    got = {}
    for name, kw in CASES.items():
        s = _session(NUM_CLIENTS, SKETCH, mesh=ClientMesh(clients=WORLD), **kw)
        calls[0] = 0
        ms = _run(s)
        got[name] = dict(state=s.state, metrics=ms, sketches=calls[0], table=s._table_round,
                         shards=s.cfg.client_shards)
    torch.save(got, os.path.join(out_dir, f"tables_{rank}.pt"))


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tables")
    codes = distributed.launch_local(_ranks, WORLD, (str(out),), timeout_s=300)
    assert codes == [0] * WORLD, codes
    return [torch.load(out / f"tables_{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("name", list(CASES))
def test_group_table_round_equals_the_one_device_groups_bitwise(group_run, name):
    twin = _session(NUM_CLIENTS, SKETCH, client_shards=WORLD, **CASES[name])
    assert twin._table_round and twin.cfg.client_shards == WORLD and twin.group is None
    ms = _run(twin)
    for r, got in enumerate(group_run):
        g = got[name]
        assert g["table"] and g["shards"] == WORLD
        _equal(g["state"], twin.state, f"{name} rank {r}")
        assert g["metrics"] == ms, (name, r)
        # W / S tables a round on each rank, and no other sketch
        assert g["sketches"] == ROUNDS * 8 // WORLD, g["sketches"]
    if "clip" in name:
        assert [m["clients_quarantined"] for m in ms] == [0.0, 1.0, 0.0]
    if name == "wire_dropout":
        assert min(m["participants"] for m in ms) < 8


@pytest.mark.parametrize("name", [n for n in CASES if n != "wire_dropout"])
def test_one_device_groups_within_the_reference_table_round(name):
    """The reference draws its participation from threefry keys, so the
    dropout case is held within the port only."""
    kw = CASES[name]
    t = _session(NUM_CLIENTS, SKETCH, client_shards=WORLD, **kw)
    j = _jsession(NUM_CLIENTS, SKETCH, client_shards=WORLD, **kw)
    assert j.cfg.client_shards == WORLD
    for a, b in zip(_run(j), _run(t)):
        for k in ("participants", "clients_quarantined", "clients_dropped"):
            assert a.get(k) == b.get(k), (k, a, b)
        if "quarantine_median" in a:
            assert b["quarantine_median"] == pytest.approx(a["quarantine_median"], rel=1e-5)
        assert b["loss_sum"] == pytest.approx(a["loss_sum"], rel=1e-5)
    np.testing.assert_allclose(t.state["params"].numpy(), _jparams(j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.state["mode_state"]["Verror"].numpy(),
                               np.asarray(j.state["mode_state"]["Verror"]), rtol=0, atol=1e-5)
