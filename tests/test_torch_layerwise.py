"""The port's layerwise sketch path (``sketch/layerwise.py``,
``EngineConfig.sketch_path="layerwise"``) on the CPU, where a table folds
through the plain version of the per-leaf accumulate.

What is held, and how exactly:

- ``sketch_tree`` of a leaf partition equals the reference's
  ``layerwise.sketch_tree`` and the port's ``sketch_vec`` of the raveled
  vector **bitwise**, both hash families, on the reference's grid
  (tests/test_layerwise.py) and edge partitions; ``accumulate_leaf``
  folds in place;
- the block plan and the leaf segments equal the reference's, on
  full-width ResNet-9 and GPT-2 ``TINY``;
- the config errors are the reference's messages;
- the layerwise round equals the port's ravel round **bitwise** over 3
  rounds (params, Vvelocity, Verror, batch-norm statistics and every
  metric) in the reference's ``ENGINE_CASES`` (plain, dropout with the
  non-finite guard, client_chunk, the random family), sharded at S = 2
  and 4, with a NaN-dead client, on full-width ResNet-9 and on GPT-2
  ``TINY`` with dropout; with the quarantine, the rejected client equals
  the dropped one bitwise, and the quarantine's norms equal ravel's;
- the layerwise wire (``engine._compress``: the reduced [d] update's leaf
  slices folded by ``sketch_tree``) equals the ravel wire bitwise, both
  families, on the tiny net, ResNet-9 and GPT-2 ``TINY``;
- the layerwise round matches the reference's RAVEL round within
  tests/test_torch_round.py's tolerances (params, Vvelocity and Verror
  atol 1e-5; metric sums rtol 1e-5), unsharded and sharded (the
  reference's own layerwise round pins fail, so the port is not held to
  them);
- the CLIs' rows under layerwise equal ravel's except ``time_s`` (cv and
  GPT-2 ``TINY``), and a layerwise run preempted and resumed equals the
  uninterrupted run bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.federated import engine as jengine
from commefficient_tpu.models import gpt2 as jgpt2
from commefficient_tpu.models.losses import make_classification_loss as jloss
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
from commefficient_tpu.modes.config import ModeConfig as JModeConfig
from commefficient_tpu.sketch import csvec as jcsvec
from commefficient_tpu.sketch import layerwise as jlayerwise
from commefficient_tpu_torch import cv_train, gpt2_train
from commefficient_tpu_torch.federated import engine as tengine
from commefficient_tpu_torch.models import convert
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models.losses import make_classification_loss as tloss
from commefficient_tpu_torch.models.losses import make_lm_loss as tlm
from commefficient_tpu_torch.models.resnet9 import ResNet9 as TResNet9
from commefficient_tpu_torch.models.resnet9 import init_weights as resnet_init
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.sketch import csvec as tcsvec
from commefficient_tpu_torch.sketch import layerwise as tlayerwise
from test_torch_cohort_faults import _image_batch, _tiny_pair
from test_torch_runner import TINY_PATHS, TinyNet, _argv, _rows, init_tiny, tiny_cv  # noqa: F401
from test_torch_sharded_round import MASK, _assert_round_close, _given_streams


@pytest.fixture(autouse=True)
def _two_threads():
    """This file's tests on two CPU threads, the old count restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)

WD, ROUNDS = 5e-4, 3
LRS = (0.1, 0.05, 0.2)
SKETCH_KW = dict(mode="sketch", k=16, num_rows=3, num_cols=1024, hash_family="rotation",
                 momentum=0.9, momentum_type="virtual", error_type="virtual")


# ------------------------------------------------------------- unit layer


def _partition(flat, sizes, shapes=None):
    leaves, off = [], 0
    for i, n in enumerate(sizes):
        leaf = flat[off:off + n]
        if shapes and shapes[i] is not None:
            leaf = leaf.reshape(shapes[i])
        leaves.append(leaf)
        off += n
    assert off == flat.size
    return leaves


# the reference's grid, then edge partitions: a 1-element leaf and a leaf
# ending one past a slab boundary; a leaf spanning 3 slabs that starts mid-
# slab; c not a multiple of 4 with a leaf in the ragged last slab
GRID = [
    (1000, 64, 3, (37, 200, 463, 300)),
    (777, 1024, 5, (100, 677)),
    (4096, 256, 3, (256, 1024, 2816)),
    (1000, 64, 1, (1, 64, 1, 934)),
    (2000, 300, 16, (150, 700, 1, 1149)),
    (1503, 301, 4, (500, 3, 1000)),
]


@pytest.mark.parametrize("family", ["rotation", "random"])
@pytest.mark.parametrize("d,c,r,sizes", GRID)
def test_sketch_tree_bitwise_the_reference_and_sketch_vec(family, d, c, r, sizes):
    """Leaf-by-leaf == one-shot, bit for bit, multi-dim leaves included
    (read row-major), against the reference's sketch_tree too."""
    flat = np.random.RandomState(0).randn(d).astype(np.float32)
    shapes = [None] * len(sizes)
    if sizes[1] % 4 == 0:
        shapes[1] = (4, sizes[1] // 4)
    leaves = _partition(flat, sizes, shapes)
    tspec = tcsvec.CSVecSpec(d=d, c=c, r=r, seed=13, family=family)
    jspec = jcsvec.CSVecSpec(d=d, c=c, r=r, seed=13, family=family)
    got = tlayerwise.sketch_tree(tspec, [torch.from_numpy(np.ascontiguousarray(x))
                                         for x in leaves])
    want = jax.jit(lambda t: jlayerwise.sketch_tree(jspec, t))(
        {f"l{i:02d}": jnp.asarray(x) for i, x in enumerate(leaves)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tcsvec.sketch_vec(tspec, torch.from_numpy(flat)))


@pytest.mark.parametrize("leaves_as", ["separate", "generator"])
@pytest.mark.parametrize("family", ["rotation", "random"])
@pytest.mark.parametrize("d,c,r,sizes", GRID)
def test_sketch_tree_of_separate_leaves_or_a_generator(leaves_as, family, d, c, r, sizes):
    """Leaves that are separate allocations (no views of one buffer), or a
    generator consumed once, sketch bitwise as the reference's sketch_tree
    and the port's sketch_vec do."""
    flat = np.random.RandomState(3).randn(d).astype(np.float32)
    leaves = _partition(flat, sizes)
    tspec = tcsvec.CSVecSpec(d=d, c=c, r=r, seed=17, family=family)
    jspec = jcsvec.CSVecSpec(d=d, c=c, r=r, seed=17, family=family)
    separate = [torch.tensor(x) for x in leaves]  # a copy each
    got = tlayerwise.sketch_tree(tspec, separate if leaves_as == "separate"
                                 else (t for t in separate))
    want = jax.jit(lambda t: jlayerwise.sketch_tree(jspec, t))(
        {f"l{i:02d}": jnp.asarray(x) for i, x in enumerate(leaves)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tcsvec.sketch_vec(tspec, torch.from_numpy(flat)))


@pytest.mark.parametrize("n,cap", [(1, 160), (26, 160), (148, 160), (160, 160), (161, 160),
                                   (500, 160), (500, 3), (7, 1)])
def test_tree_launches_keep_ravel_order_and_the_cap(n, cap):
    """The tree kernel's launches: consecutive runs of at most ``cap``
    leaves that cover the tree once, in ravel order, ceil(n / cap) of them."""
    from commefficient_tpu_torch.sketch import kernels

    groups = kernels.tree_launches(n, cap)
    assert len(groups) == -(-n // cap)
    assert [m for g in groups for m in g] == list(range(n))
    assert all(1 <= len(g) <= cap for g in groups)
    assert kernels.tree_launches(n) == kernels.tree_launches(n, kernels.TREE_MAX_LEAVES)


@pytest.mark.parametrize("family", ["rotation", "random"])
def test_accumulate_leaf_folds_in_place_and_checks_its_block(family):
    spec = tcsvec.CSVecSpec(d=500, c=64, r=3, seed=5, family=family)
    flat = torch.from_numpy(np.random.RandomState(1).randn(500).astype(np.float32))
    table = tcsvec.zero_table(spec)
    off = 0
    for n in (123, 250, 127):
        assert tlayerwise.accumulate_leaf(spec, table, flat[off:off + n], off) is table
        off += n
    assert torch.equal(table, tcsvec.sketch_vec(spec, flat))
    with pytest.raises(ValueError, match="falls outside"):
        tlayerwise.accumulate_leaf(spec, table, flat[:10], 495)
    with pytest.raises(ValueError, match="expected table"):
        tlayerwise.accumulate_leaf(spec, torch.zeros(3, 32), flat[:10], 0)
    plan = tlayerwise.make_block_plan(spec, [flat[:100], flat[100:]])
    with pytest.raises(ValueError, match="plan says"):
        tlayerwise.sketch_tree(spec, [flat[:99], flat[99:]], plan)
    with pytest.raises(ValueError, match="block plan covers"):
        tlayerwise.make_block_plan(spec, [flat[:99]])


def _resnet_pair():
    jparams = jax.eval_shape(lambda: JResNet9(num_classes=10).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))["params"]
    return jparams, TResNet9(num_classes=10)


def _gpt2_pair():
    jparams = jax.eval_shape(lambda: jgpt2.GPT2LMHead(jgpt2.TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), train=False))["params"]
    return jparams, tgpt2.GPT2LMHead(tgpt2.TINY)


@pytest.mark.parametrize("pair", [_resnet_pair, _gpt2_pair], ids=["resnet9", "gpt2_tiny"])
def test_block_plan_and_leaf_segments_equal_the_reference(pair):
    jparams, tmodel = pair()
    layout = convert.FlatLayout(tmodel)
    d = ravel_pytree(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jparams))[0].size
    assert layout.d == d
    assert tlayerwise.leaf_segments(layout) == jlayerwise.leaf_segments(jparams)
    for c in (1000, 524_288):
        jplan = jlayerwise.make_block_plan(jcsvec.CSVecSpec(d=d, c=c, r=5), jparams)
        tplan = tlayerwise.make_block_plan(tcsvec.CSVecSpec(d=d, c=c, r=5), layout)
        assert [dataclasses.astuple(b) for b in tplan.blocks] == \
            [dataclasses.astuple(b) for b in jplan.blocks]
        assert tplan.d == jplan.d == d


CONFIG_ERRORS = [
    ("not_sketch", dict(mode="uncompressed", momentum_type="none", error_type="none"), {}),
    ("random_blocked", dict(mode="sketch", k=8, num_rows=3, num_cols=32,
                            hash_family="random", num_blocks=4), {}),
    ("bogus", dict(mode="sketch", k=8, num_rows=3, num_cols=32), dict(sketch_path="bogus")),
    ("wire_payloads", dict(mode="sketch", k=8, num_rows=3, num_cols=32),
     dict(wire_payloads=True)),
    ("robust", dict(mode="sketch", k=8, num_rows=3, num_cols=32),
     dict(merge_policy="median")),
]


@pytest.mark.parametrize("name,mode_kw,eng_kw", CONFIG_ERRORS, ids=[c[0] for c in CONFIG_ERRORS])
def test_config_errors_are_the_references(name, mode_kw, eng_kw):
    kw = {"sketch_path": "layerwise", **eng_kw}
    msgs = []
    for ecfg, mcfg in ((jengine.EngineConfig, JModeConfig), (tengine.EngineConfig, TModeConfig)):
        with pytest.raises(ValueError) as ei:
            ecfg(mode=mcfg(d=100, **mode_kw), **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "sketch_path" in msgs[1]


# ------------------------------------------------------------- engine layer


def _tiny(monkeypatch):
    monkeypatch.setattr(convert, "flax_path", TINY_PATHS.__getitem__)
    model = TinyNet()
    init_tiny(model, 0)
    return model, tloss(model, True), convert.FlatLayout(model), {}


def _resnet(monkeypatch):
    model = TResNet9(num_classes=10)
    resnet_init(model, 0)
    state = {k: v.detach().clone() for k, v in model.named_buffers()}
    return model, tloss(model, True), convert.FlatLayout(model), state


def _gpt2(monkeypatch):
    model = tgpt2.GPT2LMHead(dataclasses.replace(tgpt2.TINY, vocab_size=261, n_positions=16,
                                                 dropout=0.1))
    tgpt2.init_weights(model, 0)
    return model, tlm(model, train=True), convert.FlatLayout(model), {}


def _batches(kind, W, rounds=ROUNDS, dead=()):
    """Round batches from seeds; the ``dead`` clients of round 1 hold NaN
    inputs behind a zero validity."""
    rng = np.random.RandomState(11)
    out = []
    for i in range(rounds):
        if kind == "gpt2":
            ids = rng.randint(0, 261, (W, 2, 16)).astype(np.int32)
            b = {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                 "labels": np.where(rng.rand(W, 2, 16) < 0.3, -100, ids).astype(np.int32)}
        else:
            b = {"x": rng.standard_normal((W, 2, 32, 32, 3)).astype(np.float32),
                 "y": rng.randint(0, 10, (W, 2)).astype(np.int32),
                 "mask": np.ones((W, 2), np.float32)}
        b["_valid"] = np.ones(W, np.float32)
        if i == 1:
            for w in dead:
                b["_valid"][w] = 0.0
                if "x" in b:
                    b["x"][w] = np.nan
        out.append({k: torch.from_numpy(v) for k, v in b.items()})
    return out


def _run(build, mode_kw, eng_kw, sketch_path, W, shards=1, dead=(), kind="image",
         batches=None):
    """3 rounds of the port's round (or its sharded emulation) from one
    state: (final state, per-round metrics)."""
    mp = pytest.MonkeyPatch()
    try:
        model, loss, layout, net_state = build(mp)
        cfg = tengine.EngineConfig(mode=TModeConfig(d=layout.d, **mode_kw), weight_decay=WD,
                                   seed=3, client_shards=shards, sketch_path=sketch_path,
                                   **eng_kw)
        p0 = layout.flatten({k: v.detach() for k, v in model.named_parameters()})
        state = tengine.init_server_state(cfg, p0, net_state, layout)
        step = (tengine.make_sharded_round_step(loss, cfg, layout) if shards > 1
                else tengine.make_round_step(loss, cfg, layout))
        out = []
        for b, lr in zip(batches or _batches(kind, W, dead=dead), LRS):
            state, _, m = step(state, b, {}, torch.tensor(lr))
            out.append(m)
        return state, out
    finally:
        mp.undo()


def _assert_bitwise(a, b):
    (sa, ma), (sb, mb) = a, b
    assert torch.equal(sa["params"], sb["params"])
    for part in ("mode_state", "net_state"):
        assert sa[part].keys() == sb[part].keys()
        for k in sa[part]:
            assert torch.equal(sa[part][k], sb[part][k]), (part, k)
    for ra, rb in zip(ma, mb):
        assert ra.keys() == rb.keys()
        for k in ra:
            assert torch.equal(ra[k], rb[k]), k


# c as d // parts + extra: one slab past d, two, a few, many (c odd or not
# a multiple of 4 at some model each)
WIRE_COLS = [(1, 13), (2, 0), (5, 1), (60, 3), (300, 1)]


@pytest.mark.parametrize("family", ["rotation", "random"])
@pytest.mark.parametrize("parts,extra", WIRE_COLS, ids=[f"d_over_{p}" for p, _ in WIRE_COLS])
@pytest.mark.parametrize("build", [_tiny, _gpt2], ids=["tiny", "gpt2_tiny"])
def test_layerwise_wire_is_the_ravel_wire(monkeypatch, build, parts, extra, family):
    """The round's layerwise wire (``engine._compress`` with the model's
    block plan: the reduced [d] update's leaf slices folded into the
    running table) equals the ravel wire (``sketch_vec`` of the whole
    update) bitwise, on a heavy-tailed update of each model (full-width
    ResNet-9 runs in the round cases)."""
    _, _, layout, _ = build(monkeypatch)
    d = layout.d
    mcfg = TModeConfig(d=d, mode="sketch", k=8, num_rows=5 if family == "rotation" else 3,
                       num_cols=d // parts + extra, hash_family=family)
    cfg = tengine.EngineConfig(mode=mcfg, sketch_path="layerwise")
    plan = tengine._block_plan(cfg, layout)
    assert [(b.offset, b.size) for b in plan.blocks] == list(tlayerwise.leaf_segments(layout))
    rng = np.random.RandomState(parts)
    w = torch.from_numpy((rng.standard_normal(d) * np.exp(3 * rng.standard_normal(d)))
                         .astype(np.float32))
    got = tengine._compress(mcfg, w, plan)
    want = tengine._compress(mcfg, w, None)
    assert got.keys() == want.keys() == {"table"}
    assert torch.equal(got["table"], want["table"])


# (id, model, mode knobs, engine knobs, W, shards, dead clients): the
# reference's ENGINE_CASES, then sharded, a dead client and the models
ROUND_CASES = [
    ("plain", _tiny, {}, {}, 8, 1, ()),
    ("dropout_guard", _tiny, {}, dict(client_dropout=0.25, on_nonfinite="skip"), 8, 1, ()),
    ("chunked", _tiny, {}, dict(client_chunk=2), 8, 1, ()),
    ("random_family", _tiny, dict(hash_family="random"), {}, 8, 1, ()),
    ("sharded_2", _tiny, {}, dict(client_dropout=0.25, on_nonfinite="skip"), 8, 2, ()),
    ("sharded_4_chunked", _tiny, {}, dict(client_chunk=1), 8, 4, ()),
    ("dead_client", _tiny, {}, dict(on_nonfinite="skip"), 8, 1, (2, 5)),
    ("sum_agg", _tiny, dict(agg_op="sum"), {}, 4, 1, ()),
    ("resnet9", _resnet, dict(num_cols=65_536, num_rows=5, k=500), {}, 2, 1, ()),
    ("gpt2_dropout", _gpt2, dict(num_cols=4096, k=64), dict(client_dropout=0.25), 4, 1, ()),
]


@pytest.mark.parametrize("name,build,mode_kw,eng_kw,W,shards,dead", ROUND_CASES,
                         ids=[c[0] for c in ROUND_CASES])
def test_layerwise_round_bitwise_the_ravel_round(name, build, mode_kw, eng_kw, W, shards, dead):
    mode_kw = {**SKETCH_KW, **mode_kw}
    kind = "gpt2" if build is _gpt2 else "image"
    batches = _batches(kind, W, dead=dead)
    ravel = _run(build, mode_kw, eng_kw, "ravel", W, shards, batches=batches)
    lw = _run(build, mode_kw, eng_kw, "layerwise", W, shards, batches=batches)
    _assert_bitwise(ravel, lw)
    assert ravel[0]["round"] == lw[0]["round"] == ROUNDS
    if dead:
        assert float(lw[1][1]["participants"]) == W - len(dead)
        assert float(lw[1][1]["nonfinite_rounds"]) == 0.0


def test_layerwise_quarantine_rejected_equals_dropped(monkeypatch):
    """A NaN client at round 2 is quarantined on the layerwise path, and
    that run equals the run with the client dropped by its validity,
    bitwise; it equals the ravel run bitwise too, the quarantine's norms
    (the running medians and windows) included. Layer scope."""
    eng = dict(client_update_clip=3.0, quarantine_scope="layer", quarantine_window=2)

    def batches(poison):
        bs = _batches("image", 8)
        if poison:
            bs[2]["x"][3] = float("nan")
        else:
            bs[2]["_valid"][3] = 0.0
        return bs

    q = _run(_tiny, SKETCH_KW, eng, "layerwise", 8, batches=batches(True))
    dropped = _run(_tiny, SKETCH_KW, eng, "layerwise", 8, batches=batches(False))
    ravel = _run(_tiny, SKETCH_KW, eng, "ravel", 8, batches=batches(True))
    assert [float(m["clients_quarantined"]) for m in q[1]] == [0.0, 0.0, 1.0]
    assert torch.equal(q[0]["params"], dropped[0]["params"])
    for k in ("Vvelocity", "Verror"):
        assert torch.equal(q[0]["mode_state"][k], dropped[0]["mode_state"][k])
    _assert_bitwise(ravel, q)
    assert ravel[0]["quarantine"].keys() == q[0]["quarantine"].keys()
    for k, v in ravel[0]["quarantine"].items():
        assert torch.equal(q[0]["quarantine"][k], v), k


def test_layerwise_health_block_reads_the_leaves(monkeypatch):
    """An armed health round on the layerwise path equals the ravel
    round's bitwise, every key: the port keeps the reduced [d] update on
    both paths, so the per-leaf norms, the true norm and the true top-k
    mass read it (the reference's layerwise block has no true top-k
    mass)."""
    out = {}
    for path in ("ravel", "layerwise"):
        batches = _batches("image", 8, rounds=1)
        batches[0][tengine.HEALTH_KEY] = torch.ones(8)
        out[path] = _run(_tiny, SKETCH_KW, dict(health=True), path, 8, batches=batches)[1][0]
    r, lw = out["ravel"], out["layerwise"]
    assert {"health/leaf_norms", "health/grad_norm_true", "health/topk_mass_true"} <= r.keys()
    assert lw.keys() == r.keys()
    for k, v in lw.items():
        assert torch.equal(v, r[k]), k


@pytest.mark.parametrize("shards", [1, 2])
def test_layerwise_round_matches_the_reference_ravel_round(monkeypatch, shards):
    """One layerwise round of the tiny twins against the reference's ravel
    round (its sharded emulation at S = 2), mask given to both, within
    tests/test_torch_round.py's tolerances."""
    monkeypatch.setattr(convert, "flax_path", TINY_PATHS.__getitem__)
    fmodel, params, tmodel = _tiny_pair()
    layout = convert.FlatLayout(tmodel)
    _given_streams(monkeypatch, layout.d)
    W = 8
    batch = _image_batch(W)
    batch["_valid"] = np.ones(W, np.float32)
    eng = dict(client_dropout=0.25, on_nonfinite="skip", client_shards=shards)
    jcfg = jengine.EngineConfig(mode=JModeConfig(d=layout.d, **SKETCH_KW), weight_decay=WD,
                                **eng)
    tcfg = tengine.EngineConfig(mode=TModeConfig(d=layout.d, **SKETCH_KW), weight_decay=WD,
                                sketch_path="layerwise", **eng)
    jmake = jengine.make_sharded_round_step if shards > 1 else jengine.make_round_step
    jnew, _, jm = jax.jit(jmake(jloss(fmodel, True), jcfg))(
        jengine.init_server_state(jcfg, params, {}), jax.tree.map(jnp.asarray, batch), {},
        jnp.float32(0.1), jax.random.PRNGKey(0))
    tmake = tengine.make_sharded_round_step if shards > 1 else tengine.make_round_step
    p0 = layout.flatten({k: v.detach() for k, v in tmodel.named_parameters()})
    tnew, _, tm = tmake(tloss(tmodel, True), tcfg, layout)(
        tengine.init_server_state(tcfg, p0, {}), {k: torch.from_numpy(v) for k, v in
                                                   batch.items()}, {}, 0.1)
    assert float(tm["participants"]) == MASK.sum()
    _assert_round_close(tnew, tm, jnew, jm, p0.numpy(), SKETCH_KW)


def test_session_refuses_a_table_round_under_layerwise(monkeypatch):
    from commefficient_tpu_torch.data.cifar import load_cifar_fed
    from commefficient_tpu_torch.federated.api import FederatedSession
    from commefficient_tpu_torch.resilience import FaultPlan

    model, loss, layout, _ = _tiny(monkeypatch)
    train, _, _ = load_cifar_fed("cifar10", 16, False, "/nonexistent", 0, synthetic_train=64,
                                 synthetic_test=8)
    with pytest.raises(ValueError, match="layerwise accumulation has no per-client wire"):
        FederatedSession(loss, loss, dict(model.named_parameters()), {}, layout,
                         TModeConfig(d=layout.d, **SKETCH_KW), train, num_workers=8,
                         local_batch_size=2, device="cpu", sketch_path="layerwise",
                         fault_plan=FaultPlan.parse("client_signflip@1:clients=0"))


# --------------------------------------------------------------- CLI layer


@pytest.mark.parametrize("task", ["cv", "gpt2"])
def test_cli_rows_layerwise_equal_ravel(request, tmp_path, task):
    """Both CLIs, 4 rounds with an eval every 2: the rows (but time_s) and
    the final state of --sketch_path layerwise equal ravel's."""
    if task == "cv":
        request.getfixturevalue("tiny_cv")
        main = cv_train.main
        argv = _argv(("--num_rounds", "4", "--eval_every", "2", "--num_workers", "4"), "sketch")
    else:
        main = gpt2_train.main
        argv = ["--model_size", "tiny", "--seq_len", "16", "--num_clients", "12",
                "--num_workers", "2", "--local_batch_size", "2", "--num_rounds", "4",
                "--eval_every", "2", "--eval_batch_size", "8", "--mode", "sketch", "--k",
                "500", "--num_cols", "8192", "--data_root", "/nonexistent", "--device", "cpu"]
    runs = {}
    for path in ("ravel", "layerwise"):
        log = str(tmp_path / f"{path}.jsonl")
        runs[path] = (main(argv + ["--sketch_path", path, "--log_jsonl", log]), _rows(log))
    (sr, rows_r), (sl, rows_l) = runs["ravel"], runs["layerwise"]
    assert sl.cfg.sketch_path == "layerwise" and sr.cfg.sketch_path == "ravel"
    assert [r["round"] for r in rows_l] == [2, 4] and rows_l == rows_r
    assert torch.equal(sl.state["params"], sr.state["params"])
    for k in ("Vvelocity", "Verror"):
        assert torch.equal(sl.state["mode_state"][k], sr.state["mode_state"][k])


def test_cli_layerwise_resume_is_bitwise(tiny_cv, tmp_path):  # noqa: F811
    """A layerwise run preempted at round 2 and resumed ends bitwise on
    the uninterrupted layerwise run, its last eval row included."""
    argv = _argv(("--num_rounds", "4", "--eval_every", "4", "--sketch_path", "layerwise"),
                 "sketch")
    whole = cv_train.main(argv + ["--log_jsonl", str(tmp_path / "a.jsonl")])
    ck = ["--checkpoint_dir", str(tmp_path / "ck"), "--fault_plan", "preempt@2"]
    with pytest.raises(SystemExit) as ei:
        cv_train.main(argv + ck)
    assert ei.value.code == 75
    res = cv_train.main(argv + ck + ["--resume", "--log_jsonl", str(tmp_path / "b.jsonl")])
    assert res.round == whole.round == 4 and res.cfg.sketch_path == "layerwise"
    assert torch.equal(res.state["params"], whole.state["params"])
    for k in ("Vvelocity", "Verror"):
        assert torch.equal(res.state["mode_state"][k], whole.state["mode_state"][k])
    # the train-loss window of the resumed run starts at the resume round
    last = [_rows(tmp_path / f"{x}.jsonl")[-1] for x in "ab"]
    assert [{k: r[k] for k in ("round", "test_loss", "test_acc", "comm_mb")} for r in last] == \
        [{k: last[0][k] for k in ("round", "test_loss", "test_acc", "comm_mb")}] * 2
