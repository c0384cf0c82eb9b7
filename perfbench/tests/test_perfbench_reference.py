"""The plain reference against the port's own plain versions at small
sizes on the CPU: the flat layout, the sketch's hashes and estimates, and
the models' losses and gradients."""

import pytest
import torch

from commefficient_tpu_torch.models.convert import FlatLayout
from commefficient_tpu_torch.sketch import csvec
from perfbench import harness, inputs
from perfbench.reference import layout as rlayout
from perfbench.reference.models import LOSSES
from perfbench.reference.sketch import Sketch

from .tiny import TINY_GPT2, TINY_RESNET9

GPT2_SMALL = dict(TINY_GPT2, vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                  n_head=12)


@pytest.mark.parametrize("cfg", [TINY_RESNET9, TINY_GPT2, GPT2_SMALL],
                         ids=["resnet9", "gpt2-tiny", "gpt2-small"])
def test_layout_is_the_ports(cfg):
    model, _, _ = harness._model(cfg, "float32")
    port = FlatLayout(model)
    ref = rlayout.leaves(cfg)
    assert [(leaf.name, leaf.offset, leaf.size) for leaf in port.leaves] == \
        [(leaf.name, leaf.offset, leaf.size) for leaf in ref]
    flat = torch.randn(port.d)
    ours = rlayout.unflatten(flat, ref)
    for name, t in port.unflatten(flat).items():
        assert torch.equal(ours[name], t)
    assert torch.equal(rlayout.flatten(ours, ref), flat)


@pytest.mark.parametrize("d, c, seed", [(10_000, 1024, 7), (70_001, 4096, 2**31 + 5)])
def test_sketch_matches_the_ports_plain_version(d, c, seed):
    spec = csvec.CSVecSpec(d=d, c=c, r=5, seed=seed, family="rotation")
    sk = Sketch(d, c, 5, seed)
    v = torch.randn(d, generator=torch.Generator().manual_seed(1))
    ours = sk.sketch(v)
    theirs = csvec.sketch_vec(spec, v)
    torch.testing.assert_close(ours, theirs.double(), rtol=0, atol=1e-5)
    # the estimates of the port's table, bitwise the median it takes
    assert torch.equal(sk.estimates(theirs.double()).float(), csvec.query_all(spec, theirs))


@pytest.mark.parametrize("cfg", [TINY_RESNET9, TINY_GPT2], ids=["resnet9", "gpt2"])
def test_model_loss_and_gradient_match_the_ports(cfg):
    torch.manual_seed(0)
    data = inputs.make_data(dict(cfg, data=dict(cfg["data"], num_examples=4, num_clients=2)),
                            3, torch.device("cpu"))
    flat = inputs.make_weights(cfg, 3, torch.device("cpu"))
    model, port_loss, _ = harness._model(cfg, "float32")
    layout = FlatLayout(model)
    ref_params = {k: t.requires_grad_(True) for k, t in
                  rlayout.unflatten(flat, rlayout.leaves(cfg)).items()}
    if cfg["model"] == "resnet9":
        batch = {"x": torch.from_numpy(data["x"][:2]), "y": torch.from_numpy(data["y"][:2])}
        port_batch = dict(batch, mask=torch.ones(2))
        net_state = {k: (torch.ones if k.endswith("running_var") else torch.zeros)(b.shape)
                     for k, b in model.named_buffers()}
    else:
        batch = {k: torch.from_numpy(v[:2]) for k, v in data.items()}
        port_batch, net_state = batch, {}
    loss, loss_sum, _ = LOSSES[cfg["model"]](ref_params, batch, cfg)
    g_ref = torch.autograd.grad(loss, list(ref_params.values()))
    port_params = {k: t.requires_grad_(True) for k, t in layout.unflatten(flat).items()}
    p_loss, aux = port_loss(port_params, net_state, port_batch)
    g_port = dict(zip(port_params, torch.autograd.grad(p_loss, list(port_params.values()))))
    torch.testing.assert_close(loss, p_loss, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss_sum, aux["metrics"]["loss_sum"], rtol=1e-5, atol=1e-5)
    for name, g in zip(ref_params, g_ref):
        torch.testing.assert_close(g, g_port[name], rtol=1e-4, atol=1e-6)

