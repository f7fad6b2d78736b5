"""The plain reference against the port at a test's size, on the
benchmark's seeded weights: the loss, every gradient and one AdamW step.

The port runs its products in bf16; here its compute type is set to fp32
(``COMPUTE_DTYPE`` in each model module), so both sides compute the same
function in fp32 and differ only in the order of their sums.
"""
import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.drivers.train import arch_config
from perfbench.reference import common
from perfbench.stream import ZipfStream
from perfbench.tests import tiny

SEED = 2 ** 31 + 77


@pytest.fixture
def fp32_port(monkeypatch):
    from repro_torch.models import layers, model, moe, ssm, transformer
    for mod in (layers, model, moe, ssm, transformer):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def both(workload):
    """(cell, leaves, the port's model and parameters, the reference's
    parameters, a batch), from the same seeded weights."""
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import ParamTree

    cell = tiny.cell(workload)
    leaves = weights.layout(cell.config)
    vals = weights.make(leaves, SEED, "cpu")
    model = build_model(arch_config(cell.config))
    params = ParamTree(weights.tree(leaves, [v.clone() for v in vals]),
                       trainable=True)
    ref = {leaf.name: v.clone().requires_grad_() for leaf, v in
           zip(leaves, vals)}
    tr = cell.traffic
    batch = ZipfStream(SEED, tr["seq_len"], tr["batch"], cell.config["vocab"]
                       ).global_batch_at(0)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return cell, leaves, model, params, ref, batch


@pytest.mark.parametrize("workload", list(tiny.CELLS))
def test_loss_and_gradients(workload, fp32_port):
    cell, leaves, model, params, ref, batch = both(workload)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    ref_loss = common.loss_and_grads(ref, cell.config, batch,
                                     common.Precision("fp32"))
    # fp32 on both sides; only the order of the sums differs
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    for leaf, g in zip(leaves, grads):
        want = ref[leaf.name].grad
        # each leaf's gradient to 1e-4 of its norm: sums over the
        # batch, the heads and the scan's chunks taken in other orders
        assert float(torch.linalg.vector_norm(g - want)) <= \
            1e-4 * float(torch.linalg.vector_norm(want)) + 1e-10, leaf.name


@pytest.mark.parametrize("workload", list(tiny.CELLS))
def test_one_adamw_step(workload, fp32_port):
    from repro_torch.optim import AdamW, AdamWConfig

    from perfbench.drivers.train import OPTIMIZER_KEYS

    cell, leaves, model, params, ref, batch = both(workload)
    common.loss_and_grads(ref, cell.config, batch, common.Precision("fp32"))
    grads = [ref[leaf.name].grad.clone() for leaf in leaves]
    opt = cell.traffic["optimizer"]
    port = AdamW(AdamWConfig(**{k: opt[k] for k in OPTIMIZER_KEYS}))
    port.update(grads, port.init(params), params,
                ndims=model.reference_ndims(params))
    # the reference's decay rule is the port's
    assert [common.decayed(leaf.name, len(leaf.shape)) for leaf in leaves] \
        == [nd >= 2 for nd in model.reference_ndims(params)]
    norms = common.adamw(ref, {}, opt, lambda k: common.decayed(
        k, len(ref[k].shape)))
    np.testing.assert_allclose(
        norms, [float(torch.linalg.vector_norm(g)) * min(
            1.0, opt["grad_clip"] / float(torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(x) for x in grads]))))
            for g in grads], rtol=1e-5)
    for leaf, p in zip(leaves, params.parameters()):
        # the same gradients into the same formula: fp32 rounding of p
        torch.testing.assert_close(p.detach(), ref[leaf.name].detach(),
                                   rtol=0, atol=1e-7, msg=leaf.name)


def test_fp8_control_rounds_products():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    r = common.Precision("fp8").value(x)
    rel = float(torch.linalg.vector_norm(r - x) / torch.linalg.vector_norm(x))
    # e4m3 keeps 3 mantissa bits: about 2 ** -5 relative, far above fp32
    assert 5e-3 < rel < 5e-2
    assert torch.equal(common.Precision("fp32").value(x), x)
