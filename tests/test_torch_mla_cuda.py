"""DeepSeek-V2-Lite's blocks on the card: a reduced configuration whose
latent attention keeps the published head widths (query/key 128 + 64,
value 128: width 192, run on the attention kernels' compiled width 256)
trained a few steps through ``Trainer`` and the kernels, with the
``flash_attention`` kernels (forward, backward) doing every attention call
and the plain ``attention_any`` none; the dropless held-expert layer
against its CPU twin on the same inputs; and one step's loss and
gradients against the CPU twin of the whole model.

Tolerances: the card and the CPU both compute in bf16 products with fp32
sums, in other orders and with other kernels (the flash kernel's bf16
P), so outputs agree to bf16 rounding carried through three layers:
``TOL`` of the reference's norm.  Routing is fp32 on both and picks the
same pairs (the counter's increments are equal).

Needs a CUDA card; run with ``pytest -m cuda tests/test_torch_mla_cuda.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import build_model, layers, moe

pytestmark = pytest.mark.cuda

TOL = 2e-2
#: published widths of the attention, all else small; 4 of 16 experts held
CFG = dataclasses.replace(
    get_arch("deepseek-v2-lite"), name="deepseek-v2-lite-card", n_layers=3,
    pattern=("mla_dense", "mla_moe", "mla_moe"), d_model=256, n_heads=2,
    kv_lora_rank=64, d_ff=64, dense_d_ff=256, shared_d_ff=128,
    router_experts=16, n_experts=4, expert_offset=4, moe_top_k=3, vocab=512)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def test_held_experts_against_the_cpu_twin(card):
    """The dropless layer on equal inputs: the same pairs routed (the
    counter's increments), its output and the gradients of its input and
    every weight."""
    gen = torch.Generator().manual_seed(7)
    d, n = 256, 4
    p = {"router": torch.randn(d, 16, generator=gen) / 16,
         "w_up": torch.randn(n, d, 64, generator=gen) / 16,
         "w_down": torch.randn(n, 64, d, generator=gen) / 8,
         "w_gate": torch.randn(n, d, 64, generator=gen) / 16,
         "shared": {"w_up": torch.randn(d, 128, generator=gen) / 16,
                    "w_down": torch.randn(128, d, generator=gen) / 11,
                    "w_gate": torch.randn(d, 128, generator=gen) / 16}}
    x = torch.randn(2, 512, d, generator=gen).to(torch.bfloat16)
    dy = torch.randn(2, 512, d, generator=gen)
    flat = lambda t: [(k, v) for k, v in t.items() if not isinstance(v, dict)] \
        + [(k + "." + j, w) for k, v in t.items() if isinstance(v, dict)
           for j, w in v.items()]
    runs = []
    for dev in ("cpu", card):
        leaf = lambda t: t.detach().to(dev).requires_grad_()
        q = {k: (leaf(v) if not isinstance(v, dict) else
                 {j: leaf(w) for j, w in v.items()}) for k, v in p.items()}
        xd = leaf(x)
        moe.flush_expert_pairs()
        before = [moe.EXPERT_PAIRS.value(expert=str(e)) for e in range(4, 8)]
        y, _ = moe.moe_apply_held(q, xd, top_k=3, offset=4)
        moe.flush_expert_pairs()
        after = [moe.EXPERT_PAIRS.value(expert=str(e)) for e in range(4, 8)]
        leaves = [xd] + [v for _, v in flat(q)]
        grads = torch.autograd.grad((y.float() * dy.to(dev)).sum(), leaves)
        runs.append((y, [a - b for a, b in zip(after, before)], grads))
    (want, n_cpu, g_cpu), (got, n_card, g_card) = runs
    assert n_card == n_cpu and sum(n_card) > 0
    assert got.dtype == torch.bfloat16 and got.device.type == "cuda"
    assert _rel(got, want) < TOL
    for name, a, b in zip(["x"] + [k for k, _ in flat(p)], g_card, g_cpu):
        assert _rel(a, b) < TOL, name


def test_train_through_the_kernels(card, monkeypatch, tmp_path):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def no_plain(*a, **k):
        raise AssertionError("attention_any ran on the card")
    monkeypatch.setattr(layers, "attention_any", no_plain)
    tcfg = TrainerConfig(steps=6, seq_len=256, global_batch=2, ckpt_every=100,
                         ckpt_dir=str(tmp_path), log_every=100, seed=3,
                         optimizer=AdamWConfig(peak_lr=3e-3, warmup_steps=1))
    trainer = Trainer(CFG, tcfg, "cuda")
    fwd, bwd = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    trainer.train(log=lambda s: None)
    losses = [r["loss"] for r in trainer.history]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert not any(r["skipped"] for r in trainer.history)
    assert losses[-1] < losses[0]
    # 3 layers a step: the forward and the recompute, one backward call
    assert ops.flash_attention.launches - fwd == 6 * 3 * 2
    assert ops.flash_attention_bwd.launches - bwd == 6 * 3


def test_one_step_against_the_cpu_twin(card):
    model = build_model(CFG)
    params = model.init(5, "cpu", trainable=True)
    gen = torch.Generator().manual_seed(9)
    tok = torch.randint(0, CFG.vocab, (2, 256), generator=gen)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    out = []
    for dev in ("cpu", card):
        p = params.to(dev)
        loss, _ = model.loss(p, {k: v.to(dev) for k, v in batch.items()})
        out.append((loss, torch.autograd.grad(loss, list(p.parameters()))))
    (l_cpu, g_cpu), (l_card, g_card) = out
    assert float(l_card.detach()) == pytest.approx(float(l_cpu.detach()),
                                                   rel=TOL)
    names = [n for n, _ in params.named_parameters()]
    for name, a, b in zip(names, g_card, g_cpu):
        # each leaf's gradient within 5 TOL of its norm: bf16 rounding of
        # three layers' activations on two devices; a router's within a
        # half: a token whose top-3 choice is a near tie can route
        # differently on the two devices' inputs, which moves whole rows
        # of the router's gradient (the layer alone, on equal inputs, is
        # held to TOL above)
        bar = 0.5 if name.endswith("moe.router") else 5 * TOL
        assert _rel(a, b) < bar, name
