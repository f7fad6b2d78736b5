"""Gradients of the port's models against the reference's, and the pieces
of the training step around them.

* Loss and every leaf's gradient of all ten reduced archs against
  ``jax.value_and_grad(model.loss)`` of the reference on the same
  parameters (``convert.lm_params(..., trainable=True)``: fp32 masters)
  and batch (labels with masked positions, stub memory where the arch has
  one).  A leaf's gap is ``|g_port - g_ref| / |g_ref|`` in the Frobenius
  norm (the absolute norm where the reference's is 0: cross-attention
  behind a zero gate).  Each arch's bar is twice the worst gap measured on
  this CPU (the same with one thread and with all): bf16 archs 1.5-3.5 %
  (the port rounds each bf16 activation where the reference's code does,
  XLA keeps some sums in fp32 inside its fusions, as for the forward
  logits), RG-LRU 5.7 % (its gates in XLA's excess precision, ROADMAP
  section 3), falcon-mamba's fp32 scan 2e-7.
* The two autograd Functions pass ``torch.autograd.gradcheck`` in fp64 on
  their plain route, and carry gradients through ``flash_prefill`` /
  ``kernel_scan`` to the attention and Mamba input projections.
* ``remat`` changes no gradient; ``microbatches=2`` gives the full
  batch's; the NaN guard skips a step and leaves the state untouched.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_arch
from repro.models import build_model as ref_build_model

from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, layers, ssm
from repro_torch.optim import AdamW
from repro_torch.train.trainer import _nan_guarded

B, T = 2, 12
#: twice the worst leaf gap measured per arch (see the module docstring)
GRAD_TOL = {"yi-6b": 0.036, "gemma-7b": 0.031, "mistral-nemo-12b": 0.037,
            "h2o-danube-3-4b": 0.032, "recurrentgemma-9b": 0.115,
            "falcon-mamba-7b": 4.3e-7, "llama-3.2-vision-90b": 0.058,
            "granite-moe-3b-a800m": 0.040, "mixtral-8x7b": 0.070,
            "whisper-small": 0.037}
#: twice the loss's relative gap measured per arch
LOSS_TOL = {"yi-6b": 1.7e-5, "gemma-7b": 1.3e-4, "mistral-nemo-12b": 1.5e-4,
            "h2o-danube-3-4b": 1.9e-4, "recurrentgemma-9b": 5.4e-5,
            "falcon-mamba-7b": 3e-7, "llama-3.2-vision-90b": 1.5e-3,
            "granite-moe-3b-a800m": 1.6e-4, "mixtral-8x7b": 7.5e-4,
            "whisper-small": 1.4e-3}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T))
    labels = rng.integers(0, cfg.vocab, (B, T))
    labels[:, ::5] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.n_memory:
        batch["memory"] = rng.standard_normal(
            (B, cfg.n_memory, cfg.d_model)).astype(np.float32)
    return batch


def _port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _loss_and_grads(model, params, batch):
    leaves = list(params.parameters())
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]


@functools.cache
def _reference(arch):
    rcfg = get_arch(arch).reduced()
    rm = ref_build_model(rcfg)
    params = rm.init(jax.random.PRNGKey(1))
    batch = _batch(rcfg, sum(map(ord, arch)))
    (loss, _), grads = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    host = lambda t: jax.tree.map(np.asarray, t)
    return host(params), batch, float(loss), host(grads)


def _gap(got, want):
    den = float(want.norm())
    diff = float((got - want).norm())
    return diff / den if den > 0 else diff


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_match_the_reference(arch):
    params, batch, r_loss, r_grads = _reference(arch)
    pcfg = configs.get_arch(arch).reduced()
    pparams = convert.lm_params(params, pcfg, trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in pparams.parameters())
    loss, grads = _loss_and_grads(build_model(pcfg), pparams,
                                  _port_batch(batch))
    assert abs(loss - r_loss) <= LOSS_TOL[arch] * abs(r_loss)
    want = convert.lm_params(r_grads, pcfg, trainable=True)
    gaps = {n: _gap(g, w.detach()) for (n, w), g in
            zip(want.named_parameters(), grads)}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_TOL[arch], (worst, gaps[worst])
    # zero exactly where the reference's are (behind a zero gate)
    for (n, w), g in zip(want.named_parameters(), grads):
        assert bool((g == 0).all()) == bool((w == 0).all()), n


def test_flash_attention_function_gradcheck():
    rng = np.random.default_rng(0)
    for causal, (t, s) in ((True, (5, 5)), (False, (4, 7))):
        q, k, v = (torch.tensor(rng.standard_normal((2, n, 8)),
                                dtype=torch.float64, requires_grad=True)
                   for n in (t, s, s))
        assert torch.autograd.gradcheck(
            lambda q, k, v: ops.FlashAttention.apply(q, k, v, causal),
            (q, k, v))


def test_selective_scan_function_gradcheck():
    rng = np.random.default_rng(1)
    f = lambda *shape: torch.tensor(rng.standard_normal(shape),
                                    dtype=torch.float64)
    args = (f(2, 6, 3), f(2, 6, 3).abs() * 0.1, f(2, 6, 4), f(2, 6, 4),
            -f(3, 4).abs(), f(2, 3, 4))
    assert torch.autograd.gradcheck(
        ops.SelectiveScan.apply, tuple(a.requires_grad_() for a in args))


def _kernel_route(arch):
    """The arch's reduced config, a model whose prefill attention / Mamba
    scan go through the autograd Functions (their plain route on the CPU),
    and the default CPU model (the reference's branches)."""
    cfg = configs.get_arch(arch).reduced()
    if arch == "yi-6b":         # a head width the flash kernel is built for
        cfg = dataclasses.replace(cfg, head_dim=64)
    fn = functools.partial(layers.flash_prefill,
                           kernel=lambda q, k, v, causal:
                           ops.FlashAttention.apply(q, k, v, causal))
    route = {"attention": fn} if arch == "yi-6b" else {
        "scan": functools.partial(ssm.kernel_scan,
                                  kernel=ops.SelectiveScan.apply)}
    return cfg, build_model(cfg, **route), build_model(cfg)


@pytest.mark.parametrize("arch,leaves", [
    ("yi-6b", ("attn.wq", "attn.wk", "attn.wv")),
    ("falcon-mamba-7b", ("mamba.in_proj", "mamba.x_proj", "mamba.dt_proj",
                         "mamba.a_log"))])
def test_gradients_reach_the_projections_through_the_functions(arch, leaves):
    cfg, routed, plain = _kernel_route(arch)
    params = routed.init(0, "cpu", trainable=True)
    batch = _port_batch(_batch(cfg, 3))
    calls = {"n": 0}
    fwd = ops.FlashAttention.forward if arch == "yi-6b" else \
        ops.SelectiveScan.forward

    def counted(ctx, *a):
        calls["n"] += 1
        return fwd(ctx, *a)
    cls = ops.FlashAttention if arch == "yi-6b" else ops.SelectiveScan
    orig = cls.forward
    cls.forward = staticmethod(counted)
    try:
        _, got = _loss_and_grads(routed, params, batch)
    finally:
        cls.forward = orig
    assert calls["n"] == 2 * cfg.n_layers      # forward and its remat
    _, want = _loss_and_grads(plain, params, batch)
    names = [n for n, _ in params.named_parameters()]
    for n, g, w in zip(names, got, want):
        if any(n.endswith(leaf) for leaf in leaves):
            assert float(g.abs().sum()) > 0, n
            # fp32 plain attention / scan against the reference's
            # branches (bf16 products in attention)
            assert _gap(g, w) <= (0.05 if arch == "yi-6b" else 1e-5), n


@pytest.mark.parametrize("arch", ["yi-6b", "recurrentgemma-9b"])
def test_remat_changes_no_gradient(arch):
    cfg = configs.get_arch(arch).reduced()
    assert cfg.remat
    model = build_model(cfg)
    params = model.init(0, "cpu", trainable=True)
    batch = _port_batch(_batch(cfg, 4))
    l1, g1 = _loss_and_grads(model, params, batch)
    l2, g2 = _loss_and_grads(build_model(dataclasses.replace(
        cfg, remat=False)), params, batch)
    assert l1 == l2
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


class _Recorder(AdamW):
    """An optimizer that records the gradients it is given and applies
    nothing."""

    def update(self, grads, state, params, **kw):
        self.grads = [g.clone() for g in grads]
        return params, state, {"grad_norm": torch.tensor(0.0),
                               "lr": torch.tensor(0.0)}


def test_microbatches_give_the_full_batch_gradients():
    """With every label kept, the full batch's loss is the mean of its
    halves': two microbatches give the mean of the halves' gradients and
    losses, bit for bit, and the full batch's within bf16 noise (the
    products round to bf16 and their blocking depends on the rows)."""
    cfg = configs.get_arch("falcon-mamba-7b").reduced()
    model = build_model(cfg)
    params = model.init(0, "cpu", trainable=True)
    batch = _port_batch(_batch(cfg, 5))
    batch["labels"] = torch.as_tensor(np.abs(batch["labels"].numpy()))
    halves = [_loss_and_grads(model, params, {k: v[i:i + 1]
                                               for k, v in batch.items()})
              for i in range(B)]
    full, mb = _Recorder(), _Recorder()
    _, _, m1 = make_train_step(model, full)(params, full.init(params), batch)
    _, _, m2 = make_train_step(model, mb, microbatches=2)(
        params, mb.init(params), batch)
    assert float(m2["tokens"]) == B * T
    assert float(m2["loss"]) == float(torch.tensor(
        (0.0 + halves[0][0]) + halves[1][0], dtype=torch.float32) / 2)
    for i, g in enumerate(mb.grads):
        assert torch.equal(g, (torch.zeros_like(g) + halves[0][1][i]
                               + halves[1][1][i]) / 2)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-3)
    for a, b in zip(mb.grads, full.grads):
        assert _gap(a, b) <= 0.02
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(model, mb, microbatches=3)(
            params, mb.init(params), batch)


def test_nan_guard_skips_and_leaves_the_state():
    cfg = configs.get_arch("yi-6b").reduced()
    model = build_model(cfg)
    opt = AdamW()
    params = model.init(0, "cpu", trainable=True)
    state = opt.init(params)
    step = _nan_guarded(make_train_step(model, opt))
    batch = _port_batch(_batch(cfg, 6))
    params, state, metrics = step(params, state, batch)
    assert metrics["skipped"] is False and state["step"] == 1
    before = [p.detach().clone() for p in params.parameters()]
    moments = [m.clone() for m in state["m"] + state["v"]]
    loss = model.loss
    model.loss = lambda p, b: (lambda l, m: (l * float("nan"), m))(*loss(p, b))
    try:
        params, state, metrics = step(params, state, batch)
    finally:
        model.loss = loss
    assert metrics["skipped"] is True and state["step"] == 1
    assert not np.isfinite(float(metrics["grad_norm"]))
    assert all(torch.equal(a, b) for a, b in zip(before, params.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(moments,
                                                 state["m"] + state["v"]))
