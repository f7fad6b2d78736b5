"""The reduced h2o-danube-3-4b at its real head width 120 and the reduced
gemma-7b at 256, with prefill attention routed as on the card: through
``flash_prefill`` and the autograd Function ``ops.FlashAttention`` (its
plain route on the CPU), held against the reference's model on the same
parameters (``convert.lm_params``) and tokens.

* Prefill logits against ``jax.jit(model.prefill)``: atol 0.1, rtol 0.05
  and top-1 agreement on 95 % of positions, tests/test_torch_models.py's
  bar; every layer's attention goes through the Function at its own
  width.
* Loss and every leaf's gradient against ``jax.value_and_grad`` of the
  reference's loss: each bar twice the worst gap measured on the CPU
  (the loss 1.8e-4 / 7.8e-5 relative, the worst leaf 0.0185 / 0.0192 in
  the Frobenius norm, for 120 / 256), as tests/test_torch_train_grads.py
  sets its bars: the port keeps the attention core in fp32 on this
  route, where the reference rounds scores and P to bf16.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import build_model as ref_build_model

from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.models import build_model, layers

B, T = 2, 12
#: arch -> (head width, loss bar, gradient bar)
ARCHS = {"h2o-danube-3-4b": (120, 3.7e-4, 0.037),
         "gemma-7b": (256, 1.6e-4, 0.039)}


def _cfgs(arch):
    width = ARCHS[arch][0]
    return (dataclasses.replace(get_arch(arch).reduced(), head_dim=width),
            dataclasses.replace(configs.get_arch(arch).reduced(),
                                head_dim=width))


def _routed(cfg, calls):
    """The model whose prefill attention goes through the Function,
    recording each call's q shape."""
    def kernel(q, k, v, *, causal):
        calls.append(tuple(q.shape))
        return ops.FlashAttention.apply(q, k, v, causal)
    return build_model(cfg, attention=functools.partial(
        layers.flash_prefill, kernel=kernel))


@functools.cache
def _reference(arch):
    rcfg, _ = _cfgs(arch)
    rm = ref_build_model(rcfg)
    params = rm.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(sum(map(ord, arch)))
    toks = rng.integers(0, rcfg.vocab, (B, T))
    labels = rng.integers(0, rcfg.vocab, (B, T))
    labels[:, ::5] = -1
    logits, _ = jax.jit(rm.prefill)(params, {
        "tokens": jnp.asarray(toks), "caches": rm.init_cache(B, T)})
    batch = {"tokens": toks, "labels": labels}
    (loss, _), grads = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    host = lambda t: jax.tree.map(np.asarray, t)
    return host(params), batch, np.asarray(logits, np.float32), \
        float(loss), host(grads)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_logits_at_the_real_head_width(arch):
    params, batch, want, _, _ = _reference(arch)
    _, pcfg = _cfgs(arch)
    calls = []
    model = _routed(pcfg, calls)
    pparams = convert.lm_params(params, pcfg)
    got, _ = model.prefill(pparams, {
        "tokens": torch.as_tensor(batch["tokens"]),
        "caches": model.init_cache(B, T, "cpu")})
    width, heads = ARCHS[arch][0], pcfg.n_heads
    assert calls == [(B * heads, T, width)] * pcfg.n_layers
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.1,
                               rtol=0.05)
    assert (got.argmax(-1).numpy() == want.argmax(-1)).mean() >= 0.95


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_gradients_at_the_real_head_width(arch):
    params, batch, _, r_loss, r_grads = _reference(arch)
    width, loss_tol, grad_tol = ARCHS[arch]
    _, pcfg = _cfgs(arch)
    calls = []
    model = _routed(pcfg, calls)
    pparams = convert.lm_params(params, pcfg, trainable=True)
    leaves = list(pparams.parameters())
    loss, _ = model.loss(pparams, {k: torch.as_tensor(v)
                                   for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # the forward and its remat, each layer at its own width
    assert calls == [(B * pcfg.n_heads, T, width)] * (2 * pcfg.n_layers)
    assert abs(float(loss.detach()) - r_loss) <= loss_tol * abs(r_loss)
    want = convert.lm_params(r_grads, pcfg, trainable=True)
    gaps = {}
    for (n, w), g in zip(want.named_parameters(), grads):
        w = w.detach()
        g = torch.zeros_like(w) if g is None else g
        den = float(w.norm())
        gaps[n] = float((g - w).norm()) / den if den else float(g.norm())
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= grad_tol, (worst, gaps[worst])
