"""The port's optimizer (``repro_torch.optim``) against the reference's on
seeded numpy inputs: the warmup+cosine schedule and AdamW's update (fp32
state, clip, bias correction, decay) at rtol 1e-6 over several steps, from
a fresh state and from the reference's own state carried across
(``convert.adamw_state``); the global norm, the clip and the vector
no-decay rule bit for bit where the inputs make every order of summation
exact; the NaN skip; int8 block quantization bit for bit; and the
error-feedback compressed all-reduce over a ``torch.distributed`` gloo
group of one against the reference's over a one-member axis.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_arch
from repro.models import build_model as ref_build_model
from repro.optim import AdamW as RefAdamW
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import compressed_allreduce as ref_allreduce
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import dequantize_int8 as ref_dequantize
from repro.optim import quantize_int8 as ref_quantize

import repro_torch.optim as port_optim
from repro_torch import configs, convert
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.optim import (AdamW, AdamWConfig, compressed_allreduce,
                               cosine_schedule, dequantize_int8, quantize_int8)

RTOL = 1e-6
SHAPES = {"w": (24, 16), "emb": (40, 8), "scale": (16,), "bias": (8,),
          "cube": (3, 5, 7)}


def _close_to_scale(got, want, what):
    """rtol 1e-6, with an absolute floor of 1e-6 of the leaf's largest
    value: a moment is a running sum of terms of both signs, and a one-ulp
    gap in the clip scale (the norm's sum order) moves an element that has
    nearly cancelled by more than 1e-6 of itself."""
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _port_params(tree):
    return tf.ParamTree({k: torch.tensor(v) for k, v in tree.items()},
                        trainable=True)


def _named(params):
    return {n: p.detach().numpy() for n, p in params.named_parameters()}


def test_all_names_exported():
    import repro.optim as ref_optim
    assert port_optim.__all__ == ref_optim.__all__


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (100, 10_000)])
def test_cosine_schedule(warmup, total):
    steps = np.arange(0, total + 20, max(1, total // 37))
    kw = dict(peak_lr=3e-4, warmup=warmup, total=total)
    want = np.asarray(ref_cosine(jnp.asarray(steps), **kw))
    got = cosine_schedule(torch.as_tensor(steps), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert float(cosine_schedule(7, **kw)) == pytest.approx(
        float(ref_cosine(7, **kw)), rel=RTOL)


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_the_reference(clip):
    rng = np.random.default_rng(0)
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip)
    ref, port = RefAdamW(RefAdamWConfig(**cfg)), AdamW(AdamWConfig(**cfg))
    params = _tree(rng)
    r_params = {k: jnp.asarray(v) for k, v in params.items()}
    r_state = ref.init(r_params)
    p_params = _port_params(params)
    p_state = port.init(p_params)
    names = [n for n, _ in p_params.named_parameters()]
    for _ in range(4):
        grads = _tree(rng, scale=3.0)
        r_params, r_state, r_stats = ref.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, r_state, r_params)
        p_params, p_state, p_stats = port.update(
            [torch.tensor(grads[n]) for n in names], p_state, p_params)
        got = _named(p_params)
        for n in names:
            np.testing.assert_allclose(got[n], np.asarray(r_params[n]),
                                       rtol=RTOL, atol=1e-7, err_msg=n)
        for mom in ("m", "v"):
            for n, m in zip(names, p_state[mom]):
                _close_to_scale(m.numpy(), np.asarray(r_state[mom][n]), n)
        np.testing.assert_allclose(float(p_stats["grad_norm"]),
                                   float(r_stats["grad_norm"]), rtol=RTOL)
        assert float(p_stats["lr"]) == float(r_stats["lr"])
        assert p_state["step"] == int(r_state["step"])


def test_adamw_from_the_reference_state():
    """One update of a reduced model's parameters from the reference's
    AdamW state after two of its updates, carried across."""
    cfg = get_arch("falcon-mamba-7b").reduced()
    pcfg = configs.get_arch("falcon-mamba-7b").reduced()
    params = ref_build_model(cfg).init(jax.random.PRNGKey(3))
    opt = RefAdamW(RefAdamWConfig(peak_lr=1e-2, warmup_steps=1,
                                  total_steps=10))
    state = opt.init(params)
    rng = np.random.default_rng(1)
    noise = lambda: jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
        params)
    for _ in range(2):
        params, state, _ = opt.update(noise(), state, params)
    grads = noise()
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    p_params = convert.lm_params(np_tree(params), pcfg, trainable=True)
    p_state = convert.adamw_state(np_tree(state), pcfg)
    assert p_state["step"] == 2
    p_grads = [p.detach() for p in convert.lm_params(
        np_tree(grads), pcfg, trainable=True).parameters()]
    new_params, new_state, _ = opt.update(grads, state, params)
    ndims = build_model(pcfg).reference_ndims(p_params)
    by_name = dict(zip((n for n, _ in p_params.named_parameters()), ndims))
    assert by_name["stack.layers.0.ln.scale"] == 2     # stacked [G, D]
    assert by_name["ln_final.scale"] == 1
    AdamW(AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10)).update(
        p_grads, p_state, p_params, ndims=ndims)
    want = convert.lm_params(np_tree(new_params), pcfg, trainable=True)
    want_m = convert.adamw_state(np_tree(new_state), pcfg)
    for (n, got), w in zip(p_params.named_parameters(), want.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), w.detach().numpy(),
                                   rtol=RTOL, atol=1e-7, err_msg=n)
    for mom in ("m", "v"):
        for got, w in zip(p_state[mom], want_m[mom]):
            _close_to_scale(got.numpy(), w.numpy(), mom)
    assert p_state["step"] == want_m["step"] == 3


def test_norm_clip_and_vector_no_decay_bit_for_bit():
    """Gradients of powers of two: every leaf's sum of squares and their
    total are exact in any order, so the norm, the clip scale and the
    clipped moments agree bit for bit; zero gradients leave 1-D leaves
    exactly as they were (no decay) and decay the others."""
    params = {"w": np.full((4, 16), 0.5, np.float32),
              "b": np.full((4,), 2.0, np.float32)}
    grads = {"w": np.full((4, 16), 2.0, np.float32),
             "b": np.full((4,), 4.0, np.float32)}
    cfg = dict(peak_lr=0.125, warmup_steps=0, total_steps=1, grad_clip=1.0,
               weight_decay=0.5)
    ref, port = RefAdamW(RefAdamWConfig(**cfg)), AdamW(AdamWConfig(**cfg))
    r_params = {k: jnp.asarray(v) for k, v in params.items()}
    _, r_state, r_stats = ref.update(
        {k: jnp.asarray(v) for k, v in grads.items()}, ref.init(r_params),
        r_params)
    p_params = _port_params(params)
    _, p_state, p_stats = port.update(
        [torch.tensor(grads["w"]), torch.tensor(grads["b"])],
        port.init(p_params), p_params)
    assert float(p_stats["grad_norm"]) == float(r_stats["grad_norm"]) == \
        float(np.sqrt(np.float32(4 * 16 * 4 + 4 * 16)))
    for mom in ("m", "v"):
        for got, n in zip(p_state[mom], ("w", "b")):
            assert np.array_equal(got.numpy(), np.asarray(r_state[mom][n]))

    zero = [torch.zeros(4, 16), torch.zeros(4)]
    p_params = _port_params(params)
    port.update(zero, port.init(p_params), p_params)
    r_new, _, _ = ref.update(
        {k: jnp.zeros_like(v) for k, v in r_params.items()},
        ref.init(r_params), r_params)
    got = _named(p_params)
    assert np.array_equal(got["b"], params["b"])
    assert np.array_equal(got["b"], np.asarray(r_new["b"]))
    assert not np.array_equal(got["w"], params["w"])
    np.testing.assert_allclose(got["w"], np.asarray(r_new["w"]), rtol=RTOL)


def test_nonfinite_norm_skips_the_update():
    rng = np.random.default_rng(2)
    port = AdamW()
    params = _port_params(_tree(rng))
    state = port.init(params)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    grads = [torch.full_like(p, float("nan")) for p in params.parameters()]
    _, state2, stats = port.update(grads, state, params, skip_nonfinite=True)
    assert stats["skipped"] is True
    assert state2["step"] == 0
    assert all(float(m.abs().sum()) == 0 for m in state2["m"] + state2["v"])
    for n, p in params.named_parameters():
        assert torch.equal(p.detach(), before[n])
    ok = [torch.ones_like(p) for p in params.parameters()]
    _, state3, stats = port.update(ok, state, params, skip_nonfinite=True)
    assert stats["skipped"] is False and state3["step"] == 1


@pytest.mark.parametrize("shape", [(256,), (1000,), (7, 300), (3, 5)])
def test_int8_quantize_bit_for_bit(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 5).astype(np.float32)
    rq, rs = ref_quantize(jnp.asarray(x))
    q, s = quantize_int8(torch.tensor(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(s.numpy(), np.asarray(rs))
    want = ref_dequantize(rq, rs, shape, jnp.float32)
    got = dequantize_int8(q, s, shape, torch.float32)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_compressed_allreduce_over_a_gloo_group_of_one():
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((300,), (17, 40), (5,))]
    errors = [(rng.standard_normal(g.shape) * 1e-3).astype(np.float32)
              for g in grads]
    # the reference over a one-member axis (vmap's axis name, as psum in
    # its shard_map)
    r_out, r_err = jax.vmap(lambda g, e: ref_allreduce(g, "pod", e),
                            axis_name="pod")(
        [jnp.asarray(g)[None] for g in grads],
        [jnp.asarray(e)[None] for e in errors])
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{_free_port()}", world_size=1,
        rank=0)
    try:
        out, err = compressed_allreduce([torch.tensor(g) for g in grads],
                                        errors=[torch.tensor(e)
                                                for e in errors])
    finally:
        dist.destroy_process_group()
    for o, ro, e, re in zip(out, r_out, err, r_err):
        np.testing.assert_allclose(o.numpy(), np.asarray(ro)[0], rtol=0,
                                   atol=0)
        np.testing.assert_allclose(e.numpy(), np.asarray(re)[0], rtol=0,
                                   atol=0)
    # with no group the sum is the local value: the same result
    out2, err2 = compressed_allreduce([torch.tensor(g) for g in grads],
                                      errors=[torch.tensor(e) for e in errors])
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    assert all(torch.equal(a, b) for a, b in zip(err, err2))
