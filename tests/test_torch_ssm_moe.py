"""The port's state-space and MoE blocks (``repro_torch.models.ssm`` and
``moe``) against the reference's on the same seeded inputs, the JAX side
under ``jax.jit`` on the CPU: the associative-scan tree, ``linear_scan``
(the unrolled T <= 4 path and the chunked one, padded), the causal conv
with a carried state, ``selective_scan_fused``, ``mamba_apply`` fused and
unfused, with and without a cache, ``rglru_apply``, and ``moe_apply`` /
``moe_apply_row`` with a router biased so that tokens are dropped: the
same dropped (token, choice) pairs, outputs and aux loss.  The scan's
kernel route on CPU tensors is the reference's branches; with the plain
version of the kernel injected it stays within the kernel tolerance.

Tolerances: fp32 at rtol 1e-5 (atol 1e-6); bf16 outputs at rtol 2^-7,
atol 1e-3; ``rglru_apply``'s output at rtol 2^-6, atol 1e-2: XLA fuses the
reference's bf16 gate sigmoids into their fp32 uses and skips some of the
roundings its code writes (the port keeps them all), and the recurrence
gate passes through exp(-8 softplus(lambda) r), which magnifies one bf16
step of r up to about 17 times."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as RM
from repro.models import ssm as RS

from repro_torch.kernels import ref as kref
from repro_torch.models import moe as PM
from repro_torch.models import ssm as PS

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2 ** -7, atol=1e-3)
RGLRU = dict(rtol=2 ** -6, atol=1e-2)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=FP32):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _pairs(*arrays):
    return [(jnp.asarray(a), torch.as_tensor(np.array(a))) for a in arrays]


def _f32(rng, shape, scale=1.0):
    return np.asarray(rng.standard_normal(shape) * scale, np.float32)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 64])
def test_associative_scan_tree(n):
    rng = np.random.default_rng(n)
    (ja, ta), (jb, tb) = _pairs(np.abs(_f32(rng, (n, 3))),
                                _f32(rng, (n, 3)))
    got = PS.associative_scan(PS._assoc, (ta, tb), 0)
    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        RS._assoc, (a, b), axis=0))(ja, jb)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("t,chunk", [(1, 256), (4, 256), (5, 4), (40, 16),
                                     (64, 16)])
def test_linear_scan(t, chunk):
    rng = np.random.default_rng(t)
    (ja, ta), (jb, tb), (jh, th) = _pairs(
        np.exp(-np.abs(_f32(rng, (t, 3, 4)))), _f32(rng, (t, 3, 4)),
        _f32(rng, (3, 4)))
    got = PS.linear_scan(ta, tb, th, chunk=chunk)
    want = jax.jit(lambda a, b, h: RS.linear_scan(a, b, h, chunk=chunk))(
        ja, jb, jh)
    _close(got, want)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(11)
    arrays = [_f32(rng, (2, 7, 6)), _f32(rng, (4, 6)), _f32(rng, (6,))]
    if with_state:
        arrays.append(_f32(rng, (2, 3, 6)))
    pairs = _pairs(*arrays)
    got = PS._causal_conv(*[t for _, t in pairs])
    want = jax.jit(RS._causal_conv)(*[j for j, _ in pairs])
    for g, w in zip(got, want):
        _close(g, w)


def _scan_inputs(rng, b, t, i, s):
    return [_f32(rng, (b, t, i)), np.abs(_f32(rng, (b, t, i))) * 0.1,
            _f32(rng, (b, t, s)), _f32(rng, (b, t, s)),
            -np.abs(_f32(rng, (i, s))), _f32(rng, (b, i, s))]


@pytest.mark.parametrize("t,chunk", [(12, 4), (30, 8), (5, 256)])
def test_selective_scan_fused(t, chunk):
    pairs = _pairs(*_scan_inputs(np.random.default_rng(t), 2, t, 6, 4))
    got = PS.selective_scan_fused(*[x for _, x in pairs], chunk)
    want = jax.jit(lambda *a: RS.selective_scan_fused(*a, chunk))(
        *[j for j, _ in pairs])
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("t", [1, 3, 20])
def test_plain_scan_and_the_kernel_route(t, fused):
    """On CPU tensors the kernel route is the reference's branches; the
    kernel's plain version injected in its place agrees within the
    card's scan tolerance (atol 1e-3)."""
    arrays = _scan_inputs(np.random.default_rng(100 + t), 2, t, 6, 4)
    ts = [torch.as_tensor(a) for a in arrays]
    route = PS.kernel_scan(*ts, chunk=8, fused=fused)
    plain = PS.plain_scan(*ts, chunk=8, fused=fused)
    for g, w in zip(route, plain):
        assert torch.equal(g, w)
    injected = PS.kernel_scan(*ts, chunk=8, fused=fused,
                              kernel=kref.selective_scan_ref)
    for g, w in zip(injected, plain):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-3, rtol=0)


def _mamba_params(rng, d=32, i=48, s=4, r=6):
    shapes = {"in_proj": (d, 2 * i), "conv_w": (4, i), "conv_b": (i,),
              "x_proj": (i, r + 2 * s), "dt_proj": (r, i), "dt_bias": (i,),
              "a_log": (i, s), "d_skip": (i,), "out_proj": (i, d)}
    vals = {k: _f32(rng, v, 0.2) for k, v in shapes.items()}
    vals["dt_bias"] = vals["dt_bias"] - 3.0
    return ({k: jnp.asarray(v) for k, v in vals.items()},
            {k: torch.as_tensor(v) for k, v in vals.items()})


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("t", [1, 9])
def test_mamba_apply(t, fused, with_cache):
    rng = np.random.default_rng(12)
    jp, tp = _mamba_params(rng)
    (jx, tx), = _pairs(_f32(rng, (2, t, 32)))
    jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    jc = tc = None
    if with_cache:
        (jconv, tconv), (jssm, tssm) = _pairs(_f32(rng, (2, 3, 48)),
                                              _f32(rng, (2, 48, 4)))
        jc, tc = {"conv": jconv, "ssm": jssm}, {"conv": tconv, "ssm": tssm}
    kw = dict(d_state=4, dt_rank=6, chunk=4, fused=fused)
    got, got_cache = PS.mamba_apply(tp, tx, cache=tc, **kw)
    want, want_cache = jax.jit(lambda p, x, c: RS.mamba_apply(
        p, x, cache=c, **kw))(jp, jx, jc)
    _close(got, want, BF16)
    if with_cache:
        for key in ("conv", "ssm"):
            _close(got_cache[key], want_cache[key])


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("t", [1, 9])
def test_rglru_apply(t, with_cache):
    rng = np.random.default_rng(13)
    shapes = {"in_proj": (32, 96), "conv_w": (4, 48), "conv_b": (48,),
              "w_a": (48, 48), "w_i": (48, 48), "lambda_p": (48,),
              "out_proj": (48, 32)}
    vals = {k: _f32(rng, v, 0.2) for k, v in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in vals.items()}
    tp = {k: torch.as_tensor(v) for k, v in vals.items()}
    (jx, tx), = _pairs(_f32(rng, (2, t, 32)))
    jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    jc = tc = None
    if with_cache:
        (jconv, tconv), (jh, th) = _pairs(_f32(rng, (2, 3, 48)),
                                          _f32(rng, (2, 48)))
        jc, tc = {"conv": jconv, "h": jh}, {"conv": tconv, "h": th}
    got, got_cache = PS.rglru_apply(tp, tx, cache=tc, chunk=4)
    want, want_cache = jax.jit(lambda p, x, c: RS.rglru_apply(
        p, x, cache=c, chunk=4))(jp, jx, jc)
    _close(got, want, RGLRU)
    if with_cache:
        _close(got_cache["conv"], want_cache["conv"])
        _close(got_cache["h"], want_cache["h"], RGLRU)


# ---------------------------------------------------------------------- #
# MoE
# ---------------------------------------------------------------------- #
def _moe_inputs(rng, b, t, gated=True):
    shapes = {"router": (32, 4), "w_up": (4, 32, 16), "w_down": (4, 16, 32)}
    if gated:
        shapes["w_gate"] = (4, 32, 16)
    vals = {k: _f32(rng, v, 0.2) for k, v in shapes.items()}
    vals["router"][:, 0] += 0.5          # most tokens pick expert 0
    x = _f32(rng, (b, t, 32)) + 1.0
    return ({k: jnp.asarray(v) for k, v in vals.items()},
            {k: torch.as_tensor(v) for k, v in vals.items()},
            jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).bfloat16())


def _ref_keep(probs, top_k, capacity, row: bool):
    """The reference's dropped-pair mask (``moe.py:298-321``), in jnp."""
    n_exp = probs.shape[-1]
    _, gate_idx = jax.lax.top_k(probs, top_k)
    flat = gate_idx.reshape(probs.shape[0], -1) if row else \
        gate_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat, n_exp, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=-2) - 1
    pos_in = jnp.take_along_axis(pos, flat[..., None], axis=-1)[..., 0]
    return np.asarray(pos_in < capacity)


@pytest.mark.parametrize("act,gated", [("swiglu", True), ("geglu", True),
                                       ("gelu", False)])
@pytest.mark.parametrize("row", [False, True])
def test_moe_drops_the_reference_tokens(row, act, gated):
    rng = np.random.default_rng(14)
    b, t, k = 2, 96, 2
    jp, tp, jx, tx = _moe_inputs(rng, b, t, gated)
    ref_fn = RM.moe_apply_row if row else RM.moe_apply
    port_fn = PM.moe_apply_row if row else PM.moe_apply
    got, got_aux = port_fn(tp, tx, top_k=k, act=act)
    want, want_aux = jax.jit(lambda p, x: ref_fn(p, x, top_k=k, act=act))(
        jp, jx)
    _close(got, want, BF16)
    _close(got_aux, want_aux)

    logits = tx.float() @ tp["router"]
    probs = torch.softmax(logits if row else logits.reshape(b * t, -1), -1)
    tokens = t if row else b * t
    capacity = max(int(1.25 * tokens * k / 4), min(tokens, 64), 1)
    _, idx = PM.top_k(probs, k)
    keep, _ = PM.dispatch(idx.reshape(b, -1) if row else idx.reshape(-1), 4,
                          capacity)
    want_keep = _ref_keep(jnp.asarray(probs.numpy()), k, capacity, row)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert not want_keep.all()          # some pairs were dropped


def test_top_k_ties_to_the_lower_index():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]],
                     np.float32)
    vals, idx = PM.top_k(torch.as_tensor(probs), 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_moe_small_batch_is_dropless():
    rng = np.random.default_rng(15)
    jp, tp, jx, tx = _moe_inputs(rng, 1, 8)
    got, _ = PM.moe_apply(tp, tx, top_k=2)
    want, _ = jax.jit(lambda p, x: RM.moe_apply(p, x, top_k=2))(jp, jx)
    _close(got, want, BF16)
