"""The port's shared blocks (``repro_torch.models.layers``) against the
reference's (``repro.models.layers``) on the same seeded inputs, the JAX
side under ``jax.jit`` on the CPU: both norms, RoPE, the three MLP
activations, every branch of ``attention_any`` (dense with causal, window
and ``q_offset`` masks, streaming with padded kv blocks, local chunks
with a ragged tail), ``attn_apply`` with and without a cache and with a
cross-attention source; and the kernel route ``flash_prefill``: the
reference's branches on CPU tensors, and with an injected kernel the
heads expanded as ``_expand_kv`` does (``repeat_interleave``), folded into
the batch, and a head width the kernel lacks refused.

Tolerances: fp32 results at rtol 1e-5; bf16 results (the attention cores,
the MLP, ``attn_apply``) at rtol 2^-7 (one bf16 step) and atol 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as R

from repro_torch.kernels import ref as kref
from repro_torch.models import layers as P

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2 ** -7, atol=1e-3)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _pair(x, dtype=None):
    """The same numpy values as a JAX array and a torch tensor (bf16 when
    ``dtype`` is "bf16")."""
    j, t = jnp.asarray(x), torch.as_tensor(np.array(x))
    if dtype == "bf16":
        j, t = j.astype(jnp.bfloat16), t.bfloat16()
    return j, t


def _tree(rng, shapes: dict, scale=1.0):
    vals = {k: np.asarray(rng.standard_normal(s) * scale, np.float32)
            for k, s in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in vals.items()},
            {k: torch.as_tensor(v) for k, v in vals.items()})


@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal((2, 5, 32)).astype(np.float32), dtype)
    jp, tp = _tree(rng, {"scale": (32,), "bias": (32,)}, 0.1)
    got = P.apply_norm(kind, tp, tx)
    want = jax.jit(lambda p, x: R.apply_norm(kind, p, x))(jp, jx)
    assert got.dtype == (torch.bfloat16 if dtype else torch.float32)
    _close(got, want, FP32 if dtype is None else BF16)


@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.standard_normal((2, 7, 3, 16)).astype(np.float32),
                   "bf16")
    pos = rng.integers(0, 4096, (2, 7))
    got = P.rope(tx, torch.as_tensor(pos), theta)
    want = jax.jit(lambda x, p: R.rope(x, p, theta))(jx, jnp.asarray(pos))
    _close(got, want, BF16)


@pytest.mark.parametrize("act,gated", [("swiglu", True), ("geglu", True),
                                       ("gelu", False)])
def test_mlp_activations(act, gated):
    rng = np.random.default_rng(2)
    shapes = {"w_up": (32, 64), "w_down": (64, 32)}
    if gated:
        shapes["w_gate"] = (32, 64)
    jp, tp = _tree(rng, shapes, 0.2)
    jx, tx = _pair(rng.standard_normal((2, 6, 32)).astype(np.float32), "bf16")
    got = P.mlp_apply(tp, tx, act)
    want = jax.jit(lambda p, x: R.mlp_apply(p, x, act))(jp, jx)
    _close(got, want, BF16)


@pytest.mark.parametrize("fn", [P.silu, P.gelu, P.sigmoid])
def test_activations_round_as_jax(fn):
    """Op by op in bf16, as JAX lowers them: equal bit for bit."""
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32) * 4
    jx, tx = _pair(x, "bf16")
    jfn = {P.silu: jax.nn.silu, P.gelu: jax.nn.gelu,
           P.sigmoid: jax.nn.sigmoid}[fn]
    np.testing.assert_array_equal(_np(fn(tx)), _np(jax.jit(jfn)(jx)))


def _qkv(rng, b, t, s, h, kh, dh):
    return [_pair(rng.standard_normal(shape).astype(np.float32), "bf16")
            for shape in ((b, t, h, dh), (b, s, kh, dh), (b, s, kh, dh))]


# (t, s, causal, window, q_offset, dense_limit) -> every branch
ATTENTION_CASES = {
    "dense causal": (12, 12, True, None, 0, 8192),
    "dense not causal T!=S": (5, 9, False, None, 0, 8192),
    "dense window t<=window": (12, 12, True, 16, 0, 8192),
    "dense q_offset": (4, 12, True, None, 8, 8192),
    "dense q_offset window": (4, 12, True, 6, 8, 8192),
    "decode t=1": (1, 12, True, None, 11, 8192),
    "streaming padded": (40, 40, True, None, 0, 32),
    "streaming not causal T!=S": (20, 33, False, None, 0, 32),
    "streaming q_offset": (8, 40, True, None, 32, 16),
    "local chunk ragged": (21, 21, True, 8, 0, 8192),
    "local chunk even": (24, 24, True, 8, 0, 8192),
}


@pytest.mark.parametrize("case", ATTENTION_CASES)
def test_attention_any_branches(case):
    t, s, causal, window, q_offset, limit = ATTENTION_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, t, s, 4, 2, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              dense_limit=limit)
    got = P.attention_any(tq, tk, tv, **kw)
    want = jax.jit(lambda q, k, v: R.attention_any(q, k, v, **kw))(jq, jk, jv)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close(got, want, BF16)


def test_streaming_kv_block_padding():
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 19, 19, 2, 1, 8)
    got = P.streaming_attention(tq, tk, tv, causal=True, kv_block=8)
    want = jax.jit(lambda q, k, v: R.streaming_attention(
        q, k, v, causal=True, kv_block=8))(jq, jk, jv)
    _close(got, want, BF16)


@pytest.mark.parametrize("mode", ["self", "cache", "cross"])
def test_attn_apply(mode):
    rng = np.random.default_rng(6)
    jp, tp = _tree(rng, {"wq": (32, 64), "wk": (32, 32), "wv": (32, 32),
                         "wo": (64, 32)}, 0.2)
    jx, tx = _pair(rng.standard_normal((2, 3, 32)).astype(np.float32), "bf16")
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=1e4)
    jc = tc = js = ts = None
    if mode == "cache":
        k0 = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
        jc = {"k": jnp.asarray(k0).astype(jnp.bfloat16),
              "v": jnp.asarray(k0[::-1].copy()).astype(jnp.bfloat16),
              "len": jnp.asarray(5, jnp.int32)}
        tc = {"k": torch.as_tensor(k0).bfloat16(),
              "v": torch.as_tensor(k0[::-1].copy()).bfloat16(), "len": 5}
    if mode == "cross":
        js, ts = _pair(rng.standard_normal((2, 7, 32)).astype(np.float32))
    got, got_cache = P.attn_apply(tp, tx, cache=tc, xattn_src=ts, **kw)
    want, want_cache = jax.jit(lambda p, x, c, src: R.attn_apply(
        p, x, cache=c, xattn_src=src, **kw))(jp, jx, jc, js)
    _close(got, want, BF16)
    if mode == "cache":
        assert got_cache["len"] == int(want_cache["len"]) == 8
        for key in ("k", "v"):
            _close(got_cache[key], want_cache[key], BF16)


@pytest.mark.parametrize("window", [None, 16, 8])
def test_flash_prefill_on_cpu_is_the_reference_branches(window):
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 12, 12, 4, 2, 16)
    got = P.flash_prefill(tq, tk, tv, causal=True, window=window)
    want = jax.jit(lambda q, k, v: R.attention_any(
        q, k, v, causal=True, window=window))(jq, jk, jv)
    _close(got, want, BF16)


def _recording_kernel(calls):
    def kernel(q, k, v, *, causal):
        calls.append((tuple(q.shape), q.dtype, q.is_contiguous(),
                      k.is_contiguous(), causal))
        return kref.attention_ref(q, k, v, causal=causal)
    return kernel


@pytest.mark.parametrize("h,kh", [(4, 1), (4, 2), (4, 4)])
def test_flash_prefill_kernel_layout(h, kh):
    """With a kernel injected, q, k, v reach it as [B*H, T, dh] bf16,
    contiguous, kv head h // rep behind head h; the result equals the
    reference's materialized attention on the same heads."""
    rng = np.random.default_rng(8)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 10, 10, h, kh, 64)
    calls = []
    got = P.flash_prefill(tq, tk, tv, causal=True, window=None,
                          kernel=_recording_kernel(calls))
    assert calls == [((2 * h, 10, 64), torch.bfloat16, True, True, True)]
    want = jax.jit(lambda q, k, v: R.dense_attention(
        q, k, v, causal=True))(jq, jk, jv)
    # the kernel's stand-in keeps the scores in fp32; the reference rounds
    # them and P to bf16 first
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2)
    # GQA order: replacing kv head j by j's index shows which head reads it
    marks = torch.arange(kh, dtype=torch.float32)[None, None, :, None] \
        .expand(1, 4, kh, 64).bfloat16()
    ones = torch.ones((1, 4, h, 64)).bfloat16()
    seen = P.flash_prefill(ones, marks, marks, causal=False, window=None,
                           kernel=_recording_kernel([]))
    assert seen[0, 0, :, 0].tolist() == [float(i // (h // kh))
                                         for i in range(h)]


def test_flash_prefill_routes_around_the_kernel():
    """t = 1, T != S and a window shorter than T stay in the plain
    cores; a window as long as T goes through the kernel."""
    rng = np.random.default_rng(9)
    calls = []
    kernel = _recording_kernel(calls)
    for t, s, window in ((1, 1, None), (4, 9, None), (24, 24, 8)):
        (_, tq), (_, tk), (_, tv) = _qkv(rng, 1, t, s, 2, 1, 64)
        P.flash_prefill(tq, tk, tv, causal=True, window=window, kernel=kernel)
    assert calls == []
    (_, tq), (_, tk), (_, tv) = _qkv(rng, 1, 8, 8, 2, 1, 64)
    P.flash_prefill(tq, tk, tv, causal=True, window=8, kernel=kernel)
    assert len(calls) == 1


@pytest.mark.parametrize("dh", [120, 256, 16, 12, 320])
def test_flash_prefill_refuses_other_head_widths(dh):
    """The kernels take every width up to 256 that is a multiple of 8:
    h2o-danube-3-4b's 120, the gemma archs' 256 and the reduced configs'
    16 reach the kernel at their own width and are held against the
    reference's materialized attention; other widths (12, 320) raise."""
    rng = np.random.default_rng(10)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 4, 4, 2, 1, dh)
    calls = []
    kernel = _recording_kernel(calls)
    if dh % 8 or dh > 256:
        with pytest.raises(ValueError, match=f"head width {dh} is not "
                                             "supported"):
            P.flash_prefill(tq, tk, tv, causal=True, window=None,
                            kernel=kernel)
        assert calls == []
        return
    got = P.flash_prefill(tq, tk, tv, causal=True, window=None,
                          kernel=kernel)
    assert calls == [((2, 4, dh), torch.bfloat16, True, True, True)]
    want = jax.jit(lambda q, k, v: R.dense_attention(
        q, k, v, causal=True))(jq, jk, jv)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2)