"""A CPU rehearsal of the tensor-core attention backward's rounding points.

``bwd_kernel_model`` (``tests/torch_kernel_models.py``) repeats the
arithmetic of ``csrc/flash_attention_bwd.cu`` in plain PyTorch: S = Q K^T
and dP = dO V^T in fp32 from bf16 inputs, P from the rows' log-sum-exp,
D = rowsum(P dP) in fp32, dS = P (dP - D), then P rounded to bf16 and dS
split into bf16 hi + lo parts as the wgmma operands of dV = P^T dO, dK =
scale dS^T Q and dQ = scale dS K, fp32 sums, bf16 out.  It is held
against autograd of the plain version (``ref.attention_bwd_ref``) with
chip_smoke.py's bar for the kernel (``BWD_TOL``: each row of dq, dk, dv
within 2^-6 of its own largest value plus 2^-12 of the tensor's), at the
shapes of tests/test_torch_train_cuda.py, both head widths, causal or
not, on three kinds of rows: random; peaked (q scaled by 2^(1/4) steps
until the largest P reaches 0.99, so that one key takes most of a row
and dP - D cancels); and shared (q and k each with a component common to
all rows, as trained projections give), and at one small shape against
``jax.vjp`` of the JAX reference's ``dense_attention`` in fp32.

Which variant the kernel takes, and why.  Its arithmetic keeps every
case within 0.49 of the bar.  One bf16 rounding of dS (9 products a pair
instead of 11) holds on random and peaked rows but reaches 1.85x the bar
on the shared ones: dS sums to exactly 0 over a row, so dq = dS K
cancels what the keys share, and a rounded dS no longer does (on the
card the same fault put a yi-6b query that sees 4 keys at 1.84x its bar
after ten training steps).  D taken as rowsum(dO o) from the forward's
bf16 output breaks the bar by up to 21x on peaked rows, where o's
rounding (2^-9) swamps dP - D.  Both variants are kept as cases that
must fail.  One rounding of P holds: nothing cancels through it.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

from torch_kernel_models import bwd_kernel_model, peaked

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TOL, FLOOR, _ = chip_smoke.BWD_TOL["flash_attention_bwd"]
#: tests/test_torch_train_cuda.py's shapes (BH, T, S): ragged T and S,
#: T != S both ways, one query
SHAPES = [(2, 128, 128), (3, 200, 200), (2, 333, 200), (2, 200, 333),
          (1, 1, 64), (2, 65, 130)]
#: random rows; peaked ones (q scaled until the largest P reaches 0.99);
#: q and k each with a component shared by all rows, 4x the others' size
KINDS = ("random", "peaked", "shared")
CASES = [(shape, d, causal, kind) for shape in SHAPES for d in (64, 128)
         for causal in (True, False) for kind in KINDS]


def _inputs(bh, t, s, d, seed):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.standard_normal((bh, n, d)), np.float32)
            for n in (t, s, s, t)]


def _bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16)


def _case(shape, d, causal, kind):
    bh, t, s = shape
    qn, kn, vn, don = _inputs(bh, t, s, d, t * 7 + s + d)
    if kind == "shared":
        common = np.random.default_rng(d).standard_normal((2, d))
        qn, kn = qn + 4 * common[0], kn + 4 * common[1]
    q, k, v, do = (_bf16(x) for x in (qn, kn, vn, don))
    if kind == "peaked":
        q = peaked(q, k, causal=causal)
    return q, k, v, do


def _share(got, want) -> float:
    """The worst row's error over its bar (chip_smoke.check_bwd's bar):
    <= 1 holds."""
    call_max = max(float(w.float().abs().max()) for w in want)
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(torch.isfinite(g.float()).all())
        g2 = g.double().reshape(-1, g.shape[-1])
        w2 = w.double().reshape(-1, w.shape[-1])
        err, size = (g2 - w2).abs().amax(1), w2.abs().amax(1)
        bar = TOL * size + FLOOR * (float(size.max()) or call_max)
        worst = max(worst, float((err / bar).max()))
    return worst


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(
    map(str, c[0])) + f"-d{c[1]}-causal{c[2]}-{c[3]}")
def test_model_within_the_card_bar(case):
    shape, d, causal, kind = case
    q, k, v, do = _case(shape, d, causal, kind)
    got = bwd_kernel_model(q, k, v, do, causal=causal)
    want = ref.attention_bwd_ref(q, k, v, do, causal=causal)
    assert _share(got, want) <= 1


def test_rounding_variants_against_the_bar():
    """The variants the kernel does not take, each on the cases that
    break it: one bf16 rounding of dS on the shared-component cases (dS
    sums to 0 over a row, and its rounding no longer cancels what the
    keys share), D = rowsum(dO o) with o the forward's bf16 output on the
    peaked ones.  The kernel's own arithmetic holds on every case
    (test_model_within_the_card_bar)."""
    worst = {("shared", "split"): 0.0, ("peaked", "d_from_out"): 0.0}
    for shape, d, causal, kind in CASES:
        variants = [v for k, v in worst if k == kind]
        if not variants:
            continue
        q, k, v, do = _case(shape, d, causal, kind)
        want = ref.attention_bwd_ref(q, k, v, do, causal=causal)
        kw = {"split": {"split": False}, "d_from_out": {"d_from_out": True}}
        for name in variants:
            got = bwd_kernel_model(q, k, v, do, causal=causal, **kw[name])
            worst[kind, name] = max(worst[kind, name], _share(got, want))
    assert min(worst.values()) > 1, worst


@pytest.mark.parametrize("causal", [True, False])
def test_model_within_the_bar_of_the_jax_reference(causal, monkeypatch):
    """The model against jax.vjp of the reference's dense_attention in
    fp32 ([B, T, H, d] layout) on the same bf16-valued inputs."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.models import layers as R
    monkeypatch.setattr(R, "COMPUTE_DTYPE", jnp.float32)
    b, h, t, d = 2, 2, 96, 64
    qn, kn, vn, don = (np.asarray(_bf16(x).float()) for x in _inputs(
        b * h, t, t, d, 31))
    to_jax = lambda x: jnp.asarray(x.reshape(b, h, t, d).transpose(0, 2, 1, 3))
    out, vjp = jax.vjp(lambda q, k, v: R.dense_attention(q, k, v,
                                                        causal=causal),
                       to_jax(qn), to_jax(kn), to_jax(vn))
    want = [torch.as_tensor(np.asarray(g, np.float32).transpose(0, 2, 1, 3)
                            .reshape(b * h, t, d)).to(torch.bfloat16)
            for g in vjp(to_jax(don))]
    got = bwd_kernel_model(*(_bf16(x) for x in (qn, kn, vn, don)),
                           causal=causal)
    assert _share(got, want) <= 1
