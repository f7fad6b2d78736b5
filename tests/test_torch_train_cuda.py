"""The training path's backward kernels on the card: ``flash_attention_bwd``
and ``selective_scan_bwd`` against their plain versions (autograd of
``ref.attention_ref`` / ``ref.selective_scan_ref``) at every compiled head
width (64, 128, 256) and at 120 and 16, which run on a wider one,
causal or not, with ragged T and S (not multiples of the 64-row tiles),
T != S, rows that one key dominates, rows with a shared component and a
base that is not 16-byte aligned; the scan at S in {1, 4, 8, 16} with
ragged T (not a multiple of the 32-step chunk) and I; two launches
bit-identical; the forward kernel's log-sum-exp against the
plain one, and its output unchanged when it writes it; and the autograd
Functions' gradients equal to the wrappers'.

Tolerances (the plain versions run in fp32 on the same bf16 / fp32
inputs): attention's bf16 gradients row by row (a query's dq, a key's dk
and dv), each row within ``ATTN_TOL`` of its own largest gradient plus
``ROW_FLOOR`` of the tensor's largest -- under causal masking the rows'
sizes spread widely, so a bar on the tensor's largest value alone would
pass a kernel that drops a far tile; the kernel rounds dq, dk, dv to bf16
once, about 2^-9 relative.  The scan's fp32 gradients within
``SCAN_TOL`` of the largest, sums taken in another order.

Needs a CUDA card; run with ``pytest -m cuda tests/test_torch_train_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops, ref

from torch_kernel_models import peaked

pytestmark = pytest.mark.cuda

ATTN_TOL = 2 ** -6
SCAN_TOL = 1e-4
#: a floor, of the tensor's largest gradient (of the call's where the
#: plain tensor is all 0), for rows that are 0 or nearly so in the plain
#: version (one causal query sees one key: dq = 0; keys that no query
#: sees), where the kernel's fp32 dP - D leaves rounding
ROW_FLOOR = 2 ** -12
#: the scan's absolute floor, for gradients the plain version makes 0
ABS_FLOOR = 1e-5
LSE_ATOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    return torch.device("cuda")


def _close(got, want, tol, what, by_row=False):
    """Each gradient within ``tol`` of its largest |plain| plus
    ``ABS_FLOOR``, or with ``by_row`` each row (the last axis) within
    ``tol`` of its own largest |plain| plus ``ROW_FLOOR`` of the
    tensor's (of the call's largest where the plain tensor is all 0)."""
    call_max = max(float(w.float().abs().max()) for w in want)
    for g, w, name in zip(got, want, ("0", "1", "2", "3", "4", "5")):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
        assert bool(torch.isfinite(g).all()), (what, name)
        width = g.shape[-1] if by_row else max(g.numel(), 1)
        g2, w2 = g.float().reshape(-1, width), w.float().reshape(-1, width)
        err = (g2 - w2).abs().amax(1)
        size = w2.abs().amax(1)
        floor = ROW_FLOOR * (float(size.max()) or call_max) if by_row \
            else ABS_FLOOR
        bad = (err > tol * size + floor).nonzero()
        assert len(bad) == 0, (what, name, int(bad[0]), float(err.max()),
                               float(size.max()), len(bad))


def _attn_inputs(card, bh, t, s, d, seed, misaligned=False):
    rng = np.random.default_rng(seed)

    def mk(n):
        x = torch.as_tensor(rng.standard_normal((bh, n, d)),
                            dtype=torch.float32)
        x = x.to(card, torch.bfloat16)
        if misaligned:      # the same values at a base one element on
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
            x = buf[1:].view_as(x).copy_(x)
        return x
    return mk(t), mk(s), mk(s), mk(t)


ATTN_SHAPES = [(2, 128, 128), (3, 200, 200), (2, 333, 200), (2, 200, 333),
               (1, 1, 64), (2, 65, 130)]
#: every compiled width, and widths run on a wider one: h2o-danube-3-4b's
#: 120 (on 128) and the reduced configs' 16 (on 64)
WIDTHS = (*fa_k.HEAD_DIMS, 120, 16)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,t,s", ATTN_SHAPES)
def test_flash_attention_bwd_against_plain(card, d, causal, bh, t, s):
    q, k, v, do = _attn_inputs(card, bh, t, s, d, seed=t * 7 + s + d)
    out, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=causal))
    lse_want = ref.attention_lse_ref(q, k, causal=causal)
    assert float((lse - lse_want).abs().max()) <= LSE_ATOL
    got = ops.flash_attention_bwd(q, k, v, do, lse, causal=causal)
    torch.cuda.synchronize()
    want = ref.attention_bwd_ref(q, k, v, do, causal=causal)
    _close(got, want, ATTN_TOL, (bh, t, s, d, causal), by_row=True)
    again = ops.flash_attention_bwd(q, k, v, do, lse, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,tiles", [
    (d, t) for d in WIDTHS
    for t in fa_k.WIDTH_TILES[fa_k.compiled_width(d)]],
    ids=lambda x: f"bq{x[0]}xbk{x[1]}" if isinstance(x, tuple) else str(x))
def test_flash_attention_lse_every_route(card, d, causal, dtype, tiles):
    """Both routes of the forward kernel (fp32 in 3xTF32, bf16, both on
    the tensor cores) at every tile set of every width: the log-sum-exp
    against the plain one, and the output the same bits with and without
    it."""
    rng = np.random.default_rng(d + 2 * tiles[0] + tiles[1] + int(causal))
    for t, s in ((200, 333), (333, 200)):
        q, k, v = (torch.as_tensor(rng.standard_normal((2, n, d)),
                                   dtype=torch.float32).to(card, dtype)
                   for n in (t, s, s))
        kw = dict(causal=causal, bq=tiles[0], bk=tiles[1])
        out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
        assert torch.equal(out, ops.flash_attention(q, k, v, **kw))
        assert lse.dtype == torch.float32 and lse.shape == (2, t)
        want = ref.attention_lse_ref(q, k, causal=causal)
        assert float((lse - want).abs().max()) <= LSE_ATOL, (t, s)


@pytest.mark.parametrize("kind", ["peaked", "shared"])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,t,s", [(2, 200, 333), (3, 200, 200)])
def test_flash_attention_bwd_hard_rows(card, kind, d, causal, bh, t, s):
    """Peaked rows (q scaled by 2^(1/4) steps until the largest P reaches
    0.99: one key dominates, dP - D cancels) and shared ones (q and k each
    with a component common to all rows, 4x the others' size: dq = dS K
    cancels it only if dS keeps its zero row sum)."""
    q, k, v, do = _attn_inputs(card, bh, t, s, d, seed=t + s + d + 1)
    if kind == "peaked":
        q = peaked(q, k, causal=causal)
    else:
        common = torch.as_tensor(np.random.default_rng(d).standard_normal(
            (2, d)), dtype=torch.float32, device=card)
        q = (q.float() + 4 * common[0]).bfloat16()
        k = (k.float() + 4 * common[1]).bfloat16()
    _, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = ops.flash_attention_bwd(q, k, v, do, lse, causal=causal)
    torch.cuda.synchronize()
    want = ref.attention_bwd_ref(q, k, v, do, causal=causal)
    _close(got, want, ATTN_TOL, (kind, bh, t, s, d, causal), by_row=True)


def test_flash_attention_bwd_misaligned(card):
    q, k, v, do = _attn_inputs(card, 2, 130, 130, 64, seed=5, misaligned=True)
    assert q.data_ptr() % 4 != 0
    _, lse = ops.flash_attention(q.clone(), k.clone(), v.clone(),
                                   causal=True, return_lse=True)
    got = ops.flash_attention_bwd(q, k, v, do, lse, causal=True)
    want = ref.attention_bwd_ref(q, k, v, do, causal=True)
    _close(got, want, ATTN_TOL, "misaligned", by_row=True)


def test_flash_attention_function_on_the_card(card):
    q, k, v, do = _attn_inputs(card, 4, 256, 256, 128, seed=3)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = ops.flash_attention_bwd.launches
    ops.FlashAttention.apply(*leaves, True).backward(do)
    assert ops.flash_attention_bwd.launches == before + 1
    _, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    want = ops.flash_attention_bwd(q, k, v, do, lse, causal=True)
    assert all(torch.equal(x.grad, w) for x, w in zip(leaves, want))


def _scan_inputs(card, b, t, i, s, seed):
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=card)
    n = rng.standard_normal
    return (f(n((b, t, i))), f(np.abs(n((b, t, i))) * 0.1),
            f(n((b, t, s))), f(n((b, t, s))), f(-np.abs(n((i, s)))),
            f(n((b, i, s))), f(n((b, t, i))), f(n((b, i, s))))


@pytest.mark.parametrize("s", [1, 4, 8, 16, 3])
@pytest.mark.parametrize("b,t,i", [(1, 64, 32), (2, 100, 48), (1, 33, 17),
                                   (2, 257, 300), (1, 1, 8)])
def test_selective_scan_bwd_against_plain(card, s, b, t, i):
    args = _scan_inputs(card, b, t, i, s, seed=b * 1000 + t + i + s)
    got = ops.selective_scan_bwd(*args)
    torch.cuda.synchronize()
    want = ref.selective_scan_bwd_ref(*args)
    _close(got, want, SCAN_TOL, (b, t, i, s))
    again = ops.selective_scan_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_selective_scan_function_on_the_card(card):
    args = _scan_inputs(card, 2, 300, 64, 16, seed=9)
    leaves = [x.clone().requires_grad_() for x in args[:6]]
    before = ops.selective_scan_bwd.launches
    y, h_last = ops.SelectiveScan.apply(*leaves)
    (y * args[6]).sum().add_((h_last * args[7]).sum()).backward()
    assert ops.selective_scan_bwd.launches == before + 1
    want = ops.selective_scan_bwd(*args)
    assert all(torch.equal(x.grad, w) for x, w in zip(leaves, want))


#: the sharded training cell on a mesh of one rank against the unsharded
#: step: the same ops on the same data, so within fp32 rounding of equal
#: (bit-equal is expected)
MESH_RTOL = 1e-6


@pytest.mark.parametrize("arch", ["yi-6b", "falcon-mamba-7b"])
def test_sharded_train_cell_on_a_mesh_of_one(card, arch):
    """``build_cell`` on ``make_debug_mesh(1, 1)`` (NCCL, one rank) for two
    steps against ``make_train_step`` without a mesh: losses, every
    updated leaf, and the kernels' launches (under ``local_map`` the
    kernels see plain local tensors, as many times as unsharded)."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_cell, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, AdamWConfig

    cfg = get_arch(arch).reduced()
    if arch == "yi-6b":
        cfg = dataclasses.replace(cfg, head_dim=64)
    opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(3)
    batches = [{k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 128)),
                                   dtype=torch.int32, device=card)
                for k in ("tokens", "labels")} for _ in range(2)]
    cell, _ = build_cell(cfg, ShapeSpec("train", 128, 2, "train"),
                         make_debug_mesh(1, 1), optimizer=AdamW(opt_cfg))
    runs = []
    for model, step in ((build_model(cfg), None), (cell.model, cell)):
        step = step or make_train_step(model, AdamW(opt_cfg))
        params = model.init(0, card, trainable=True)
        opt = AdamW(opt_cfg).init(params)
        for w in (*ops.KERNEL_WRAPPERS.values(),
                  *ops.BACKWARD_WRAPPERS.values()):
            w.launches = 0
        losses = []
        for batch in batches:
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
        launches = {k: w.launches for k, w in {
            **ops.KERNEL_WRAPPERS, **ops.BACKWARD_WRAPPERS}.items()}
        runs.append((losses, launches, {
            n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach()
            for n, p in params.named_parameters()}))
    (l0, n0, p0), (l1, n1, p1) = runs
    assert n1 == n0 and any(n0.values()), (n0, n1)
    assert all(abs(a - b) <= MESH_RTOL * abs(b) for a, b in zip(l1, l0))
    for name, b in p0.items():
        a = p1[name]
        assert float((a - b).norm()) <= MESH_RTOL * float(b.norm()), name
