"""The fused optimizer's kernels (``kernels/csrc/adamw.cu``) on the card.

* The update against its plain version, the per-leaf loop
  (``ref.adamw_apply_ref``, run on the card with the lr and bias
  corrections as device scalars, as the loop ran there before the
  kernels) on the same inputs and the same norm for 3 steps: p, m and v
  bit-equal.  Leaves of 0, 1, 3 and 4k + 1
  elements, a leaf longer than a chunk, bases one float off 16-byte
  alignment, decay and no-decay leaves, a clip that takes hold.
* The norm (three launches) within 1e-6 relative of
  ``sqrt(sum(sum(g * g)))`` leaf by leaf, and the same bits twice.
* The full leaf lists of a reduced yi-6b and a reduced falcon-mamba-7b
  through ``make_train_step``: the same, with every leaf taken by the
  kernel (``adamw_apply.leaves`` / ``.elements``) in 4 launches a step.
* One step of every reduced arch through the kernels; a leaf past 2^31
  elements (64-bit offsets); a float16 leaf refused.

Needs a CUDA card; run with ``pytest -m cuda tests/test_torch_optim_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as aw
from repro_torch.kernels import ops, ref
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
from repro_torch.optim import adamw as port_adamw

pytestmark = pytest.mark.cuda

NORM_RTOL = 1e-6
#: kernel launches a step: the norm's three, the update's one
LAUNCHES = 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    return torch.device("cuda")


def _leaf(card, values, misaligned):
    """``values`` on the card, at a base one float past 16-byte alignment
    when ``misaligned``."""
    t = torch.as_tensor(values, device=card)
    if not misaligned:
        return t.clone()
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


def _old_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))


def _schedule(c, step, device):
    """The step's lr and bias corrections as ``AdamW.update`` makes them:
    0-dim fp32, moved to ``device`` (the card for the loop)."""
    lr = cosine_schedule(step, peak_lr=c.peak_lr, warmup=c.warmup_steps,
                         total=c.total_steps)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    return {"lr": lr.to(device), "b1c": (1.0 - f32(c.b1) ** f32(step))
            .to(device), "b2c": (1.0 - f32(c.b2) ** f32(step)).to(device)}


def _hyper(c):
    return dict(b1=c.b1, b2=c.b2, eps=c.eps, weight_decay=c.weight_decay,
                grad_clip=c.grad_clip)


class _Params:
    """A list of leaves as ``AdamW`` takes a module: ``.parameters()``."""

    def __init__(self, leaves):
        self.leaves = leaves

    def parameters(self):
        return iter(self.leaves)


def _both_ways(card, c, leaves, grads_per_step, ndims):
    """Each step through ``AdamW.update`` (the kernels) and through the
    loop on copies, the loop given the kernels' norm; asserts p, m and v
    bit-equal after every step and returns the norms."""
    opt = AdamW(c)
    params = _Params(leaves)
    state = opt.init(params)
    loop_p = [p.clone() for p in leaves]
    loop_m = [torch.zeros_like(p) for p in leaves]
    loop_v = [torch.zeros_like(p) for p in leaves]
    norms = []
    for step, grads in enumerate(grads_per_step, 1):
        before = ops.adamw_apply.launches
        _, state, stats = opt.update(grads, state, params, ndims=ndims)
        assert ops.adamw_apply.launches == before + 1
        gnorm = stats["grad_norm"]
        ref.adamw_apply_ref(loop_p, grads, loop_m, loop_v,
                            [nd >= 2 for nd in ndims], gnorm,
                            **_schedule(c, step, card), **_hyper(c))
        torch.cuda.synchronize()
        for i, p in enumerate(leaves):
            assert torch.equal(p, loop_p[i]), ("p", step, i)
            assert torch.equal(state["m"][i], loop_m[i]), ("m", step, i)
            assert torch.equal(state["v"][i], loop_v[i]), ("v", step, i)
        want = float(_old_norm(grads))
        assert abs(float(gnorm) - want) <= NORM_RTOL * want, (step, want)
        norms.append(float(gnorm))
    return norms


SHAPES = [(0,), (1,), (3,), (4 * 1000 + 1,), (7, 300), (aw.CHUNK + 5,),
          (3, aw.CHUNK), (64, 64), (17,)]


@pytest.mark.parametrize("misaligned", [(), (3, 4), (1, 5, 8)],
                         ids=["aligned", "misaligned2", "misaligned3"])
@pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clipped", "unclipped"])
def test_kernel_is_bit_equal_to_the_loop(card, clip, misaligned):
    rng = np.random.default_rng(len(misaligned) + int(clip))
    c = AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=20,
                    grad_clip=clip, weight_decay=0.1)
    leaves = [_leaf(card, rng.standard_normal(s).astype(np.float32),
                    i in misaligned) for i, s in enumerate(SHAPES)]
    ndims = [len(s) for s in SHAPES]
    ndims[4] = 1                        # a 2-D leaf without decay
    steps = [[_leaf(card, (rng.standard_normal(s) * 5).astype(np.float32),
                    i in misaligned) for i, s in enumerate(SHAPES)]
             for _ in range(3)]
    norms = _both_ways(card, c, leaves, steps, ndims)
    assert all(n > clip for n in norms) if clip == 1.0 else \
        all(n < clip for n in norms)


def test_norm_is_deterministic(card):
    rng = np.random.default_rng(3)
    grads = [torch.as_tensor((rng.standard_normal(s) * 10.0 ** (i % 4))
                             .astype(np.float32), device=card)
             for i, s in enumerate(SHAPES)]
    before = ops.adamw_sumsq.launches, ops.adamw_norm.launches
    a = port_adamw.global_norm(grads)
    assert (ops.adamw_sumsq.launches, ops.adamw_norm.launches) == \
        (before[0] + 2, before[1] + 1)
    b = port_adamw.global_norm(grads)
    assert torch.equal(a, b)
    sums = port_adamw.leaf_sumsq(grads)
    want = torch.stack([torch.sum(torch.square(g)) for g in grads])
    assert torch.allclose(sums, want, rtol=NORM_RTOL, atol=0)
    assert abs(float(a) - float(_old_norm(grads))) <= \
        NORM_RTOL * float(_old_norm(grads))


def _reduced(arch):
    from repro_torch.configs import get_arch

    return get_arch(arch).reduced()


def _batch(cfg, card, seed, b=2, t=64):
    rng = np.random.default_rng(seed)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (b, t)),
                                dtype=torch.int32, device=card)
             for k in ("tokens", "labels")}
    if cfg.n_memory:
        batch["memory"] = torch.as_tensor(rng.standard_normal(
            (b, cfg.n_memory, cfg.d_model)), dtype=torch.float32,
            device=card)
    return batch


@pytest.mark.parametrize("arch", ["yi-6b", "falcon-mamba-7b"])
def test_reduced_model_leaf_list(card, arch):
    """A reduced model's whole leaf list, its gradients from the model on
    the card, 3 steps both ways; every leaf in the kernel's table."""
    from repro_torch.launch.steps import _grads
    from repro_torch.models import build_model

    cfg = _reduced(arch)
    model = build_model(cfg)
    params = model.init(0, card, trainable=True)
    leaves = list(params.parameters())
    ndims = model.reference_ndims(params)
    c = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    steps = []
    for s in range(3):
        _, _, grads = _grads(model, params, leaves, _batch(cfg, card, s))
        steps.append([torch.zeros_like(p) if g is None else g.detach()
                      for p, g in zip(leaves, grads)])
    counts = {k: w.launches for k, w in ops.OPTIMIZER_WRAPPERS.items()}
    _both_ways(card, c, leaves, steps, ndims)
    got = {k: w.launches - counts[k] for k, w in
           ops.OPTIMIZER_WRAPPERS.items()}
    assert sum(got.values()) == 3 * LAUNCHES, got
    assert ops.adamw_apply.leaves == len(leaves)
    assert ops.adamw_apply.elements == sum(p.numel() for p in leaves)


ARCHS = ("yi-6b", "gemma-7b", "mistral-nemo-12b", "h2o-danube-3-4b",
         "recurrentgemma-9b", "falcon-mamba-7b", "llama-3.2-vision-90b",
         "granite-moe-3b-a800m", "mixtral-8x7b", "whisper-small")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_steps_through_the_kernels(card, arch):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model

    cfg = _reduced(arch)
    model = build_model(cfg)
    params = model.init(0, card, trainable=True)
    before = [p.detach().clone() for p in params.parameters()]
    opt = AdamW(AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10))
    state = opt.init(params)
    step = make_train_step(model, opt)
    counts = {k: w.launches for k, w in ops.OPTIMIZER_WRAPPERS.items()}
    params, state, metrics = step(params, state, _batch(cfg, card, 1),
                                  skip_nonfinite=True)
    assert not metrics["skipped"] and np.isfinite(float(metrics["loss"]))
    assert sum(w.launches - counts[k] for k, w in
               ops.OPTIMIZER_WRAPPERS.items()) == LAUNCHES
    leaves = list(params.parameters())
    assert ops.adamw_apply.leaves == len(leaves)
    assert ops.adamw_apply.elements == sum(p.numel() for p in leaves)
    assert any(not torch.equal(p, b) for p, b in zip(leaves, before))
    assert float(metrics["lr"]) > 0 and metrics["lr"].device.type == "cpu"


def test_leaf_past_two_to_the_31_elements(card):
    """One leaf of 2^31 + 5 elements (34 GB of p, g, m and v): the last
    elements, past int32's reach, updated as the loop updates a copy of
    them given the same norm."""
    n = (1 << 31) + 5
    c = AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    p = torch.empty(n, device=card).uniform_(-1, 1)
    g = torch.empty(n, device=card).uniform_(-1, 1)
    m = torch.empty(n, device=card).uniform_(-0.1, 0.1)
    v = torch.empty(n, device=card).uniform_(0, 0.01)
    tail = slice(n - 3000, n)
    want = [x[tail].clone() for x in (p, m, v)]
    table = ops.adamw_table([g], [p], [m], [v], [False])
    assert table.chunks == -(-n // aw.CHUNK)
    gnorm = ops.adamw_norm(ops.adamw_sumsq(table))
    ops.adamw_apply(table, gnorm, **_schedule(c, 1, "cpu"), **_hyper(c))
    ref.adamw_apply_ref([want[0]], [g[tail].clone()], [want[1]], [want[2]],
                        [False], gnorm, **_schedule(c, 1, card), **_hyper(c))
    torch.cuda.synchronize()
    for got, w in zip((p[tail], m[tail], v[tail]), want):
        assert torch.equal(got, w)
    wanted = float(torch.sqrt(torch.sum(torch.square(g))))
    assert abs(float(gnorm) - wanted) <= NORM_RTOL * wanted
    del p, g, m, v, table
    torch.cuda.empty_cache()


def test_other_dtypes_are_refused(card):
    p = torch.zeros(8, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.adamw_table([p.float()], [p], [p.float()], [p.float()], [True])
