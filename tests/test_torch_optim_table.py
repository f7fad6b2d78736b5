"""The fused optimizer's host side and plain versions, on the CPU.

* The leaf table (``kernels/adamw.py``): the chunks that the ``adamw``
  kernels' blocks take cover every element of every leaf exactly once --
  leaves of 0, 1, 3 and 4k + 1 elements, alone and behind whole chunks,
  misaligned bases (scalar leaves), and a total past 2^31 elements,
  checked on the table's integer offsets (fake pointers, nothing
  allocated); the chunk is the one ``csrc/adamw.cu`` is compiled with.
* ``AdamW.update`` on the CPU (the plain versions of ``kernels/ref.py``
  through ``kernels.ops``) does, element by element, the fp32 arithmetic
  the kernel does, bit for bit against a numpy model of it (the scalars
  rounded once to fp32, ``1 - b1`` taken in double, the clip scale
  ``min(clip * (1 / max(norm, 1e-12)), 1)``, one rounding an operation in
  the kernel's order; the square root is torch's, since on the CPU it is
  not correctly rounded in every element, where the kernel's and the
  card's are): clip on and off, decay and no-decay leaves, a ``None``
  gradient, and ``skip_nonfinite`` with an infinite gradient.
  The plain norm is the loop's ``global_norm``.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as aw
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.optim import adamw as port_adamw

BASE = 1 << 40          # a fake, 512-byte aligned base address


def _aligned(sizes):
    """Four 16-byte aligned bases a leaf, far apart."""
    return [tuple(BASE + (4 * i + j) * (1 << 36) for j in range(4))
            for i in range(len(sizes))]


def _check_cover(rows):
    chunk = aw.CHUNK
    spans = aw.chunk_spans(rows)
    sizes = rows[:, 4]
    assert aw.total_chunks(rows) == int((-(-sizes // chunk)).sum())
    assert len(spans["leaf"]) == aw.total_chunks(rows)
    for i, n in enumerate(sizes):
        mine = spans["leaf"] == i
        starts, ends = spans["start"][mine], spans["end"][mine]
        if n == 0:
            assert not mine.any()
            continue
        # in order, end to end, from 0 to n: each element once
        assert starts[0] == 0 and ends[-1] == n
        assert np.array_equal(starts[1:], ends[:-1])
        assert (ends > starts).all() and (ends - starts <= chunk).all()
        vec_end = spans["vec_end"][mine]
        if rows[i, 7]:
            assert (starts % 4 == 0).all()           # float4-aligned
            assert ((vec_end - starts) % 4 == 0).all()
            assert ((ends - vec_end) < 4).all()
            assert (ends[:-1] == vec_end[:-1]).all()  # a tail only at the end
            assert ends[-1] - vec_end[-1] == n % 4
        else:
            assert (vec_end == starts).all()
    return spans


@pytest.mark.parametrize("whole", [0, 3], ids=lambda w: f"{w}chunks")
@pytest.mark.parametrize("tails", [
    [0], [1], [3], [4 * 16 + 1], [4 * aw.CHUNK + 1],
    [0, 1, 3, 0, 16, 17, 65, 4 * 1000 + 1, 0],
    [5, 0, 0, 64, 3, 0]], ids=str)
def test_chunks_cover_every_element_once(tails, whole):
    """Leaves of ``tails`` elements behind ``whole`` whole chunks each (an
    empty leaf stays empty)."""
    sizes = [whole * aw.CHUNK + n if n else 0 for n in tails]
    rows = aw.table_rows(_aligned(sizes), sizes, [i % 2 for i in
                                                  range(len(sizes))])
    assert rows.dtype == np.int64
    assert rows[:, 7].all()
    assert list(rows[:, 6]) == [i % 2 for i in range(len(sizes))]
    _check_cover(rows)


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("offset", [4, 8, 12])
def test_misaligned_base_makes_the_leaf_scalar(which, offset):
    sizes = [2 * aw.CHUNK + 4 * 33 + 1, aw.CHUNK + 4 * 33 + 1, 40]
    ptrs = [list(p) for p in _aligned(sizes)]
    ptrs[1][which] += offset            # one base of leaf 1 a few floats off
    rows = aw.table_rows(ptrs, sizes, [1, 1, 0])
    assert list(rows[:, 7]) == [1, 0, 1]
    spans = _check_cover(rows)
    one = spans["leaf"] == 1
    assert (spans["vec_end"][one] == spans["start"][one]).all()


def test_total_past_two_to_the_31_elements():
    """Leaves of 2^30 + 3, 2^31 + 7 (alone past int32), 5 and 0
    elements: offsets and the chunk walk stay in 64 bits."""
    sizes = [(1 << 30) + 3, (1 << 31) + 7, 5, 0]
    rows = aw.table_rows(_aligned(sizes), sizes, [1, 1, 0, 0])
    assert int(rows[:, 4].sum()) > (1 << 31)
    spans = _check_cover(rows)
    assert int(spans["end"].max()) == (1 << 31) + 7
    assert int(spans["start"][spans["leaf"] == 1].max()) > (1 << 31) - \
        aw.CHUNK
    assert aw.total_chunks(rows) < (1 << 31)       # the grid fits


def test_chunk_is_the_kernels():
    """The host's chunk is the one the kernels are compiled with, whole
    float4s."""
    src = aw.SOURCE.read_text()
    found = re.findall(r"constexpr long long CHUNK = 1LL << (\d+);", src)
    assert found and 1 << int(found[0]) == aw.CHUNK
    assert aw.CHUNK % 4 == 0


def test_hyper_takes_one_minus_beta_in_double():
    h = aw.hyper(lr=1e-3, b1c=0.1, b2c=0.05, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0)
    assert h["omb1"] == 1 - 0.9 and h["omb2"] == 1 - 0.95
    assert tuple(h) == aw.HYPER
    assert h["clip_floor"] == 1e-12


SHAPES = [(24, 16), (40, 8), (16,), (8,), (3, 5, 7), (1,), (0,), (13,)]


def _sqrt(a):
    """torch's fp32 square root on the CPU (about 0.7 % of its results are
    1 ulp from the correctly rounded one)."""
    return torch.sqrt(torch.from_numpy(a)).numpy()


def _model_update(p, g, m, v, decay, gnorm, lr, b1c, b2c, c):
    """One element-wise step of the kernel's arithmetic in numpy fp32, in
    place on the arrays ``p``, ``m`` and ``v`` (the square root
    :func:`_sqrt`)."""
    f = np.float32
    x = np.maximum(f(gnorm), f(1e-12))
    scale = np.minimum((f(1) / x) * f(c.grad_clip), f(1))
    with np.errstate(invalid="ignore"):         # inf * 0 where not finite
        gs = g * scale
    m[...] = m * f(c.b1) + gs * f(1 - c.b1)
    v[...] = v * f(c.b2) + (gs * f(1 - c.b2)) * gs
    u = (m / f(b1c)) / (_sqrt(v / f(b2c)) + f(c.eps))
    if decay:
        u = u + f(c.weight_decay) * p
    p[...] = p - f(lr) * u


def _same(got, want):
    """Equal bit for bit, NaN where the model has NaN."""
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_update_is_the_kernels_arithmetic(clip, skip):
    """Four steps, the fourth with an infinite gradient: after each,
    ``AdamW.update``'s p, m and v are the numpy model's given the update's
    own norm (a skipped step changes neither)."""
    rng = np.random.default_rng(11)
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=20,
                      grad_clip=clip, weight_decay=0.1)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    params = tf.ParamTree({f"w{i}": torch.tensor(x) for i, x in
                           enumerate(init)}, trainable=True)
    opt = AdamW(cfg)
    state = opt.init(params)
    ndims = [len(s) for s in SHAPES]
    ndims[0] = 1                        # a 2-D leaf the reference stacks
    ndims[2] = 2                        # as a vector: no decay, and back
    model = [(x.copy(), np.zeros_like(x), np.zeros_like(x)) for x in init]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    norms = []
    for k in range(4):
        grads = [(rng.standard_normal(s) * 3).astype(np.float32)
                 for s in SHAPES]
        if k == 3:
            grads[1][2, 3] = np.inf
        sent = [torch.tensor(g) for g in grads]
        sent[3] = None                  # a leaf the loss does not reach
        grads[3] = np.zeros_like(grads[3])
        _, state, stats = opt.update(sent, state, params, ndims=ndims,
                                     skip_nonfinite=skip)
        gnorm = float(stats["grad_norm"])
        norms.append(gnorm)
        if skip and stats["skipped"]:
            assert k == 3 and not np.isfinite(gnorm)
        else:
            step = k + 1
            b1c = float(1.0 - f32(cfg.b1) ** f32(step))
            b2c = float(1.0 - f32(cfg.b2) ** f32(step))
            for (p, m, v), g, nd in zip(model, grads, ndims):
                _model_update(p, g, m, v, nd >= 2, gnorm, float(stats["lr"]),
                              b1c, b2c, cfg)
        for (p, m, v), got_p, got_m, got_v in zip(
                model, params.parameters(), state["m"], state["v"]):
            _same(got_p.detach().numpy(), p)
            _same(got_m.numpy(), m)
            _same(got_v.numpy(), v)
    assert state["step"] == (3 if skip else 4)
    clipped = [n > clip for n in norms[:3]]
    assert all(clipped) if clip == 1.0 else not any(clipped)
    assert not np.isfinite(norms[3])
    if not skip:                        # the infinite gradient went through
        assert any(bool(torch.isnan(v).any()) for v in state["v"])


def test_twin_norm_is_the_loops():
    rng = np.random.default_rng(5)
    grads = [torch.tensor((rng.standard_normal(s) * 10 ** (i % 3))
                          .astype(np.float32)) for i, s in enumerate(SHAPES)]
    want = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    sums = ops.adamw_sumsq(ops.adamw_table(grads))
    assert sums.shape == (len(grads),) and sums.dtype == torch.float32
    got = ops.adamw_norm(sums)
    assert torch.equal(got, want)
    assert torch.equal(port_adamw.global_norm(grads), want)


def test_cpu_update_launches_no_kernel():
    before = {k: w.launches for k, w in ops.OPTIMIZER_WRAPPERS.items()}
    params = tf.ParamTree({"w": torch.ones(4, 4)}, trainable=True)
    opt = AdamW()
    opt.update([torch.ones(4, 4)], opt.init(params), params)
    assert before == {k: w.launches for k, w in
                      ops.OPTIMIZER_WRAPPERS.items()}
    assert ref.adamw_norm_ref(torch.tensor([4.0, 5.0])) == 3.0
