"""A CPU rehearsal of the serving path the card runs through the kernels.

The models take their prefill attention and Mamba scan as functions; here
the kernels' CPU arithmetic models (``torch_kernel_models``: the bf16
flash route's tiles, log2 softmax and P hi + lo split; the scan's lane
groups and butterfly) stand in for the CUDA kernels, through the same
routes (``layers.flash_prefill``, ``ssm.kernel_scan``) and layouts the
card takes, and the result is held against the plain twins
(``layers.attention_any``, ``ssm.plain_scan``) on the same weights: the
prefill logits and, teacher-forced, the decode logits after it.  The
reduced yi-6b (head width 64, the kernel's) and falcon-mamba-7b; the two
at full depth and narrow width (32 and 64 layers): gaps 0.0223 and 0.0248
of max |logit|, top-1 0.965 and 0.992; and falcon-mamba-7b's 64 layers at
width 1024 with the scan's own plain version (sequential fp32)
as the kernel, where the gap reaches its floor, about 0.05 (top-1
0.88-0.93): the fp32 reorderings of the scan, rounded to bf16 at every
layer, spread through the random-weight stack.  That floor sets
``chip_smoke.py``'s phase 14 bar (``SERVE_REL_TOL``, ``SERVE_TOP1``),
held here too."""
import dataclasses
import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ref as kref
from repro_torch.models import build_model, layers, ssm

from torch_kernel_models import group_scan, kernel_model

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _flash_model(q, k, v, *, causal):
    """The bf16 kernel's arithmetic at its default tiles (128 x 128)."""
    return kernel_model(q, k, v, causal=causal, bq=128, bk=128)


def _models(cfg):
    kernels = build_model(
        cfg, attention=functools.partial(layers.flash_prefill,
                                         kernel=_flash_model),
        scan=functools.partial(ssm.kernel_scan, kernel=group_scan))
    plain = build_model(cfg, attention=layers.attention_any,
                        scan=ssm.plain_scan)
    return kernels, plain


def _cases():
    yi, fm = get_arch("yi-6b"), get_arch("falcon-mamba-7b")
    return {
        "yi-6b reduced, head 64": (
            dataclasses.replace(yi.reduced(), head_dim=64), 2, 64),
        "falcon-mamba-7b reduced": (fm.reduced(), 2, 64),
        "yi-6b 32 layers, d 512": (dataclasses.replace(
            yi, n_layers=32, d_model=512, n_heads=8, n_kv_heads=1,
            head_dim=64, d_ff=1376, vocab=8000), 1, 256),
        "falcon-mamba-7b 64 layers, d 256": (dataclasses.replace(
            fm, n_layers=64, d_model=256, d_inner=512, dt_rank=16,
            vocab=8128), 1, 128),
    }


def _wide_scan_cases():
    fm = get_arch("falcon-mamba-7b")
    return {f"falcon-mamba-7b 64 layers, d {d}": dataclasses.replace(
        fm, n_layers=64, d_model=d, d_inner=2 * d, dt_rank=d // 16,
        vocab=8128) for d in (1024,)}


@pytest.mark.parametrize("case", list(_cases()))
def test_kernel_path_within_the_card_bar(case):
    cfg, b, t = _cases()[case]
    kernels, plain = _models(cfg)
    params = kernels.init(0, "cpu")
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab, (b, t)))
    nxt = torch.as_tensor(rng.integers(1, cfg.vocab, (b, 4)))
    got = chip_smoke.teacher_forced(kernels, params, prompt, nxt, t + 4)
    want = chip_smoke.teacher_forced(plain, params, prompt, nxt, t + 4)
    for i in range(got.shape[1]):
        gap = chip_smoke.logit_gap(got[:, i], want[:, i])
        assert gap["rel"] <= chip_smoke.SERVE_REL_TOL, (i, gap)
    lk, _ = kernels.prefill(params, {"tokens": prompt})
    lp, _ = plain.prefill(params, {"tokens": prompt})
    gap = chip_smoke.logit_gap(lk, lp)
    assert gap["rel"] <= chip_smoke.SERVE_REL_TOL / 2, gap
    assert gap["top1"] >= chip_smoke.SERVE_TOP1, gap
    assert bool(torch.isfinite(lk).all())


@pytest.mark.parametrize("case", list(_wide_scan_cases()))
def test_wide_scan_gap_floor_within_the_card_bar(case):
    """Two correct fp32 scans (the kernel's plain version and the
    reference's associative tree) part at the floor, inside the bar."""
    cfg = _wide_scan_cases()[case]
    seq = build_model(cfg, scan=functools.partial(
        ssm.kernel_scan, kernel=kref.selective_scan_ref))
    plain = build_model(cfg, scan=ssm.plain_scan)
    params = plain.init(0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, (1, 128)))
    gap = chip_smoke.logit_gap(seq.prefill(params, {"tokens": toks})[0],
                               plain.prefill(params, {"tokens": toks})[0])
    assert 0.02 < gap["rel"] <= chip_smoke.SERVE_REL_TOL, gap
    assert gap["top1"] >= chip_smoke.SERVE_TOP1, gap


def test_the_kernels_take_every_prefill_and_scan():
    """Each attention layer's prefill and each Mamba layer's every scan
    (decode's T = 1 included) go through the injected kernels."""
    calls = {"attention": 0, "scan": 0}

    def count(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run
    for arch, name, fn in (("yi-6b", "attention", _flash_model),
                           ("falcon-mamba-7b", "scan", group_scan)):
        cfg = get_arch(arch).reduced()
        if name == "attention":
            cfg = dataclasses.replace(cfg, head_dim=64)
            model = build_model(cfg, attention=functools.partial(
                layers.flash_prefill, kernel=count(name, fn)))
        else:
            model = build_model(cfg, scan=functools.partial(
                ssm.kernel_scan, kernel=count(name, fn)))
        params = model.init(0, "cpu")
        toks = torch.ones((2, 9), dtype=torch.int64)
        chip_smoke.teacher_forced(model, params, toks, toks[:, :3], 12)
        per_call = cfg.n_layers
        want = per_call if name == "attention" else per_call * (1 + 3)
        assert calls[name] == want, (name, calls)

