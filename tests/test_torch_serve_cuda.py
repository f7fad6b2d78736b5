"""The serving path on the card: the reduced yi-6b (head width 64, the
flash kernel's) and falcon-mamba-7b through the hand-written kernels
against the same models with the plain twins on the card, on the same
weights, at ``chip_smoke.py``'s phase 14 bar; the kernels' launch counts
(one ``flash_attention`` per attention layer per prefill, none in decode;
one ``selective_scan`` per Mamba layer per prefill and per decode); and a
head width the flash kernel is not built for refused on the card.

Needs a CUDA card; run with ``pytest -m cuda tests/test_torch_serve_cuda.py``.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import build_model, layers, ssm
from repro_torch.serve import GenerationConfig, ServeEngine

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

MODELS = {"yi-6b": "flash_attention", "falcon-mamba-7b": "selective_scan"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    return torch.device("cuda")


def _cfg(arch):
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, head_dim=64) if arch == "yi-6b" else cfg


def _launches():
    return {k: w.launches for k, w in ops.KERNEL_WRAPPERS.items()}


@pytest.mark.parametrize("arch", list(MODELS))
def test_kernel_path_against_plain_twins(card, arch):
    cfg, kernel = _cfg(arch), MODELS[arch]
    model = build_model(cfg)
    plain = build_model(cfg, attention=layers.attention_any,
                        scan=ssm.plain_scan)
    params = model.init(0, card)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab, (2, 64)),
                             device=card)
    nxt = torch.as_tensor(rng.integers(1, cfg.vocab, (2, 4)), device=card)
    chip_smoke.reset_launches(ops)
    got = chip_smoke.teacher_forced(model, params, prompt, nxt, 68)
    torch.cuda.synchronize()
    per_call = cfg.n_layers
    want_n = per_call if kernel == "flash_attention" else per_call * 5
    assert _launches() == {k: (want_n if k == kernel else 0)
                           for k in ops.KERNEL_WRAPPERS}
    chip_smoke.reset_launches(ops)
    want = chip_smoke.teacher_forced(plain, params, prompt, nxt, 68)
    assert not any(_launches().values())
    assert bool(torch.isfinite(got).all())
    for i in range(got.shape[1]):
        gap = chip_smoke.logit_gap(got[:, i], want[:, i])
        assert gap["rel"] <= chip_smoke.SERVE_REL_TOL, (i, gap)
    assert chip_smoke.logit_gap(got, want)["top1"] >= chip_smoke.SERVE_TOP1


@pytest.mark.parametrize("arch", list(MODELS))
def test_generate_on_the_card(card, arch):
    cfg, kernel = _cfg(arch), MODELS[arch]
    engine = ServeEngine(cfg)
    assert engine.device.type == "cuda"
    prompts = [[1, 2, 3, 4, 5, 6], [7, 8, 9]]
    chip_smoke.reset_launches(ops)
    out = engine.generate(prompts, GenerationConfig(max_new_tokens=5))
    assert out["tokens"].shape == (2, 5)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab)).all()
    per_call = cfg.n_layers
    want_n = per_call if kernel == "flash_attention" else per_call * (1 + 5)
    assert _launches()[kernel] == want_n
    again = engine.generate(prompts, GenerationConfig(max_new_tokens=5))
    np.testing.assert_array_equal(out["tokens"], again["tokens"])


def test_other_head_widths_are_refused_on_the_card(card):
    cfg = get_arch("yi-6b").reduced()            # head width 16
    model = build_model(cfg)
    params = model.init(0, card)
    tokens = torch.ones((1, 8), dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="not 16"):
        model.prefill(params, {"tokens": tokens})
    for dh, names in ((120, "h2o-danube-3-4b"), (256, "gemma-7b")):
        q = torch.zeros((1, 8, 2, dh), dtype=torch.bfloat16, device=card)
        with pytest.raises(ValueError, match=names):
            layers.flash_prefill(q, q, q, causal=True, window=None)
