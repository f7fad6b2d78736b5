"""The serving path on the card: the reduced yi-6b (head width 64), the
reduced h2o-danube-3-4b and gemma-7b at their real head widths (120 and
256) and falcon-mamba-7b through the hand-written kernels against the
same models with the plain twins on the card, on the same weights, at
``chip_smoke.py``'s phase 14 bar; the kernels' launch counts (one
``flash_attention`` per attention layer per prefill, none in decode; one
``selective_scan`` per Mamba layer per prefill and per decode); the
reduced yi-6b's own width 16 through the kernel, and widths the kernel
does not take refused on the card.

Needs a CUDA card; run with ``pytest -m cuda tests/test_torch_serve_cuda.py``.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, layers, ssm
from repro_torch.serve import GenerationConfig, ServeEngine

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

MODELS = {"yi-6b": "flash_attention", "h2o-danube-3-4b": "flash_attention",
          "gemma-7b": "flash_attention", "falcon-mamba-7b": "selective_scan"}
#: the reduced configs' head widths on the card: yi-6b's a compiled width,
#: h2o-danube-3-4b's and gemma-7b's their real ones (h2o-danube-3-4b with
#: its real window, which the 64-token prompt fits, so that its prefill
#: reaches the kernel)
WIDTHS = {"yi-6b": dict(head_dim=64),
          "h2o-danube-3-4b": dict(head_dim=120, window=4096),
          "gemma-7b": dict(head_dim=256)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    return torch.device("cuda")


def _cfg(arch):
    return dataclasses.replace(get_arch(arch).reduced(), **WIDTHS.get(arch,
                                                                      {}))


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
    """The reduced yi-6b's own head width 16 now prefills through the
    kernel (run at width 64) within the phase 14 bar of the plain twins;
    flash_prefill at 120 and 256 equals the kernel's plain version on the
    folded heads within the card's bf16 tolerance; widths the kernel does
    not take raise."""
    cfg = get_arch("yi-6b").reduced()            # head width 16
    model = build_model(cfg)
    plain = build_model(cfg, attention=layers.attention_any,
                        scan=ssm.plain_scan)
    params = model.init(0, card)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        1, cfg.vocab, (2, 40)), device=card)
    chip_smoke.reset_launches(ops)
    got, _ = model.prefill(params, {"tokens": tokens})
    assert _launches()["flash_attention"] == cfg.n_layers
    want, _ = plain.prefill(params, {"tokens": tokens})
    gap = chip_smoke.logit_gap(got, want)
    assert gap["rel"] <= chip_smoke.SERVE_REL_TOL, gap
    assert gap["top1"] >= chip_smoke.SERVE_TOP1, gap
    rng = np.random.default_rng(5)
    for dh in (120, 256):
        q, k, v = (torch.as_tensor(rng.standard_normal((1, 70, 2, dh)),
                                   dtype=torch.float32).to(card).bfloat16()
                   for _ in range(3))
        out = layers.flash_prefill(q, k, v, causal=True, window=None)
        fold = lambda x: x.permute(0, 2, 1, 3).reshape(2, 70, dh)
        want = ref.attention_ref(fold(q), fold(k), fold(v), causal=True) \
            .reshape(1, 2, 70, dh).permute(0, 2, 1, 3)
        chip_smoke.check_close(f"flash_prefill d={dh}", out, want,
                               *chip_smoke.TOLERANCES[("flash_attention",
                                                       "bfloat16")])
    for dh in (12, 320):
        q = torch.zeros((1, 8, 2, dh), dtype=torch.bfloat16, device=card)
        with pytest.raises(ValueError, match=f"head width {dh} is not"):
            layers.flash_prefill(q, q, q, causal=True, window=None)


@pytest.mark.parametrize("arch", ["yi-6b", "falcon-mamba-7b"])
def test_mesh_engine_on_a_mesh_of_one(card, arch):
    """``ServeEngine(cfg, make_debug_mesh(1, 1))`` (NCCL, one rank) on the
    device engine's weights: the same greedy tokens, prefill logits equal
    within the phase 14 bar (bit-equal is expected), and the kernels'
    launches of the unsharded path (under ``local_map``)."""
    from repro_torch.launch.mesh import make_debug_mesh

    cfg, kernel = _cfg(arch), MODELS[arch]
    plain = ServeEngine(cfg, card)
    meshed = ServeEngine(cfg, make_debug_mesh(1, 1), params=plain.params)
    prompt = np.random.default_rng(6).integers(1, cfg.vocab, (2, 64))
    got = []
    for eng in (plain, meshed):
        chip_smoke.reset_launches(ops)
        logits, _ = eng._prefill(eng.params, {"tokens": eng._tokens(prompt)})
        got.append((logits.full_tensor() if hasattr(logits, "full_tensor")
                    else logits, _launches()))
    (want, n0), (have, n1) = got
    assert n1 == n0 and n0[kernel] == cfg.n_layers, (n0, n1)
    gap = chip_smoke.logit_gap(have, want)
    assert gap["rel"] <= chip_smoke.SERVE_REL_TOL, gap
    assert gap["top1"] >= chip_smoke.SERVE_TOP1, gap
    gen = GenerationConfig(max_new_tokens=4)
    prompts = [list(r) for r in prompt]
    np.testing.assert_array_equal(meshed.generate(prompts, gen)["tokens"],
                                  plain.generate(prompts, gen)["tokens"])
