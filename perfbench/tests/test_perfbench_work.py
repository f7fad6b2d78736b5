"""The work counts against hand-worked numbers at the two cells' shapes."""
import json

import pytest

from perfbench import weights, work
from perfbench.tests.tiny import ROOT


def config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name, layer, top", [
    # attention 4096 (32 + 2 * 4) 128 + 32 128 4096, SwiGLU 3 4096 11008,
    # two norms; embedding and untied head 2 64000 4096, the final norm
    ("yi-6b", 20_971_520 + 16_777_216 + 135_266_304 + 2 * 4096,
     2 * 64000 * 4096 + 4096),
    # in_proj 4096 16384, conv 4 8192 + 8192, x_proj 8192 288, dt_proj
    # 256 8192 + 8192, a_log 8192 16, d_skip 8192, out_proj 8192 4096, norm
    ("falcon-mamba-7b", 67_108_864 + 32_768 + 8192 + 2_359_296 + 2_097_152
     + 8192 + 131_072 + 8192 + 33_554_432 + 4096, 2 * 65024 * 4096 + 4096),
])
@pytest.mark.parametrize("depth", ["8", "proposed", "cell"])
def test_parameter_counts(name, layer, top, depth):
    assert layer == {"yi-6b": 173_023_232, "falcon-mamba-7b": 105_312_256}[name]
    # depth 8 is bring-up's phase 15; 12 and 20 the depths first proposed;
    # 16 and 32 the cells' (half the published 32 and 64)
    layers, total = {
        ("yi-6b", "8"): (8, 1_908_477_952),
        ("yi-6b", "proposed"): (12, 2_600_570_880),
        ("yi-6b", "cell"): (16, 3_292_663_808),
        ("falcon-mamba-7b", "8"): (8, 1_375_178_752),
        ("falcon-mamba-7b", "proposed"): (20, 2_638_925_824),
        ("falcon-mamba-7b", "cell"): (32, 3_902_672_896)}[name, depth]
    cfg = config(name)
    if depth != "cell":
        cfg = dict(cfg, n_layers=layers)
    assert cfg["n_layers"] == layers
    assert weights.param_count(cfg) == top + layers * layer == total


def test_model_flops_per_token():
    # yi-6b: 16 layers of 173,015,040 product weights and the head's
    # 262,144,000, times 6, plus 6 16384 32 128 a layer of attention
    assert weights.model_flops_per_token(config("yi-6b"), 16384) == \
        6 * (16 * 173_015_040 + 262_144_000) + 16 * 6 * 16384 * 32 * 128
    # falcon-mamba-7b: 32 layers of 105,119,744 and the head's 266,338,304
    assert weights.model_flops_per_token(config("falcon-mamba-7b"), 4096) == \
        6 * (32 * 105_119_744 + 266_338_304)


def test_attention_counts_at_the_yi_cell():
    pairs = 32 * 16384 * 16385 / 2
    t, by = work.attention_fwd(32, 16384, 128)
    assert by == "operations"
    assert t == pytest.approx(pairs * 512 / 989e12 + pairs * 5 / 67e12,
                              rel=1e-12)
    t, by = work.attention_bwd(32, 16384, 128)
    assert by == "operations"
    assert t == pytest.approx(pairs * 1280 / 989e12 + pairs * 4 / 67e12,
                              rel=1e-12)
    # bytes: q, k, v, o bf16 and lse fp32; the backward's seven bf16
    # tensors and lse
    assert work.attention_fwd(32, 16, 128, causal=False)[0] == pytest.approx(
        (4 * 32 * 16 * 128 * 2 + 32 * 16 * 4) / 3.35e12, rel=1e-12)
    assert work.attention_bwd(32, 16, 128, causal=False)[0] == pytest.approx(
        (7 * 32 * 16 * 128 * 2 + 32 * 16 * 4) / 3.35e12, rel=1e-12)


def test_scan_counts_at_the_falcon_cell():
    t, by = work.scan_fwd(2, 4096, 8192, 16)
    assert by == "bytes"
    assert t == pytest.approx((201_326_592 + 262_144 + 131_072 + 524_288) * 4
                              / 3.35e12, rel=1e-12)
    t, by = work.scan_bwd(2, 4096, 8192, 16)
    assert by == "operations"
    assert t == pytest.approx(2 * 4096 * 8192 * 16 * 30 / 67e12, rel=1e-12)


def test_mfu():
    # 1e10 FLOPs a token at 49,450 tokens/s is half of 989 TFLOP/s
    assert work.mfu_percent(1e10, 2 * 49_450, 2.0) == pytest.approx(50.0)
