"""The one-GPU launch tools against the reference's: ``roofline.model_flops``
for every arch x shape, ``analyze_cell``'s terms with the H100 constants
(as ``tests/test_roofline_calibration.py`` holds the reference's with its
own), ``cim_sweep``'s rows on the CPU against the reference's (the same
configs; TOPS/W and GOPS at rtol 1e-5), the ``dryrun.VARIANTS`` registry,
the one-GPU cell report, and the perf variants' losses (ported from
``tests/test_variants.py``, with ``seq_shard_attn`` and ``fsdp``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.launch import dryrun as ref_dryrun
from repro.launch import roofline as ref_roofline
from repro.models import build_model as ref_build_model

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.launch import dryrun, roofline
from repro_torch.models import build_model

SWEEP_ARCHS = ("yi-6b", "falcon-mamba-7b")


@pytest.mark.parametrize("shape_id", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops(arch, shape_id):
    assert roofline.model_flops(arch, shape_id) == \
        ref_roofline.model_flops(arch, shape_id)


def test_analyze_cell_terms():
    rec = {
        "status": "OK", "arch": "yi-6b", "shape": "train_4k", "mesh": "1x1",
        "dot_flops_per_device": roofline.PEAK_FLOPS,       # 1 s compute
        "hbm_bytes_per_device": roofline.HBM_BW * 2.0,     # 2 s memory (hi)
        "hbm_write_bytes_per_device": roofline.HBM_BW * 0.5,  # 1 s (lo)
    }
    r = roofline.analyze_cell(rec)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert r["t_compute_s"] == 1.0
    assert r["t_memory_hi_s"] == 2.0
    assert r["t_memory_lo_s"] == 1.0
    assert "t_collective_s" not in r        # one card exchanges nothing
    assert r["dominant"] == "memory"
    assert abs(r["roofline_fraction"] - 0.5) < 1e-9
    assert r["model_flops"] == ref_roofline.model_flops("yi-6b", "train_4k")
    rec["collectives"] = {"total_bytes": roofline.LINK_BW * 3.0}
    r = roofline.analyze_cell(rec)
    assert r["t_collective_s"] == 3.0 and r["dominant"] == "collective"
    assert abs(r["roofline_fraction"] - 1 / 3) < 1e-9
    assert "collectives" in roofline.hint(r)


def test_analyze_cell_skips_non_ok():
    assert roofline.analyze_cell({"status": "SKIP"}) is None


def test_build_and_markdown(tmp_path):
    import json
    rec = dryrun.run_cell("yi-6b", "decode_32k", device="cpu")
    rec["dot_flops_per_device"] = 2.0 * roofline.PEAK_FLOPS
    with open(tmp_path / "yi-6b_decode_32k_single.json", "w") as f:
        json.dump(rec, f)
    rows = roofline.build(str(tmp_path))
    assert len(rows) == 1 and rows[0]["dominant"] == "compute"
    assert "| yi-6b | decode_32k |" in roofline.to_markdown(rows)


@pytest.fixture(scope="module")
def sweeps():
    """The port's rows (the plain version on the CPU) and the
    reference's, both through their own DSE service."""
    got = roofline.cim_sweep(list(SWEEP_ARCHS), seq=512, device="cpu",
                             emit=lambda s: None)
    want = ref_roofline.cim_sweep(list(SWEEP_ARCHS), seq=512,
                                  emit=lambda s: None)
    return ({r["arch"]: r for r in got}, {r["arch"]: r for r in want})


@pytest.mark.parametrize("arch", SWEEP_ARCHS)
def test_cim_sweep_rows(sweeps, arch):
    got, want = sweeps[0][arch], sweeps[1][arch]
    assert tuple(got["best_ee_cfg"]) == tuple(want["best_ee_cfg"])
    assert tuple(got["best_th_cfg"]) == tuple(want["best_th_cfg"])
    np.testing.assert_allclose(got["tops_w"], want["tops_w"], rtol=1e-5)
    np.testing.assert_allclose(got["gops"], want["gops"], rtol=1e-5)
    assert (got["macro"], got["budget_mm2"]) == (want["macro"],
                                                 want["budget_mm2"])


def test_variants_registry_is_valid():
    """Every variant is a set of real ArchConfig fields; the registry is
    the reference's."""
    from repro_torch.configs.base import ArchConfig
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    for name, ov in dryrun.VARIANTS.items():
        assert set(ov) <= fields, (name, set(ov) - fields)
    assert dryrun.VARIANTS == ref_dryrun.VARIANTS


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_cell_report(shape_id):
    """The abstract report: status by ``skip_shapes``, the state's bytes
    from the abstract arguments, MODEL_FLOPS, fit against an H100."""
    for arch in ("yi-6b", "falcon-mamba-7b"):
        rec = dryrun.run_cell(arch, shape_id, device="cpu")
        if shape_id in get_arch(arch).skip_shapes:
            assert rec["status"] == "SKIP"
            continue
        assert rec["status"] == "OK"
        assert rec["model_flops"] == ref_roofline.model_flops(arch, shape_id)
        n = build_model(get_arch(arch)).param_count()
        assert rec["param_count"] == n
        if SHAPES[shape_id].kind == "train":
            assert rec["param_bytes"] == 4 * n       # fp32 masters
            assert rec["opt_bytes"] == 8 * n and rec["grad_bytes"] == 4 * n
        assert rec["state_bytes"] == sum(rec[k] for k in (
            "param_bytes", "opt_bytes", "grad_bytes", "batch_bytes",
            "cache_bytes") if k in rec)
        assert rec["fits"] == (rec["state_bytes"] <= dryrun.H100_BYTES)


def test_cell_report_measured_on_the_cpu():
    """``--measure``'s path at a small size on the CPU (a gloo mesh of
    one): the step runs and reports its time and launches; no device
    metric is written for a CPU run."""
    import torch.distributed as dist
    started = not dist.is_initialized()
    try:
        rec = dryrun.run_cell(
            "yi-6b", "train_4k", measure=True, device="cpu",
            overrides=dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=128, vocab=512, batch=2,
                           seq=32))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    m = rec["measured"]
    assert m["device"] == "cpu" and m["steps"] == dryrun.MEASURE_STEPS
    assert m["step_s"] > 0 and np.isfinite(m["last_value"])
    assert "peak_bytes" not in m and "model_flops_share" not in m


#: the perf variants' losses against the baseline's (the reference's
#: test), and the baseline against the reference's loss on the same
#: weights (bf16 rounded in other places: PR 18's excess precision)
VARIANT_TOL = 0.05


def _granite():
    import jax
    base = get_arch("granite-moe-3b-a800m").reduced()
    ref_base = ref_arch("granite-moe-3b-a800m").reduced()
    ref_params = ref_build_model(ref_base).init(jax.random.PRNGKey(0))
    params = convert.lm_params(jax.tree.map(np.asarray, ref_params), base,
                               trainable=True)
    toks = np.random.default_rng(0).integers(0, base.vocab, (2, 17))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])}
    return base, ref_base, ref_params, params, batch


def test_variant_baseline_matches_the_reference():
    import jax
    base, ref_base, ref_params, params, batch = _granite()
    with torch.no_grad():
        got, _ = build_model(base).loss(params, batch)
    want, _ = jax.jit(ref_build_model(ref_base).loss)(ref_params, {
        k: np.asarray(v.numpy(), np.int32) for k, v in batch.items()})
    assert abs(float(got) - float(want)) < VARIANT_TOL


@pytest.mark.parametrize("overrides", [
    {"cast_params_bf16": True},
    {"remat_policy": "dots"},
    {"seq_shard_attn": True},
    {"seq_shard_attn": True, "shard_attn": False},
    {"moe_row_dispatch": True},
    {"fsdp": True},
])
def test_variant_loss_close_to_baseline(overrides):
    base, _, _, params, batch = _granite()
    with torch.no_grad():
        l0, _ = build_model(base).loss(params, batch)
        l1, _ = build_model(dataclasses.replace(base, **overrides)).loss(
            params, batch)
    assert abs(float(l0) - float(l1)) < VARIANT_TOL, overrides
