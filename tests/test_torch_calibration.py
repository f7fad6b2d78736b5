"""The port's calibration tier (``repro_torch.core.calibration``) held
two ways: the reference's own fit tests (tests/test_calibration_fit.py)
run against the port, and the two packages compared on the same records
-- with ``CIM_TUNER_PEAK_*`` pinned to equal values for both, the fit,
the report, the version and ``with_corrections`` agree exactly, and an
artifact written by either package loads in the other."""
from __future__ import annotations

import dataclasses
import math

import pytest

pytest.importorskip("jax")

import repro.core.calibration as ref_cal  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core.calibration import (  # noqa: E402
    DEFAULT_TECH,
    CALIBRATION_ENV,
    CorrectionFactors,
    CostModel,
    calibration_version,
    default_cost_model,
    evaluate_corrections,
    fit_corrections,
    fit_report,
    load_calibration,
    reset_calibration_state,
    resolve_tech,
    save_calibration,
)
from repro_torch.obs import profile  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_calibration(monkeypatch):
    """Each test sees no pinned artifact and no cached live fit."""
    monkeypatch.delenv(CALIBRATION_ENV, raising=False)
    reset_calibration_state()
    ref_cal.reset_calibration_state()
    yield
    reset_calibration_state()
    ref_cal.reset_calibration_state()


def _synthetic_records(compute: float, memory: float, n: int = 12,
                       noise: float = 0.0) -> list[dict]:
    """Records whose timings follow the fit model with KNOWN factors.

    flops:bytes ratios are spread out so the two roofline features are
    far from collinear and the joint 2x2 solve is well conditioned."""
    pf, pb = profile.peak_flops(), profile.peak_bw()
    records = []
    for i in range(n):
        flops = 1e9 * (i + 1)
        nbytes = 1e6 * (n - i)
        t_c = flops / pf * 1e6
        t_m = nbytes / pb * 1e6
        us = compute * t_c + memory * t_m
        if noise:
            us *= 1.0 + noise * ((-1) ** i)     # deterministic "noise"
        records.append({"kernel": "cim_matmul", "bucket": f"b{i}",
                        "tiling": "AF", "us": us, "flops": flops,
                        "bytes": nbytes, "seed": 0})
    return records


def test_fit_recovers_known_distortion():
    cf = fit_corrections(_synthetic_records(compute=3.7, memory=0.4))
    assert cf.compute == pytest.approx(3.7, rel=1e-6)
    assert cf.memory == pytest.approx(0.4, rel=1e-6)
    assert cf.update == cf.memory, "update must ride the memory term"
    assert cf.leakage == 1.0, "microbench cannot observe static power"
    assert cf.fitted_on == 12
    assert cf.residual_us == pytest.approx(0.0, abs=1e-6)


def test_fit_survives_noise_and_clamps():
    cf = fit_corrections(_synthetic_records(2.0, 5.0, noise=0.1))
    assert cf.compute == pytest.approx(2.0, rel=0.35)
    assert cf.memory == pytest.approx(5.0, rel=0.35)
    assert cf.residual_us > 0.0
    # absurd distortions clamp to the documented [1e-3, 1e3] range
    big = fit_corrections(_synthetic_records(1e9, 1e9))
    assert big.compute <= 1e3 and big.memory <= 1e3


def test_fit_raises_without_cost_analysis():
    bad = [{"kernel": "k", "bucket": "b", "tiling": "t", "us": 1.0,
            "flops": None, "bytes": None, "seed": 0}]
    with pytest.raises(ValueError, match="no usable measurement"):
        fit_corrections(bad)


def test_held_out_error_strictly_below_uncalibrated():
    records = _synthetic_records(4.0, 0.25, n=16, noise=0.05)
    rep = fit_report(records, holdout_fraction=0.25, seed=3)
    assert rep["holdout_records"] >= 1
    assert rep["train_records"] + rep["holdout_records"] == len(records)
    assert rep["calibrated_rms_us"] < rep["uncalibrated_rms_us"], \
        "fitted model must beat the identity model on records it never saw"
    assert rep["improvement"] > 1.0
    # the report's factors match a direct fit on the same train split
    cal = evaluate_corrections(records, fit_corrections(records))
    assert cal <= evaluate_corrections(records)


def test_version_stable_and_content_addressed():
    a = fit_corrections(_synthetic_records(3.0, 0.5))
    b = fit_corrections(_synthetic_records(3.0, 0.5))
    c = fit_corrections(_synthetic_records(3.1, 0.5))
    assert calibration_version(a) == calibration_version(b)
    assert calibration_version(a) != calibration_version(c)
    assert calibration_version(None) == "uncalibrated"
    assert calibration_version(CorrectionFactors()) == "uncalibrated"


def test_artifact_round_trip(tmp_path):
    records = _synthetic_records(2.5, 0.8)
    cf = fit_corrections(records)
    path = str(tmp_path / "calibration.json")
    payload = save_calibration(path, cf, records=records,
                               report=fit_report(records))
    loaded, raw = load_calibration(path)
    assert loaded == cf
    assert raw["version"] == payload["version"] == calibration_version(cf)
    assert len(raw["measurements"]) == len(records)
    assert raw["report"]["improvement"] > 0.0


def test_with_corrections_touches_energy_not_area():
    cf = CorrectionFactors(compute=2.0, memory=3.0, update=4.0)
    tech = DEFAULT_TECH.with_corrections(cf)
    assert tech.e_mac_pj == DEFAULT_TECH.e_mac_pj * 2.0
    assert tech.e_sram_rd_pj_bit == DEFAULT_TECH.e_sram_rd_pj_bit * 3.0
    assert tech.e_ema_pj_bit == DEFAULT_TECH.e_ema_pj_bit * 3.0
    assert tech.e_cim_update_pj_bit == \
        DEFAULT_TECH.e_cim_update_pj_bit * 4.0
    # area and frequency are fidelity-invariant by design
    assert tech.a_cell_um2_bit == DEFAULT_TECH.a_cell_um2_bit
    assert tech.a_cu_um2 == DEFAULT_TECH.a_cu_um2
    assert tech.freq_mhz == DEFAULT_TECH.freq_mhz
    # identity corrections are bit-exact no-ops (same object)
    assert DEFAULT_TECH.with_corrections(None) is DEFAULT_TECH
    assert DEFAULT_TECH.with_corrections(CorrectionFactors()) is DEFAULT_TECH


def test_cost_model_facade_resolution():
    analytic = CostModel()
    assert analytic.tech is DEFAULT_TECH and not analytic.calibrated
    assert analytic.version == "uncalibrated"
    cf = CorrectionFactors(compute=2.0, memory=2.0, update=2.0)
    measured = CostModel(corrections=cf)
    assert measured.calibrated
    assert measured.version == calibration_version(cf)
    assert measured.tech.e_mac_pj == DEFAULT_TECH.e_mac_pj * 2.0
    assert resolve_tech(None) is DEFAULT_TECH
    custom = dataclasses.replace(DEFAULT_TECH, freq_mhz=1000.0)
    assert resolve_tech(custom) is custom


def test_default_cost_model_follows_env_pin(tmp_path, monkeypatch):
    assert not default_cost_model().calibrated
    records = _synthetic_records(3.0, 0.5)
    path = str(tmp_path / "cal.json")
    save_calibration(path, fit_corrections(records), records=records)
    monkeypatch.setenv(CALIBRATION_ENV, path)
    reset_calibration_state()               # env changed -> re-resolve
    cm = default_cost_model()
    assert cm.calibrated
    assert cm.version == calibration_version(fit_corrections(records))
    assert math.isfinite(cm.tech.e_mac_pj)
    monkeypatch.delenv(CALIBRATION_ENV)
    reset_calibration_state()
    assert not default_cost_model().calibrated


# --------------------------------------------------------------------- #
# the port against the reference on the same records
# --------------------------------------------------------------------- #
@pytest.fixture
def equal_peaks(monkeypatch):
    """Both packages draw their roofline against the same peaks."""
    monkeypatch.setenv("CIM_TUNER_PEAK_FLOPS", "6.7e13")
    monkeypatch.setenv("CIM_TUNER_PEAK_BW", "3.35e12")


def _measured_like_records() -> list[dict]:
    """Records of the microbench's shape: 7 kernel cases x 3 repeats with
    uneven timings (a fit that is neither exact nor collinear)."""
    cases = [("cim_matmul", "128x128x128", "AF", 4194304.0, 196608.0),
             ("cim_matmul", "128x128x128", "PF", 4194304.0, 196608.0),
             ("flash_attention", "1x128x128x64", "bq128xbk128", 2.15e6,
              131072.0),
             ("flash_attention", "1x128x128x64", "bq64xbk64", 2.15e6,
              131072.0),
             ("selective_scan", "1x64x32x8", "ct16xci16", 116736.0, 31744.0),
             ("selective_scan", "1x64x32x8", "ct32xci32", 116736.0, 31744.0),
             ("strategy_eval", "C32xP5", "default", 159000.0, 996.0)]
    out = []
    for n, (kernel, bucket, tiling, flops, nbytes) in enumerate(cases):
        for rep in range(3):
            out.append({"kernel": kernel, "bucket": bucket,
                        "tiling": tiling, "us": 7.0 + 3.3 * n + 0.7 * rep,
                        "flops": flops, "bytes": nbytes, "seed": 0})
    return out


@pytest.mark.parametrize("records", [
    _measured_like_records(),
    _synthetic_records(3.7, 0.4),
    _synthetic_records(2.0, 5.0, noise=0.1),
], ids=["measured-like", "exact", "noisy"])
def test_fit_equals_reference(equal_peaks, records):
    got = fit_corrections(records)
    want = convert.correction_factors(ref_cal.fit_corrections(records))
    assert got == want
    assert calibration_version(got) == ref_cal.calibration_version(
        ref_cal.fit_corrections(records))
    assert fit_report(records, 0.25, seed=3) == ref_cal.fit_report(
        records, 0.25, seed=3)
    assert evaluate_corrections(records, got) == \
        ref_cal.evaluate_corrections(records,
                                     ref_cal.fit_corrections(records))


def test_with_corrections_equals_reference(equal_peaks):
    records = _measured_like_records()
    ref_cf = ref_cal.fit_corrections(records)
    port_tech = DEFAULT_TECH.with_corrections(
        convert.correction_factors(ref_cf))
    ref_tech = ref_cal.DEFAULT_TECH.with_corrections(ref_cf)
    assert port_tech == convert.tech_constants(ref_tech)
    assert CostModel(corrections=fit_corrections(records)).version == \
        ref_cal.CostModel(corrections=ref_cf).version


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_artifact_loads_in_the_other_package(equal_peaks, tmp_path, writer):
    records = _measured_like_records()
    path = str(tmp_path / f"{writer}.json")
    if writer == "port":
        cf = fit_corrections(records)
        save_calibration(path, cf, records=records,
                         report=fit_report(records))
        loaded, payload = ref_cal.load_calibration(path)
        assert convert.correction_factors(loaded) == cf
    else:
        cf = ref_cal.fit_corrections(records)
        ref_cal.save_calibration(path, cf, records=records,
                                 report=ref_cal.fit_report(records))
        loaded, payload = load_calibration(path)
        assert loaded == convert.correction_factors(cf)
    assert payload["version"] == calibration_version(
        convert.correction_factors(cf))
    assert convert.measurement_records(payload["measurements"]) == records


def test_pinned_artifact_of_the_reference_drives_the_port(
        equal_peaks, tmp_path, monkeypatch):
    records = _measured_like_records()
    path = str(tmp_path / "ref.json")
    ref_cal.save_calibration(path, ref_cal.fit_corrections(records),
                             records=records)
    monkeypatch.setenv(CALIBRATION_ENV, path)
    reset_calibration_state()
    ref_cal.reset_calibration_state()
    assert default_cost_model().tech == convert.tech_constants(
        ref_cal.default_cost_model().tech)
    from repro_torch.core.calibration import (active_calibration_version,
                                              calibration_record,
                                              resolve_corrections)
    cf, source, meas = resolve_corrections()
    assert source == "artifact" and len(meas) == len(records)
    assert active_calibration_version() == \
        ref_cal.active_calibration_version()
    assert calibration_record()["version"] == \
        ref_cal.calibration_record()["version"]


def test_peaks_default_to_the_h100(monkeypatch):
    monkeypatch.delenv("CIM_TUNER_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("CIM_TUNER_PEAK_BW", raising=False)
    assert profile.peak_flops() == 67e12
    assert profile.peak_bw() == 3.35e12
