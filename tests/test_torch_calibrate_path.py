"""The calibration path of the port end to end on the CPU: ``python -m
repro_torch.service calibrate --device cpu`` in a process where JAX and
the reference package are blocked writes an artifact both packages read;
refitting its measurements in-process gives the CLI's factors; and a
calibrated exhaustive ``co_explore`` (fp64, small design space) picks the
reference's config and per-operator strategies under the same
``CorrectionFactors``, with metrics at rtol 1e-12, under its own job key."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core as ref  # noqa: E402
import repro.core.calibration as ref_cal  # noqa: E402
from repro.compat import enable_x64  # noqa: E402

import repro_torch.core as port  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core.engine import ExploreJob, job_key  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(mr=(1, 2, 3), mc=(1, 2), scr=(1, 4, 16), is_kb=(2, 16, 128),
             os_kb=(2, 16, 64))
PEAKS = {"CIM_TUNER_PEAK_FLOPS": "6.7e13", "CIM_TUNER_PEAK_BW": "3.35e12"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k, v in PEAKS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv(cal.CALIBRATION_ENV, raising=False)
    cal.reset_calibration_state()
    ref_cal.reset_calibration_state()
    yield
    cal.reset_calibration_state()
    ref_cal.reset_calibration_state()


def _cli(*args: str) -> subprocess.CompletedProcess:
    code = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'): sys.modules[name] = None\n"
            f"sys.argv = ['repro_torch.service', *{list(args)!r}]\n"
            "runpy.run_module('repro_torch.service', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **PEAKS)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def cli_artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("cal") / "calibration.json"
    proc = _cli("calibrate", "--device", "cpu", "--repeats", "1", "--json",
                "-o", str(path))
    assert proc.returncode == 0, proc.stderr
    return path, json.loads(proc.stdout)


def test_cli_writes_an_artifact_both_packages_read(cli_artifact):
    path, out = cli_artifact
    assert out["records"] == 7 and out["artifact"] == str(path)
    port_cf, payload = cal.load_calibration(str(path))
    ref_cf, _ = ref_cal.load_calibration(str(path))
    assert port_cf == convert.correction_factors(ref_cf)
    assert port_cf.as_dict() == out["corrections"]
    assert payload["version"] == out["version"] == \
        cal.calibration_version(port_cf)
    kernels = {r["kernel"] for r in payload["measurements"]}
    assert kernels == {"cim_matmul", "flash_attention", "selective_scan",
                       "strategy_eval"}


def test_refit_in_process_gives_the_cli_factors(cli_artifact):
    """The two ways in -- the CLI, and run_microbench -> fit_report +
    fit_corrections -> save_calibration -- fit the same records alike, in
    either package."""
    path, out = cli_artifact
    records = cal.load_calibration(str(path))[1]["measurements"]
    assert cal.fit_corrections(records).as_dict() == out["corrections"]
    assert cal.fit_report(records, 0.25, seed=0) == out["report"]
    assert ref_cal.fit_corrections(records).as_dict() == out["corrections"]
    proc = _cli("calibrate", "--input", str(path), "--json")
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["corrections"] == out["corrections"]


def test_profile_cli_on_the_cpu():
    proc = _cli("profile", "--device", "cpu", "--repeats", "1", "--json",
                "--kernels", "cim_matmul,selective_scan")
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout)
    assert [(r["kernel"], r["bucket"], r["calls"]) for r in rows] == [
        ("cim_matmul", "128x128x128", 2), ("selective_scan", "1x64x32x8", 2)]


def test_cli_without_a_card_fails_cleanly():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = _cli("calibrate", "--repeats", "1")
    assert proc.returncode == 2
    assert "no CUDA card" in proc.stderr


CF = dict(compute=2.5, memory=0.4, update=0.4)


@pytest.mark.parametrize("objective", ["ee", "edp"])
def test_calibrated_exhaustive_matches_reference(objective):
    ref_cf = ref_cal.CorrectionFactors(**CF)
    with enable_x64(True):
        want = ref.co_explore(
            ref.get_macro("vanilla-dcim"), ref.bert_large_workload(), 5.0,
            objective=objective, method="exhaustive",
            tech=ref_cal.CostModel(corrections=ref_cf).tech,
            space=ref.DesignSpace(**SMALL),
            engine=ref.ExplorationEngine(persistent_compile_cache=False))
    tech = port.CostModel(corrections=convert.correction_factors(ref_cf)).tech
    got = port.co_explore(
        port.get_macro("vanilla-dcim"), port.bert_large_workload(), 5.0,
        objective=objective, method="exhaustive", tech=tech,
        space=port.DesignSpace(**SMALL), device="cpu", dtype=torch.float64)
    assert got.config.as_tuple() == want.config.as_tuple()
    assert list(got.per_op_strategy) == list(want.per_op_strategy)
    for k in ("tops_w", "gops", "area_mm2", "energy_pj", "latency_s"):
        assert got.metrics[k] == pytest.approx(want.metrics[k], rel=1e-12)


def test_pinned_artifact_drives_exploration(tmp_path, monkeypatch):
    """CIM_TUNER_CALIBRATION -> default_cost_model() -> co_explore: the
    calibrated job has its own job key and the explicit-tech answer."""
    cf = cal.CorrectionFactors(**CF)
    path = str(tmp_path / "pinned.json")
    cal.save_calibration(path, cf)
    monkeypatch.setenv(cal.CALIBRATION_ENV, path)
    cal.reset_calibration_state()
    cm = port.default_cost_model()
    assert cm.calibrated and cm.version == cal.calibration_version(cf)
    kw = dict(objective="ee", method="exhaustive",
              space=port.DesignSpace(**SMALL), device="cpu",
              dtype=torch.float64)
    macro, wl = port.get_macro("vanilla-dcim"), port.bert_large_workload()
    pinned = port.co_explore(macro, wl, 5.0, tech=cm.tech, **kw)
    explicit = port.co_explore(
        macro, wl, 5.0, tech=port.DEFAULT_TECH.with_corrections(cf), **kw)
    assert pinned.config == explicit.config
    assert pinned.per_op_strategy == explicit.per_op_strategy
    analytic = ExploreJob(macro, wl, 5.0, space=kw["space"])
    calibrated = ExploreJob(macro, wl, 5.0, space=kw["space"], tech=cm.tech)
    assert job_key(analytic, "exhaustive") != \
        job_key(calibrated, "exhaustive")
