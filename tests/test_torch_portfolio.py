"""The port's portfolio racer held against the reference: the plan
helpers equal the reference's on a grid of settings (and reject the same
settings with the same errors), and on the small space of
tests/test_search.py the race keeps the reference's guarantees for both
allocators -- never worse than a constituent's rung-0 solo run, the bandit
spends exactly its pulls, replay, batch independence, rung admission bit
for bit, budget-flow conservation, progress-bus payloads equal to the
flight recorder's -- and the measured-fidelity rung re-scores its top-K
exactly as the reference's ``candidate_values`` does under the same
corrected constants (fp64)."""
from __future__ import annotations

import dataclasses
import itertools
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core as ref  # noqa: E402
import repro.core.calibration as ref_cal  # noqa: E402
import repro.search.portfolio as ref_pf  # noqa: E402
from repro.compat import enable_x64  # noqa: E402
from repro.core.engine import _spearman as ref_spearman  # noqa: E402

import repro_torch.core as port  # noqa: E402
import repro_torch.search.portfolio as pf  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core.engine import _spearman, job_key  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import profile  # noqa: E402

SMALL = dict(mr=(1, 2, 3), mc=(1, 2), scr=(1, 4, 16), is_kb=(2, 16, 128),
             os_kb=(2, 16, 64))
#: tests/test_scheduler.py's small race: 2 backends x 2 rungs
PS = dict(backends=("sa", "sobol"), total_evals=64, rungs=2)
F64 = dict(device="cpu", dtype=torch.float64)


def _job(budget=2.23, objective="ee"):
    return port.ExploreJob(port.get_macro("tpdcim-macro"),
                           port.bert_large_workload(), budget,
                           objective=objective,
                           space=port.DesignSpace(**SMALL),
                           search_method="portfolio")


def _equal_results(a, b) -> None:
    assert a.config.as_tuple() == b.config.as_tuple()
    for k in ("energy_pj", "latency_cycles", "tops_w", "gops", "area_mm2"):
        assert a.metrics[k] == b.metrics[k], k
    assert a.search["portfolio"] == b.search["portfolio"]
    assert torch.equal(a.sa.best_per_chain, b.sa.best_per_chain)


def _both(**kw):
    return pf.PortfolioSettings(**kw), ref_pf.PortfolioSettings(**kw)


def _asdict(plan):
    if isinstance(plan, list):
        return [_asdict(p) for p in plan]
    if isinstance(plan, dict):
        return {k: _asdict(v) for k, v in plan.items()}
    return dataclasses.asdict(plan)


# ------------------------------------------------------------------ #
# plan helpers: equal to the reference's
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("total_evals", [64, 3000, 25_600])
@pytest.mark.parametrize("rungs", [1, 2, 3])
@pytest.mark.parametrize("allocator", ["bandit", "halving"])
def test_plans_equal_the_reference(allocator, rungs, total_evals):
    s, rs = _both(allocator=allocator, rungs=rungs, total_evals=total_evals,
                  seed=5)
    assert _asdict(pf.race_plan(s)) == _asdict(ref_pf.race_plan(rs))
    assert _asdict(pf.final_plan(s)) == _asdict(ref_pf.final_plan(rs))
    assert pf.bandit_rounds(s) == ref_pf.bandit_rounds(rs)
    assert pf.bandit_slice(s) == ref_pf.bandit_slice(rs)
    for b in range(len(s.backends)):
        for pull in range(pf.bandit_rounds(s) + 2):
            assert _asdict(pf.bandit_pull_plan(s, b, pull)) == \
                _asdict(ref_pf.bandit_pull_plan(rs, b, pull))
            assert pf.derived_seed(s.seed, b, pull) == \
                ref_pf.derived_seed(rs.seed, b, pull)


def test_scores_rewards_and_placement_equal_the_reference():
    rng = np.random.default_rng(0)
    mean = rng.random((5, 4))
    pulls = rng.integers(0, 4, (5, 4))
    for c in (0.0, 0.5, 2.0):
        np.testing.assert_array_equal(pf.ucb_scores(mean, pulls, c),
                                      ref_pf.ucb_scores(mean, pulls, c))
    for prev in (np.inf, 10.0, -3.0, 0.0):
        for trace in ([12.0, 9.0, 4.0], [3.0, 3.0], [-5.0, -7.0]):
            assert pf.pull_reward(prev, np.asarray(trace)) == \
                ref_pf.pull_reward(prev, np.asarray(trace))
    for aff in (None, (0, 3, 1, 2), (5, 5, 0, 1)):
        s, rs = _both(device_affinity=aff)
        for devices in ([None], ["a", "b"], ["a", "b", "c"]):
            assert pf.constituent_devices(s, devices) == \
                ref_pf.constituent_devices(rs, devices)


BAD_SETTINGS = [
    dict(fidelity="quantum"), dict(topk=0), dict(allocator="greedy"),
    dict(flatline_waves=-1), dict(flatline_waves=2, allocator="halving"),
    dict(flatline_eps=-1.0), dict(device_affinity=(0,)),
    dict(device_affinity=(0, 0, -1, 0)),
]


@pytest.mark.parametrize("kw", BAD_SETTINGS, ids=str)
def test_validation_errors_equal_the_reference(kw):
    with pytest.raises(ValueError) as got:
        pf.PortfolioSettings(**kw)
    with pytest.raises(ValueError) as want:
        ref_pf.PortfolioSettings(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(backends=()), dict(backends=("nope",)),
                                dict(backends=("sa", "portfolio"))], ids=str)
def test_plan_validation_errors_equal_the_reference(kw):
    s, rs = _both(**kw)
    with pytest.raises(ValueError) as got:
        pf.race_plan(s)
    with pytest.raises(ValueError) as want:
        ref_pf.race_plan(rs)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ #
# race guarantees, both allocators
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("allocator", ["bandit", "halving"])
def test_not_worse_than_any_rung0_solo_run(allocator):
    settings = pf.PortfolioSettings(total_evals=2000, seed=3,
                                    allocator=allocator)
    engine = port.ExplorationEngine(**F64)
    job = _job()
    res = engine.run([job], method="portfolio", settings=settings)[0]
    race = res.search["portfolio"]["race"]
    assert set(race) == set(settings.backends)
    best = float(res.sa.best_value)
    assert best <= min(race.values())
    assert best <= res.search["portfolio"]["final"]
    assert float(res.sa.best_per_chain.min()) == best
    rung0 = pf.race_plan(settings)[0]
    for name in settings.backends:
        solo = engine.run([job], method=name, settings=rung0[name])[0]
        assert best <= float(solo.sa.best_value), name
        # the recorded race value IS the standalone run's best (the same
        # derived seed replays the pull exactly)
        assert race[name] <= float(solo.sa.best_value), name


def test_bandit_spends_exactly_its_pulls():
    settings = pf.PortfolioSettings(total_evals=3000, seed=1)
    res = port.ExplorationEngine(**F64).run(
        [_job()], method="portfolio", settings=settings)[0]
    pulls = res.search["portfolio"]["pulls"]
    assert sum(pulls.values()) == pf.bandit_rounds(settings)
    assert min(pulls.values()) >= 1, "every arm gets its init pull"
    assert res.search["budget_flow"]["race_pulls"] == \
        pf.bandit_rounds(settings)


@pytest.mark.parametrize("allocator", ["bandit", "halving"])
def test_replays_and_is_batch_independent(allocator):
    settings = pf.PortfolioSettings(total_evals=1500, seed=2,
                                    allocator=allocator)
    jobs = [_job(2.23, "ee"), _job(2.5, "th")]
    a = port.ExplorationEngine(**F64).run(jobs, method="portfolio",
                                          settings=settings)
    b = port.ExplorationEngine(**F64).run(jobs, method="portfolio",
                                          settings=settings)
    for ra, rb, job in zip(a, b, jobs):
        _equal_results(ra, rb)
        solo = port.ExplorationEngine(**F64).run(
            [job], method="portfolio", settings=settings)[0]
        _equal_results(ra, solo)


def test_rung_admitted_job_matches_solo_run_bitwise():
    engine = port.ExplorationEngine(**F64)
    settings = pf.PortfolioSettings(**PS)
    early, late = _job(2.23), _job(2.24)
    solo_early = engine.run([early], method="portfolio",
                            settings=settings)[0]
    solo_late = engine.run([late], method="portfolio", settings=settings)[0]
    polls = {"n": 0}

    def admit():
        polls["n"] += 1
        if polls["n"] == 3:     # join at the boundary before wave 2
            return [(late, job_key(late, "portfolio", settings,
                                   torch.float64))]
        return []

    outs = engine.run([early], method="portfolio", settings=settings,
                      keys=[job_key(early, "portfolio", settings,
                                    torch.float64)], admit=admit)
    assert len(outs) == 2, "admitted result must ride behind the batch"
    _equal_results(outs[0], solo_early)
    _equal_results(outs[1], solo_late)
    assert outs[1].search["budget_flow"]["admitted_wave"] == 2
    assert outs[0].search["budget_flow"]["admitted_wave"] == 0
    assert polls["n"] >= 3


@pytest.mark.parametrize("method,settings", [
    ("exhaustive", None),
    ("portfolio", pf.PortfolioSettings(**PS, allocator="halving")),
    ("sa", port.SASettings(n_chains=4, n_steps=4)),
], ids=["exhaustive", "halving", "sa"])
def test_admit_requires_single_bandit_portfolio_group(method, settings):
    with pytest.raises(ValueError, match="admission"):
        port.ExplorationEngine(device="cpu").run(
            [_job()], method=method, settings=settings, admit=lambda: [])


def test_admit_requires_one_bucket():
    from repro_torch.configs import get_arch
    other = dataclasses.replace(
        _job(), workload=get_arch("whisper-small").workload(seq=512))
    with pytest.raises(ValueError, match="single executable bucket"):
        port.ExplorationEngine(device="cpu").run(
            [_job(), other], method="portfolio",
            settings=pf.PortfolioSettings(**PS), admit=lambda: [])


def test_budget_flow_conserves_pulls_and_replays():
    settings = pf.PortfolioSettings(**PS, flatline_waves=1,
                                    flatline_eps=0.5)
    jobs = [_job(2.23), _job(2.24)]
    a = port.ExplorationEngine(**F64).run(jobs, method="portfolio",
                                          settings=settings)
    b = port.ExplorationEngine(**F64).run(jobs, method="portfolio",
                                          settings=settings)
    flows = [r.search["budget_flow"] for r in a]
    assert all(f["enabled"] for f in flows)
    total = sum(f["race_pulls"] for f in flows) + flows[0]["pool_leftover"]
    assert total == len(jobs) * pf.bandit_rounds(settings)
    assert any(f["flatlined"] for f in flows)
    for ra, rb in zip(a, b):
        _equal_results(ra, rb)
        assert ra.search["budget_flow"] == rb.search["budget_flow"]


@pytest.mark.parametrize("allocator", ["bandit", "halving"])
def test_progress_bus_payloads_equal_the_flight_recorder(allocator):
    settings = pf.PortfolioSettings(total_evals=1500, seed=4,
                                    allocator=allocator)
    job = _job()
    key = job_key(job, "portfolio", settings, torch.float64)
    live = []

    def sink(_key, ev):
        live.append(ev)
    obs.progress_bus().subscribe([key], sink)
    try:
        port.ExplorationEngine(**F64).run([job], method="portfolio",
                                          settings=settings, keys=[key])
    finally:
        obs.progress_bus().unsubscribe(sink)
    timeline = obs.flight_recorder().timeline(key)
    events = timeline["events"]
    assert len(live) == len(events)
    for ev, rec in zip(live, events):
        strip = {k: v for k, v in ev.items() if k not in ("key", "seq")}
        extra = {k: rec[k] for k in ("rewards", "ucb", "chosen")
                 if k in rec}
        assert strip == {k: v for k, v in rec.items() if k not in extra}
    phases = [ev["phase"] for ev in events]
    assert phases[-1] == "final" and phases.count("race") >= 1
    assert timeline["summary"]["pulls"] == events[-1]["pulls"]
    assert "rung" in obs.render_timeline(timeline)


# ------------------------------------------------------------------ #
# the measured-fidelity rung
# ------------------------------------------------------------------ #
def _synthetic_records(n: int = 8) -> list[dict]:
    pfl, pb = profile.peak_flops(), profile.peak_bw()
    return [{"kernel": "cim_matmul", "bucket": f"b{i}", "tiling": "AF",
             "us": 2.0 * (1e9 * (i + 1)) / pfl * 1e6
             + 0.5 * (1e6 * (n - i)) / pb * 1e6,
             "flops": 1e9 * (i + 1), "bytes": 1e6 * (n - i), "seed": 0}
            for i in range(n)]


@pytest.fixture
def pinned_artifact(tmp_path, monkeypatch):
    """A port-written calibration artifact pinned through
    CIM_TUNER_CALIBRATION, so the rung runs no live kernel sweep."""
    records = _synthetic_records()
    path = str(tmp_path / "calibration.json")
    cal.save_calibration(path, cal.fit_corrections(records),
                         records=records)
    monkeypatch.setenv(cal.CALIBRATION_ENV, path)
    cal.reset_calibration_state()
    ref_cal.reset_calibration_state()
    yield path
    monkeypatch.delenv(cal.CALIBRATION_ENV)
    cal.reset_calibration_state()
    ref_cal.reset_calibration_state()


def _measured_run(engine, settings):
    """Run one measured race, keeping the candidate rows each sweep of
    the rung re-scored."""
    swept = []
    real = engine._sweep_values

    def recording(stacked, cand_rows):
        swept.append([np.array(c) for c in cand_rows])
        return real(stacked, cand_rows)
    engine._sweep_values = recording
    (res,) = engine.run([_job()], method="portfolio", settings=settings)
    return res, swept


@pytest.mark.parametrize("allocator", ["bandit", "halving"])
def test_measured_rung_equals_reference_rescoring(pinned_artifact,
                                                  allocator):
    settings = pf.PortfolioSettings(total_evals=3000, seed=1, topk=4,
                                    fidelity="measured",
                                    allocator=allocator)
    res, swept = _measured_run(port.ExplorationEngine(**F64), settings)
    tf = res.search["two_fidelity"]
    assert res.search["portfolio"]["fidelity"] == "measured"
    assert tf["source"] == "artifact" and tf["measurement_count"] == 8
    n = tf["topk"]
    assert 1 <= n <= 4
    assert sorted(tf["analytic_ranking"]) == list(range(n))
    assert sorted(tf["measured_ranking"]) == list(range(n))
    rows = swept[-1]
    assert len(swept) >= 2 and all(
        np.array_equal(a, b) for a, b in zip(swept[-2], rows))
    # the reference re-scores the same rows under its own reading of the
    # port-written artifact, in x64: exactly the port's fp64 values
    cf, payload = ref_cal.load_calibration(pinned_artifact)
    assert cf.as_dict() == tf["corrections"]
    assert ref_cal.calibration_version(cf) == tf["calibration_version"]
    ref_job = ref.ExploreJob(ref.get_macro("tpdcim-macro"),
                             ref.bert_large_workload(), 2.23,
                             space=ref.DesignSpace(**SMALL))
    with enable_x64(True):
        engine = ref.ExplorationEngine(persistent_compile_cache=False)
        want_a, want_m = engine.candidate_values(
            [ref_job, dataclasses.replace(
                ref_job, tech=ref_job.tech.with_corrections(cf))],
            [rows[0], rows[0]])
    assert tf["analytic_values"] == [float(x) for x in want_a]
    # under the corrected (non-integer) constants XLA's x64 arithmetic
    # and the port's differ in the last bit (ROADMAP.md section 3); the
    # calibrated-job tolerance of tests/test_torch_calibrate_path.py
    np.testing.assert_allclose(tf["measured_values"], want_m, rtol=1e-12,
                               atol=0)
    assert tf["measured_ranking"] == [
        int(x) for x in np.argsort(want_m, kind="stable")]
    assert tf["rank_correlation"] == ref_spearman(want_a, want_m)
    # the answer is the measured winner, finished under the corrected tech
    assert list(res.config.as_tuple()) == tf["measured_winner"]
    tech = cal.DEFAULT_TECH.with_corrections(cal.load_calibration(
        pinned_artifact)[0])
    m = port.evaluate_config(port.get_macro("tpdcim-macro"), res.config,
                             port.bert_large_workload(), tech=tech, **F64)
    for k in ("energy_pj", "latency_cycles", "tops_w", "gops"):
        assert res.metrics[k] == m[k], k


def test_measured_rung_replays(pinned_artifact):
    settings = pf.PortfolioSettings(total_evals=3000, seed=1, topk=4,
                                    fidelity="measured")
    a = port.ExplorationEngine(**F64).run([_job()], method="portfolio",
                                          settings=settings)[0]
    b = port.ExplorationEngine(**F64).run([_job()], method="portfolio",
                                          settings=settings)[0]
    assert a.config.as_tuple() == b.config.as_tuple()
    assert a.search["two_fidelity"] == b.search["two_fidelity"]
    analytic = port.ExplorationEngine(**F64).run(
        [_job()], method="portfolio",
        settings=dataclasses.replace(settings, fidelity="analytic"))[0]
    assert "two_fidelity" not in analytic.search


def test_spearman_equals_the_reference():
    rng = np.random.default_rng(1)
    for n in (1, 2, 5, 8):
        for _ in range(5):
            a, b = rng.random(n), rng.random(n)
            b[: n // 2] = a[: n // 2]
            assert _spearman(a, b) == ref_spearman(a, b)
    ties = np.array([1.0, 1.0, 2.0, 2.0])
    assert _spearman(ties, ties[::-1]) == ref_spearman(ties, ties[::-1])


def test_job_key_separates_fidelities(pinned_artifact):
    job = _job()
    k_analytic = job_key(job, "portfolio", pf.PortfolioSettings(seed=1))
    k_measured = job_key(job, "portfolio",
                         pf.PortfolioSettings(seed=1, fidelity="measured"))
    assert k_analytic != k_measured
    pin = os.environ.pop(cal.CALIBRATION_ENV)
    cal.reset_calibration_state()
    try:
        # analytic keys do not depend on the calibration; a measured key
        # with nothing pinned names the live sentinel, without measuring
        assert job_key(job, "portfolio",
                       pf.PortfolioSettings(seed=1)) == k_analytic
        before = {k: w.launches for k, w in ops.KERNEL_WRAPPERS.items()}
        k_live = job_key(job, "portfolio",
                         pf.PortfolioSettings(seed=1, fidelity="measured"))
        assert k_live != k_measured
        assert cal.active_calibration_version() == "live", \
            "submitting must not measure"
        assert {k: w.launches for k, w in
                ops.KERNEL_WRAPPERS.items()} == before
    finally:
        os.environ[cal.CALIBRATION_ENV] = pin
        cal.reset_calibration_state()


def test_settings_grid_covers_both_allocators():
    """Every (allocator, fidelity) pairing constructs, as the
    reference's does."""
    for allocator, fidelity in itertools.product(pf.ALLOCATORS,
                                                 pf.FIDELITIES):
        s, rs = _both(allocator=allocator, fidelity=fidelity)
        assert dataclasses.asdict(s) == dataclasses.asdict(rs)
    assert pf.ALLOCATORS == ref_pf.ALLOCATORS
    assert pf.FIDELITIES == ref_pf.FIDELITIES
