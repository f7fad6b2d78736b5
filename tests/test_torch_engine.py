"""The port's engine and explorer held against the reference on the small
space of tests/test_engine.py: the exhaustive sweep picks the same config
and per-operator strategies in fp64, frontiers and fixed-config metrics
agree, SA reaches within 1 % of the exhaustive optimum, and identical jobs
in one run evaluate once."""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core as ref  # noqa: E402
from repro.compat import enable_x64  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402

import repro_torch.core as port  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.engine import job_key  # noqa: E402

SMALL = dict(mr=(1, 2, 3), mc=(1, 2), scr=(1, 4, 16), is_kb=(2, 16, 128),
             os_kb=(2, 16, 64))
F64 = dict(device="cpu", dtype=torch.float64)


def _ref_workload(name):
    if name == "bert-large":
        return ref.bert_large_workload()
    return ref_get_arch(name).workload(seq=512)


def _ref_jobs(name):
    wl = _ref_workload(name)
    return [ref.ExploreJob(ref.get_macro("vanilla-dcim"), wl, 5.0,
                           objective=obj, strategy_set=sset,
                           space=ref.DesignSpace(**SMALL))
            for sset in ("st", "so") for obj in ("ee", "th")]


def _port_job(j):
    return port.ExploreJob(
        convert.macro_spec(j.macro), convert.workload(j.workload),
        j.area_budget_mm2, objective=j.objective,
        strategy_set=j.strategy_set, bw=j.bw,
        tech=convert.tech_constants(j.tech),
        space=convert.design_space(j.space))


def _ref_engine():
    return ref.ExplorationEngine(persistent_compile_cache=False)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-6)])
@pytest.mark.parametrize("name", ["bert-large", "yi-6b", "whisper-small"])
def test_exhaustive_matches_reference(name, dtype, rtol):
    """fp64 against the reference's x64 mode, fp32 against its default."""
    jobs = _ref_jobs(name)
    with enable_x64(dtype == torch.float64):
        want = _ref_engine().run(jobs, method="exhaustive")
    got = port.ExplorationEngine(device="cpu", dtype=dtype).run(
        [_port_job(j) for j in jobs], method="exhaustive")
    for g, w in zip(got, want):
        assert g.config.as_tuple() == w.config.as_tuple()
        assert g.per_op_strategy == w.per_op_strategy
        assert g.metrics["latency_cycles"] == w.metrics["latency_cycles"]
        for k in ("energy_pj", "tops_w", "gops", "area_mm2"):
            assert g.metrics[k] == pytest.approx(w.metrics[k], rel=rtol), k
        for k in ("raw", "kept", "bandwidth_pruned", "area_pruned"):
            assert g.search[k] == w.search[k]
        assert g.search["device"] == "cpu"
        assert g.search["dtype"] == str(dtype)


def test_co_explore_macros_matches_reference():
    macros = ["vanilla-dcim", "lcc-cim", "tpdcim-macro"]
    kw = dict(method="exhaustive", space=ref.DesignSpace(**SMALL))
    with enable_x64(True):
        best_w, all_w = ref.co_explore_macros(
            [ref.get_macro(m) for m in macros], ref.bert_large_workload(),
            3.0, engine=_ref_engine(), **kw)
    best_g, all_g = port.co_explore_macros(
        [port.get_macro(m) for m in macros], port.bert_large_workload(), 3.0,
        method="exhaustive", space=port.DesignSpace(**SMALL), **F64)
    assert best_g.macro.name == best_w.macro.name
    for g, w in zip(all_g, all_w):
        assert g.config.as_tuple() == w.config.as_tuple()
        assert g.metrics["energy_pj"] == pytest.approx(
            w.metrics["energy_pj"], rel=1e-12)


def test_pareto_frontier_matches_reference():
    with enable_x64(True):
        want = ref.pareto_explore(
            ref.get_macro("vanilla-dcim"), ref.bert_large_workload(), 5.0,
            space=ref.DesignSpace(**SMALL), engine=_ref_engine())
    got = port.pareto_explore(
        port.get_macro("vanilla-dcim"), port.bert_large_workload(), 5.0,
        space=port.DesignSpace(**SMALL), **F64)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g["config"].as_tuple() == w["config"].as_tuple()
        assert g["gops"] == pytest.approx(w["gops"], rel=1e-12)
        assert g["tops_w"] == pytest.approx(w["tops_w"], rel=1e-12)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("sset", ["st", "so"])
def test_evaluate_config_matches_reference(sset, dtype, rtol):
    cfg = (2, 4, 1, 16, 16)
    with enable_x64(dtype == torch.float64):
        want = ref.evaluate_config(ref.get_macro("tpdcim-macro"),
                                   ref.AcceleratorConfig(*cfg),
                                   ref.bert_large_workload(),
                                   strategy_set=sset)
    got = port.evaluate_config(port.get_macro("tpdcim-macro"),
                               port.AcceleratorConfig(*cfg),
                               port.bert_large_workload(), strategy_set=sset,
                               device="cpu", dtype=dtype)
    assert got["per_op_strategy"] == want["per_op_strategy"]
    for k in ("latency_cycles", "energy_pj", "tops_w", "gops", "area_mm2"):
        assert got[k] == pytest.approx(want[k], rel=rtol), k


@pytest.mark.parametrize("objective", ["ee", "th"])
def test_sa_within_one_percent_of_exhaustive(objective):
    kw = dict(macro=port.get_macro("tpdcim-macro"),
              workload=port.bert_large_workload(), area_budget_mm2=2.23,
              objective=objective, space=port.DesignSpace(**SMALL),
              device="cpu", engine=port.ExplorationEngine(device="cpu"))
    ex = port.co_explore(method="exhaustive", **kw)
    sa = port.co_explore(method="sa", sa_settings=port.SASettings(
        n_chains=24, n_steps=120, seed=1), **kw)
    metric = "energy_pj" if objective == "ee" else "latency_cycles"
    assert sa.metrics[metric] <= ex.metrics[metric] * 1.01
    assert sa.metrics["area_mm2"] <= 2.23 * 1.001
    assert sa.search["method"] == "sa"
    trace = sa.sa.trace_best.numpy()
    assert trace.shape == (120,) and np.all(np.diff(trace) <= 0)


def test_sa_batch_equals_single_job_runs():
    """A job's SA walk does not depend on the batch it runs in."""
    settings = port.SASettings(n_chains=8, n_steps=30, seed=2)
    jobs = [_port_job(j) for j in _ref_jobs("bert-large")[:2]]
    engine = port.ExplorationEngine(**F64)
    batched = engine.run(jobs, method="sa", settings=settings)
    for job, b in zip(jobs, batched):
        s = engine.run([job], method="sa", settings=settings)[0]
        assert b.config.as_tuple() == s.config.as_tuple()
        assert b.metrics["energy_pj"] == s.metrics["energy_pj"]


def test_in_run_dedup_evaluates_once():
    jobs = [_port_job(j) for j in _ref_jobs("bert-large")[:2]]
    engine = port.ExplorationEngine(**F64)
    out = engine.run([jobs[0], jobs[1], jobs[0]], method="exhaustive")
    assert engine.stats["dedup_hits"] == 1
    assert engine.stats["jobs"] == 3
    assert out[2] is not out[0]
    assert out[2].config == out[0].config
    assert out[2].metrics == out[0].metrics
    out[2].metrics["tops_w"] = -1.0                  # no aliasing
    assert out[0].metrics["tops_w"] > 0


def test_job_key_never_shares_a_reference_record():
    ref_job = _ref_jobs("bert-large")[0]
    job = _port_job(ref_job)
    k32 = job_key(job, "exhaustive")
    assert k32 != job_key(job, "exhaustive", dtype=torch.float64)
    assert k32 != ref.job_key(ref_job, "exhaustive")
    assert k32 == job_key(job, "exhaustive", dtype=torch.float32)
