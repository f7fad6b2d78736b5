"""The port's single-job search API held against the reference's:
``exhaustive_search`` over the same pruned candidates picks the same
config, with the value exact in fp64 and within rtol 1e-5 in fp32, under
both of the port's objectives (``cost_model.make_objective_fn`` and the
kernel wrapper's ``ops.objective_fn``); ``simulated_annealing`` lands
within 1 % of the exhaustive optimum on tests/test_distributed_dse.py's
small space."""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core as ref  # noqa: E402
from repro.compat import enable_x64  # noqa: E402
from repro.core import cost_model as ref_cm  # noqa: E402
from repro.core import pruning as ref_pruning  # noqa: E402

import repro_torch.core as port  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cost_model  # noqa: E402
from repro_torch.core.annealing import SAResult, make_chain_keys  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SMALL = dict(mr=(1, 2, 3), mc=(1, 2), scr=(1, 4, 16), is_kb=(2, 16, 128),
             os_kb=(2, 16, 64))
#: (macro, budget, objective): the distributed tests' job and a latency one
JOBS = [("tpdcim-macro", 2.23, "ee"), ("vanilla-dcim", 5.0, "th")]


def _ref_setup(macro_name, budget, objective):
    macro = ref.get_macro(macro_name)
    ops_arr = ref.bert_large_workload().merged().as_arrays()
    cands, _ = ref.prune_space(ref.DesignSpace(**SMALL), macro, budget)
    rows = ref_pruning.candidates_with_bw(cands, 256)
    fn = ref_cm.make_objective_fn(ops_arr, macro, None, objective, "st",
                                  area_budget_mm2=budget)
    return macro, ops_arr, rows, fn


def _port_objective(kind, macro, ops_arr, budget, objective, dtype):
    if kind == "cost_model":
        return cost_model.make_objective_fn(
            ops_arr, macro, None, objective, "st", area_budget_mm2=budget)
    job = cost_model.stack_job_params(
        [cost_model.job_params_np(ops_arr, macro, None, objective, "st",
                                  budget, 256)], dtype, "cpu")
    return ops.objective_fn(job)


@pytest.mark.parametrize("kind", ["cost_model", "kernel"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 0.0),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("job", JOBS, ids=lambda j: f"{j[0]}-{j[2]}")
def test_exhaustive_search_equals_reference(job, dtype, rtol, kind):
    macro_name, budget, objective = job
    with enable_x64(dtype == torch.float64):
        rmacro, ops_arr, rows, rfn = _ref_setup(*job)
        want_cfg, want_val = ref.exhaustive_search(rfn, rows, batch=64)
    fn = _port_objective(kind, convert.macro_spec(rmacro), ops_arr, budget,
                         objective, dtype)
    got_cfg, got_val = port.exhaustive_search(fn, rows, batch=64,
                                              device="cpu", dtype=dtype)
    np.testing.assert_array_equal(got_cfg, want_cfg)
    if rtol == 0.0:
        assert got_val == want_val
    else:
        np.testing.assert_allclose(got_val, want_val, rtol=rtol)


@pytest.mark.parametrize("kind", ["cost_model", "kernel"])
@pytest.mark.parametrize("job", JOBS, ids=lambda j: f"{j[0]}-{j[2]}")
def test_simulated_annealing_within_one_percent(job, kind):
    macro_name, budget, objective = job
    macro = port.get_macro(macro_name)
    ops_arr = port.bert_large_workload().merged().as_arrays()
    fn = _port_objective(kind, macro, ops_arr, budget, objective,
                         torch.float32)
    space = port.DesignSpace(**SMALL)
    settings = port.SASettings(n_chains=16, n_steps=120, seed=0)
    res = port.simulated_annealing(fn, space, 256, settings, device="cpu")
    assert isinstance(res, SAResult)
    assert res.best_cfg.shape == (6,) and float(res.best_cfg[5]) == 256
    assert res.best_per_chain.shape == (16,)
    assert res.trace_best.shape == (120,)
    assert float(res.best_value) == float(res.best_per_chain.min())
    assert float(res.trace_best[-1]) == float(res.best_value)
    assert bool((res.trace_best[1:] <= res.trace_best[:-1]).all())
    # the winner's config scores its best value
    assert float(fn(res.best_cfg)) == float(res.best_value)
    cands, _ = port.prune_space(space, macro, budget)
    rows = np.concatenate([cands, np.full((len(cands), 1), 256)], 1)
    _, opt = port.exhaustive_search(fn, rows.astype(np.float64),
                                    device="cpu")
    assert float(res.best_value) <= opt * 1.01


def test_seed_and_key_replay():
    fn = cost_model.make_objective_fn(
        port.bert_large_workload().merged().as_arrays(),
        port.get_macro("tpdcim-macro"), area_budget_mm2=2.23)
    space = port.DesignSpace(**SMALL)
    s = port.SASettings(n_chains=8, n_steps=30, seed=3)
    a = port.simulated_annealing(fn, space, 256, s, device="cpu")
    b = port.simulated_annealing(fn, space, 256,
                                 port.SASettings(n_chains=8, n_steps=30),
                                 key=3, device="cpu")
    assert torch.equal(a.best_per_chain, b.best_per_chain)
    assert torch.equal(a.trace_best, b.trace_best)
    np.testing.assert_array_equal(make_chain_keys(s), 3 + np.arange(8))
    np.testing.assert_array_equal(make_chain_keys(s, key=10),
                                  10 + np.arange(8))


def test_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    fn = cost_model.make_objective_fn(
        port.bert_large_workload().merged().as_arrays(),
        port.get_macro("tpdcim-macro"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port.simulated_annealing(fn, port.DesignSpace(**SMALL), 256)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port.exhaustive_search(fn, np.ones((4, 6)))
