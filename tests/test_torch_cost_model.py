"""Port cost model held against the reference on random draws.

fp64: integer-valued fields exact, energy at rtol 1e-12.  fp32: rtol 1e-5
(the reference's own bar for its kernel, tests/test_kernels.py)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.compat import enable_x64  # noqa: E402
from repro.core import cost_model as ref_cm  # noqa: E402
from repro.core import ir as ref_ir  # noqa: E402
from repro.core import macro as ref_macro  # noqa: E402
from repro.core import pruning as ref_pruning  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import cost_model, macro  # noqa: E402

INTEGER_FIELDS = [f for f in ref_cm.CostBreakdown._fields
                  if f not in ("energy_pj", "feasible")]
N_DRAWS = 4000
SMALL = dict(mr=(1, 2, 3), mc=(1, 2), scr=(1, 4, 16), is_kb=(2, 16, 128),
             os_kb=(2, 16, 64))


def _draws(seed: int):
    """(op dims, strategy bits, config, area) columns from a seeded rng."""
    rng = np.random.default_rng(seed)
    dims = [rng.choice([1, 7, 64, 100, 512, 1024, 1500, 4096, 11008, 65024],
                       N_DRAWS).astype(np.float64) for _ in range(3)]
    bits = cost_model.STRAT_BITS[rng.integers(0, 8, N_DRAWS)]
    cfg = [rng.choice(axis, N_DRAWS).astype(np.float64) for axis in (
        ref_pruning.MR_CHOICES, ref_pruning.MC_CHOICES,
        ref_pruning.SCR_CHOICES, ref_pruning.IS_KB_CHOICES,
        ref_pruning.OS_KB_CHOICES, (64, 256, 1024))]
    area = rng.uniform(0.5, 20.0, N_DRAWS)
    return dims, [bits[:, i] for i in range(3)], cfg, area


@pytest.mark.parametrize("mname", ["vanilla-dcim", "lcc-cim", "acim-2b-dac",
                                   "trancim-macro"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_matmul_cost_breakdown_matches(mname, dtype):
    dims, bits, cfg, area = _draws(seed=len(mname))
    args = [*dims, *bits, *cfg, area]
    x64 = dtype == "float64"
    with enable_x64(x64):
        want = ref_cm.matmul_cost(*[jnp.asarray(a) for a in args],
                                  ref_macro.MACRO_LIBRARY[mname])
        want = {f: np.asarray(getattr(want, f)) for f in want._fields}
    tdt = getattr(torch, dtype)
    got = cost_model.matmul_cost(
        *[torch.as_tensor(a, dtype=tdt) for a in args],
        macro.MACRO_LIBRARY[mname])
    np.testing.assert_array_equal(got.feasible.numpy(), want["feasible"])
    assert want["feasible"].any() and not want["feasible"].all()
    for f in INTEGER_FIELDS + ["energy_pj"]:
        g = getattr(got, f).numpy()
        assert g.dtype == want[f].dtype, f
        if x64 and f != "energy_pj":
            np.testing.assert_array_equal(g, want[f], err_msg=f)
        else:
            np.testing.assert_allclose(g, want[f], rtol=1e-12 if x64 else 1e-5,
                                       err_msg=f)


def _ref_jobs(ops_pad: int = 8):
    """Stacked reference JobParams (numpy leaves) of 6 varied jobs."""
    from repro.configs import get_arch
    specs = [
        (ref_ir.bert_large_workload(), "vanilla-dcim", "ee", "st", 5.0),
        (ref_ir.bert_large_workload(), "tpdcim-macro", "th", "so", 2.23),
        (get_arch("yi-6b").workload(), "lcc-cim", "edp", "st", 3.0),
        (get_arch("yi-6b").workload(), "trancim-macro", "ee", "so", 3.52),
        (get_arch("falcon-mamba-7b").workload(), "acim-2b-dac", "th", "st",
         1.0),
        (get_arch("gemma-7b").workload(), "fpcim", "ee", "st", 8.0),
    ]
    rows = []
    for wl, mname, obj, sset, budget in specs:
        m = ref_macro.MACRO_LIBRARY[mname]
        rows.append(ref_cm.JobParams(
            ops=wl.merged().as_arrays(pad_to=ops_pad),
            macro=ref_cm.MacroParams(
                *[np.float64(v) for v in ref_cm.macro_params(m)]),
            tech=ref_cm.TechParams(
                *[np.float64(v) for v in ref_cm.tech_params()]),
            allowed=np.asarray(ref_cm.strategy_mask(sset), np.float64),
            obj_code=np.int32(ref_cm.OBJ_CODES[obj]),
            area_budget=np.float64(budget),
            bw=np.float64(256)))
    return jax.tree.map(lambda *xs: np.stack(xs), *rows)


def _raw_candidates(n_jobs: int) -> np.ndarray:
    cands = ref_pruning.candidates_with_bw(ref_pruning.enumerate_space(
        ref_pruning.DesignSpace(**SMALL)), 256)
    return np.repeat(cands[None], n_jobs, axis=0)          # [J, C, 6]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_job_objective_grid_matches_vmapped_reference(dtype):
    jobs = _ref_jobs()
    cands = _raw_candidates(len(jobs.bw))
    with enable_x64(dtype == "float64"):
        fn = jax.vmap(lambda job, block: jax.vmap(
            lambda row: ref_cm.job_objective(job, row))(block))
        want = np.asarray(fn(jax.tree.map(jnp.asarray, jobs),
                             jnp.asarray(cands)))
    tdt = getattr(torch, dtype)
    got = cost_model.job_objective(convert.job_params(jobs, tdt),
                                   torch.as_tensor(cands, dtype=tdt)).numpy()
    assert got.shape == want.shape == cands.shape[:2]
    # the grid covers bandwidth-infeasible rows and over-budget penalties
    assert (want >= ref_cm.INFEASIBLE).any() and (want < 1e20).any()
    np.testing.assert_allclose(got, want,
                               rtol=1e-12 if dtype == "float64" else 1e-5)


@pytest.mark.parametrize("objective", ["ee", "th", "edp"])
def test_workload_metrics_and_strategies_match(objective):
    wl = ref_ir.bert_large_workload().merged().as_arrays()
    row = np.array([2, 4, 16, 256, 64, 256], np.float64)
    with enable_x64(True):
        want = ref_cm.workload_metrics(
            jnp.asarray(wl), jnp.asarray(row),
            ref_macro.get_macro("vanilla-dcim"), objective=objective)
        tbl = ref_cm.strategy_table(
            jnp.asarray(wl[1]), jnp.asarray(row), 3.0,
            ref_macro.get_macro("vanilla-dcim"))
    got = cost_model.workload_metrics(
        torch.as_tensor(wl, dtype=torch.float64),
        torch.as_tensor(row, dtype=torch.float64),
        macro.get_macro("vanilla-dcim"), objective=objective)
    assert got["strategy_idx"] == want["strategy_idx"]
    for k in ("latency_cycles", "energy_pj", "tops_w", "gops", "area_mm2"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    got_tbl = cost_model.strategy_table(
        torch.as_tensor(wl[1], dtype=torch.float64),
        torch.as_tensor(row, dtype=torch.float64), 3.0,
        macro.get_macro("vanilla-dcim"))
    np.testing.assert_array_equal(got_tbl.latency_cycles.numpy(),
                                  np.asarray(tbl.latency_cycles))


@pytest.mark.parametrize("budget", [None, 2.0])
def test_make_objective_fn_matches_reference(budget):
    wl = ref_ir.bert_large_workload().merged().as_arrays()
    cands = _raw_candidates(1)[0]
    with enable_x64(True):
        fn = ref_cm.make_objective_fn(
            jnp.asarray(wl), ref_macro.get_macro("tpdcim-macro"),
            objective="th", strategy_set="so", area_budget_mm2=budget)
        want = np.asarray(jax.vmap(fn)(jnp.asarray(cands)))
    got = cost_model.make_objective_fn(
        torch.as_tensor(wl, dtype=torch.float64),
        macro.get_macro("tpdcim-macro"), objective="th", strategy_set="so",
        area_budget_mm2=budget)(torch.as_tensor(cands, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
