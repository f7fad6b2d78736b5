"""The port's search backends (``repro_torch.search``) held against the
reference on the small space of tests/test_search.py: the registry and
the budget algebra equal the reference's, the scrambled Sobol points are
bit for bit the reference's given the reference's 30-bit shift, every
backend reaches within 1 % (Sobol 10 %) of the exhaustive optimum in fp32
and fp64, GA and DE follow the reference's generation step exactly (a
numpy replay of the reference's algorithm on the same draws), a job's
answer does not depend on the batch it runs in, and each run makes the
evaluator calls its settings imply."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core as ref  # noqa: E402
import repro.search as ref_search  # noqa: E402
from repro.compat import enable_x64  # noqa: E402
from repro.search import sobol as ref_sobol  # noqa: E402

import repro_torch.core as port  # noqa: E402
import repro_torch.search as search  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.search import evolution, genetic, sobol  # noqa: E402

SMALL = dict(mr=(1, 2, 3), mc=(1, 2), scr=(1, 4, 16), is_kb=(2, 16, 128),
             os_kb=(2, 16, 64))

#: tests/test_search.py's per-backend settings for the 162-point space
PARITY_SETTINGS = {
    "sa": search.SASettings(n_chains=24, n_steps=120, seed=1),
    "genetic": search.GASettings(pop=24, generations=40, seed=1),
    "evolution": search.DESettings(pop=16, generations=50, seed=1),
    "sobol": search.SobolSettings(n_points=1024, seed=1),
    "portfolio": search.PortfolioSettings(total_evals=3000, seed=1),
}
METHODS = tuple(PARITY_SETTINGS)


def _kw(objective="ee", **extra):
    return dict(macro=port.get_macro("tpdcim-macro"),
                workload=port.bert_large_workload(), area_budget_mm2=2.23,
                objective=objective, space=port.DesignSpace(**SMALL),
                device="cpu", **extra)


def _job(budget=2.23, objective="ee"):
    return port.ExploreJob(port.get_macro("tpdcim-macro"),
                           port.bert_large_workload(), budget,
                           objective=objective,
                           space=port.DesignSpace(**SMALL))


# ------------------------------------------------------------------ #
# registry and settings algebra
# ------------------------------------------------------------------ #
def test_registry_and_methods_equal_the_reference():
    assert search.available_backends() == ref_search.available_backends()
    assert port.valid_methods() == ref.valid_methods()
    with pytest.raises(ValueError, match="unknown search backend"):
        port.ExplorationEngine(device="cpu").run([_job()], method="nope")


@pytest.mark.parametrize("method", ["sa", "genetic", "evolution", "sobol",
                                    "portfolio"])
def test_budget_algebra_equals_the_reference(method):
    b, rb = search.get_backend(method), ref_search.get_backend(method)
    assert b.composite == rb.composite
    assert b.seed_free_run == rb.seed_free_run
    s, rs = b.default_settings(), rb.default_settings()
    assert dataclasses.asdict(s) == dataclasses.asdict(rs)
    assert b.budget(s) == rb.budget(rs)
    for n in (1, 7, 64, 187, 1600, 12800, 25600):
        assert dataclasses.asdict(b.with_budget(s, n)) == \
            dataclasses.asdict(rb.with_budget(rs, n)), n
    assert dataclasses.asdict(b.reseed(s, 12345)) == \
        dataclasses.asdict(rb.reseed(rs, 12345))


def test_settings_class_must_match_the_method():
    with pytest.raises(TypeError, match="GASettings"):
        port.co_explore(method="genetic", settings=search.SASettings(),
                        **_kw())


# ------------------------------------------------------------------ #
# Sobol: exact against the reference
# ------------------------------------------------------------------ #
def test_sobol_direction_numbers_equal_the_reference():
    np.testing.assert_array_equal(sobol._DIRECTIONS, ref_sobol._DIRECTIONS)
    assert sobol._DIRECTIONS.dtype == ref_sobol._DIRECTIONS.dtype


@pytest.mark.parametrize("n", [1, 48, 1000, 1600])
@pytest.mark.parametrize("seed", [0, 7, 104_729])
def test_sobol_points_bit_equal_given_the_reference_shift(n, seed):
    key = jax.random.PRNGKey(seed)
    shift = np.asarray(jax.random.bits(key, (5,), jnp.uint32)
                       & jnp.uint32(2 ** 30 - 1)).astype(np.int64)
    got = sobol.scrambled_sobol(n, torch.as_tensor(shift)[None])[0]
    want = np.asarray(ref_sobol._scrambled_sobol(n, key))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    lens = np.array([3, 2, 5, 7, 4])
    got_idx = sobol.sobol_index_population(
        n, torch.as_tensor(lens)[None], torch.as_tensor(shift)[None])[0]
    want_idx = np.asarray(ref_sobol.sobol_index_population(
        n, jnp.asarray(lens, jnp.int32), key))
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)


def test_sobol_population_is_stratified():
    """The init-population provider covers the 162-point grid almost
    completely, for per-job shifts drawn from the jobs' generators."""
    gens = search.get_backend("sobol").make_generators(
        search.SobolSettings(), "cpu", seeds=[0, 1, 2])
    shift = torch.stack([sobol.draw_shift(g, "cpu") for g in gens])
    lens = torch.tensor([[3, 2, 3, 3, 3]] * 3)
    idx = sobol.sobol_index_population(1024, lens, shift).numpy()
    assert idx.min() >= 0
    assert (idx.max(axis=(0, 1)) <= np.array([2, 1, 2, 2, 2])).all()
    for j in range(3):
        assert len({tuple(r) for r in idx[j]}) >= 0.95 * 162
    assert not np.array_equal(idx[0], idx[1]), "shifts must differ"


# ------------------------------------------------------------------ #
# every backend reaches the exhaustive optimum
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("objective", ["ee", "th"])
def test_exhaustive_winner_equals_the_reference(objective):
    with enable_x64(True):
        want = ref.co_explore(
            ref.get_macro("tpdcim-macro"), ref.bert_large_workload(), 2.23,
            objective=objective, method="exhaustive",
            space=ref.DesignSpace(**SMALL),
            engine=ref.ExplorationEngine(persistent_compile_cache=False))
    got = port.co_explore(method="exhaustive", dtype=torch.float64,
                          **_kw(objective))
    assert got.config.as_tuple() == want.config.as_tuple()
    assert got.per_op_strategy == want.per_op_strategy


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", METHODS)
def test_backend_matches_exhaustive_on_small_space(method, dtype):
    # on an engine, not the service: a store or dedup answer has no
    # ``.sa`` diagnostics, and this test reads them
    engine = port.ExplorationEngine(device="cpu", dtype=dtype)
    ex = port.co_explore(method="exhaustive", engine=engine, **_kw())
    got = port.co_explore(method=method, settings=PARITY_SETTINGS[method],
                          engine=engine, **_kw())
    # adaptive backends within 1 % of the exhaustive optimum; the
    # non-adaptive Sobol baseline within 10 % (tests/test_search.py)
    tol = 1.10 if method == "sobol" else 1.01
    assert got.metrics["energy_pj"] <= ex.metrics["energy_pj"] * tol
    assert got.metrics["area_mm2"] <= 2.23 * 1.001
    assert got.search["method"] == method
    assert got.search["dtype"] == str(dtype)
    # the reported best is the min of the member bests and of the trace
    best = float(got.sa.best_value)
    assert float(got.sa.best_per_chain.min()) == best
    trace = got.sa.trace_best.numpy()
    assert np.all(np.diff(trace) <= 0) and float(trace.min()) == best


@pytest.mark.parametrize("method", METHODS)
def test_co_explore_defaults_run_every_method(method):
    """Each method with its default settings, through co_explore."""
    r = port.co_explore(method=method, **_kw())
    assert r.search["method"] == method
    assert r.metrics["area_mm2"] <= 2.23 * 1.001


# ------------------------------------------------------------------ #
# batch independence and evaluator calls
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("method", ["sa", "genetic", "evolution", "sobol"])
def test_job_alone_equals_job_in_a_batch(method):
    settings = PARITY_SETTINGS[method]
    jobs = [_job(2.23, "ee"), _job(2.5, "th")]
    engine = port.ExplorationEngine(device="cpu", dtype=torch.float64)
    batched = engine.run(jobs, method=method, settings=settings)
    for job, b in zip(jobs, batched):
        s = engine.run([job], method=method, settings=settings)[0]
        assert b.config.as_tuple() == s.config.as_tuple()
        assert torch.equal(b.sa.best_per_chain, s.sa.best_per_chain)
        assert torch.equal(b.sa.trace_best, s.sa.trace_best)


def expected_calls(method: str, settings) -> int:
    """Evaluator calls of one run: one per step or generation plus the
    initial population (the finishing launch is the engine's)."""
    if method == "sa":
        return settings.n_steps + 1
    if method == "sobol":
        return 1
    return settings.generations + 1


@pytest.mark.parametrize("method", ["sa", "genetic", "evolution", "sobol"])
def test_evaluator_calls_follow_the_settings(method):
    calls = []

    def counting(job, cand, penalty_scale=1e3, *, totals=False):
        calls.append((tuple(cand.shape[:2]), totals))
        return kref.job_objective_ref(job, cand, penalty_scale,
                                      totals=totals)

    settings = PARITY_SETTINGS[method]
    engine = port.ExplorationEngine(device="cpu", evaluator=counting)
    engine.run([_job(), _job(2.5)], method=method, settings=settings)
    search_calls = [c for c in calls if not c[1]]
    assert len(search_calls) == expected_calls(method, settings)
    members = {"sa": "n_chains", "sobol": "n_points"}.get(method, "pop")
    assert {c[0] for c in search_calls} == {
        (2, getattr(settings, members))}
    assert [c for c in calls if c[1]] == [((2, 1), True)]


# ------------------------------------------------------------------ #
# GA / DE: the reference's generation step, replayed in numpy
# ------------------------------------------------------------------ #
def _synthetic_objective(lens):
    """A fitness over index rows with many ties at 1e30 and between
    finite values, so every tie-break rule is exercised."""
    w = np.array([7.0, 3.0, 5.0, 2.0, 11.0])

    def f(idx):                                      # [J, M, 5] -> [J, M]
        s = (idx.astype(np.float64) * w).sum(-1)
        return np.where(idx[..., 0] == 0, 1e30, np.floor(s / 3.0))
    return f


def _capture_draws(monkeypatch, module):
    captured = {}
    real = module.draw_per_job

    def capture(generators, draw):
        captured["draws"] = real(generators, draw)
        return captured["draws"]
    monkeypatch.setattr(module, "draw_per_job", capture)
    return captured


def _run_backend(name, settings, lens, f):
    J = lens.shape[0]
    mat = torch.arange(8, dtype=torch.float64).repeat(J, 5, 1)
    backend = search.get_backend(name)

    def objective(cfg):
        return torch.as_tensor(f(cfg[..., :5].long().numpy()))
    return backend.run(objective, mat, torch.as_tensor(lens),
                       torch.zeros(J, dtype=torch.float64), settings,
                       backend.make_generators(settings, "cpu",
                                               seeds=list(range(J))))


def test_genetic_follows_the_reference_step(monkeypatch):
    settings = search.GASettings(pop=12, generations=9, elite=3, seed=0)
    lens = np.array([[3, 2, 5, 4, 6], [6, 5, 4, 3, 2]])
    f = _synthetic_objective(lens)
    cap = _capture_draws(monkeypatch, genetic)
    pop_g, fit_g, trace_g = _run_backend("genetic", settings, lens, f)
    shift, tsel, do_cx, take_b, mutate, redraw = (
        x.numpy() for x in cap["draws"])
    n, elite = settings.pop, settings.elite
    for j in range(len(lens)):
        pop = sobol.sobol_index_population(
            n, torch.as_tensor(lens[j:j + 1]),
            torch.as_tensor(shift[j:j + 1]))[0].numpy()
        fit = f(pop[None])[0]
        w0 = int(np.argmin(fit))
        best_idx, best_val = pop[w0], fit[w0]
        trace = []
        for t in range(settings.generations):
            ts = tsel[j, t]
            winners = ts[np.arange(2 * n), np.argmin(fit[ts], axis=1)]
            pa, pb = pop[winners[:n]], pop[winners[n:]]
            child = np.where(do_cx[j, t] & take_b[j, t], pb, pa)
            child = np.where(mutate[j, t], redraw[j, t] % lens[j], child)
            order = np.argsort(fit, kind="stable")
            child[:elite] = pop[order[:elite]]
            pop, fit = child, f(child[None])[0]
            w = int(np.argmin(fit))
            if fit[w] < best_val:
                best_idx, best_val = pop[w], fit[w]
            trace.append(best_val)
        pop[0], fit[0] = best_idx, best_val
        np.testing.assert_array_equal(pop_g[j].numpy(), pop)
        np.testing.assert_array_equal(fit_g[j].numpy(), fit)
        np.testing.assert_array_equal(trace_g[j].numpy(), trace)


def test_evolution_follows_the_reference_step(monkeypatch):
    settings = search.DESettings(pop=10, generations=12, f=0.5, seed=0)
    lens = np.array([[3, 2, 5, 4, 6], [6, 5, 4, 3, 2]])
    f = _synthetic_objective(lens)
    cap = _capture_draws(monkeypatch, evolution)
    pop_g, fit_g, trace_g = _run_backend("evolution", settings, lens, f)
    shift, r, cross, j_rand = (x.numpy() for x in cap["draws"])
    for j in range(len(lens)):
        pop = sobol.sobol_index_population(
            settings.pop, torch.as_tensor(lens[j:j + 1]),
            torch.as_tensor(shift[j:j + 1]))[0].numpy()
        fit = f(pop[None])[0]
        trace = []
        for t in range(settings.generations):
            rr = r[j, t]
            mutant = pop[rr[:, 0]].astype(np.float32) + np.float32(
                settings.f) * (pop[rr[:, 1]] - pop[rr[:, 2]]).astype(
                    np.float32)
            mutant = np.clip(np.round(mutant), 0,
                             (lens[j] - 1).astype(np.float32)).astype(
                                 np.int64)
            c = cross[j, t] | (np.arange(5)[None] == j_rand[j, t][:, None])
            trial = np.where(c, mutant, pop)
            trial_fit = f(trial[None])[0]
            keep = trial_fit <= fit
            pop = np.where(keep[:, None], trial, pop)
            fit = np.where(keep, trial_fit, fit)
            trace.append(fit.min())
        np.testing.assert_array_equal(pop_g[j].numpy(), pop)
        np.testing.assert_array_equal(fit_g[j].numpy(), fit)
        np.testing.assert_array_equal(trace_g[j].numpy(), trace)


def test_evolution_rounds_half_to_even():
    """A mutant exactly half-way between two indices goes to the even one
    (``jnp.round``), in float32 whatever the engine's dtype."""
    x = torch.tensor([0.5, 1.5, 2.5, 3.5], dtype=torch.float32)
    np.testing.assert_array_equal(torch.round(x).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))
