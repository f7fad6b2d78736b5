"""The port's distributed DSE and device race held against the reference.

The reference's three tests (tests/test_distributed_dse.py) run on meshes
of 1, 2 and 4 CPU slots; the initial population's best equals the
reference's (config, and value at rtol 1e-5); one exchange is held against
a numpy replay of the reference's ``pmin`` / ``psum`` rule, ties included;
a resumed run continues the uninterrupted one exactly and an elastic
resume re-tiles; the port's best is within 1 % of the better of the
reference's and the exhaustive optimum; the engine's portfolio raced over
two slots equals its one-device run bit for bit; and
``repro_torch.core`` exports what ``repro.core`` does."""
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core as ref  # noqa: E402
from repro.compat import make_mesh  # noqa: E402
from repro.core.distributed import distributed_co_explore_jobs as \
    ref_jobs  # noqa: E402

import repro_torch.core as port  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.distributed import (distributed_co_explore_jobs,  # noqa: E402
                                          exchange, race_devices)
from repro_torch.core.macro import TPDCIM_MACRO  # noqa: E402
from repro_torch.search.portfolio import PortfolioSettings  # noqa: E402

SMALL = dict(mr=(1, 2, 3), mc=(1, 2), scr=(1, 4, 16), is_kb=(2, 16, 128),
             os_kb=(2, 16, 64))
SLOTS = [1, 2, 4]


def _mesh(n):
    return ["cpu"] * n


def _bert(**kw):
    return dict(macro=TPDCIM_MACRO, workload=port.bert_large_workload(),
                area_budget_mm2=2.23, space=port.DesignSpace(**SMALL), **kw)


def _monotone(trace):
    return all(b <= a * (1 + 1e-9) for a, b in zip(trace, trace[1:]))


# ---- the reference's three tests, on 1, 2 and 4 slots ---------------- #
@pytest.mark.parametrize("slots", SLOTS)
def test_distributed_runs_and_improves(slots):
    res = port.distributed_co_explore(
        _mesh(slots), **_bert(), settings=port.SASettings(seed=0),
        chains_per_device=8, rounds=4, sync_every=40)
    assert res.best_value < 1e29
    assert _monotone(res.trace) and len(res.trace) == 4
    assert res.config.mr in SMALL["mr"]
    assert res.n_chains == 8 * slots


@pytest.mark.parametrize("slots", SLOTS)
def test_multi_job_population_sharded(slots):
    jobs = [
        port.ExploreJob(TPDCIM_MACRO, port.bert_large_workload(), 2.23,
                        objective="ee", space=port.DesignSpace(**SMALL)),
        port.ExploreJob(port.get_macro("vanilla-dcim"),
                        port.bert_large_workload(), 5.0, objective="th",
                        space=port.DesignSpace(**SMALL)),
    ]
    results = distributed_co_explore_jobs(
        _mesh(slots), jobs, settings=port.SASettings(seed=0),
        chains_per_device=6, rounds=3, sync_every=30)
    assert len(results) == 2
    for res in results:
        assert res.best_value < 1e29
        assert res.n_chains == 6 * slots
        assert res.config.mr in SMALL["mr"]
        assert _monotone(res.trace)
    assert results[0].best_value != results[1].best_value


@pytest.mark.parametrize("slots", SLOTS)
def test_checkpoint_and_elastic_resume(slots, tmp_path):
    d = str(tmp_path)
    r1 = port.distributed_co_explore(
        _mesh(slots), **_bert(), settings=port.SASettings(seed=0),
        chains_per_device=4, rounds=2, sync_every=30, checkpoint_dir=d)
    assert os.path.exists(os.path.join(d, "dse_state.npz"))
    assert not os.path.exists(os.path.join(d, "dse_state.npz.tmp.npz"))
    # resume with a different population size (elastic)
    r2 = port.distributed_co_explore(
        _mesh(slots), **_bert(), settings=port.SASettings(seed=0),
        chains_per_device=8, rounds=4, sync_every=30, checkpoint_dir=d,
        resume=True)
    assert len(r2.trace) == 4 and r2.trace[:2] == r1.trace
    assert r2.best_value <= r1.best_value


# ---- against the reference -------------------------------------------- #
def _ref_job(objective="ee"):
    return ref.ExploreJob(ref.get_macro("tpdcim-macro"),
                          ref.bert_large_workload(), 2.23,
                          objective=objective,
                          space=ref.DesignSpace(**SMALL))


def _port_job(j):
    return port.ExploreJob(
        convert.macro_spec(j.macro), convert.workload(j.workload),
        j.area_budget_mm2, objective=j.objective, bw=j.bw,
        space=convert.design_space(j.space))


@pytest.mark.parametrize("slots", SLOTS)
def test_initial_population_equals_reference(slots):
    """With no rounds each result is its job's best initial chain: the
    same numpy draws give the same population (for one job the reference's
    one device with ``slots x c`` chains lays it out as ``slots`` slots of
    ``c``), scored within rtol 1e-5."""
    for objective in ("ee", "th"):
        job = _ref_job(objective)
        want = ref_jobs(make_mesh((1,), ("data",)), [job],
                        settings=ref.SASettings(seed=7),
                        chains_per_device=6 * slots, rounds=0)[0]
        got = distributed_co_explore_jobs(
            _mesh(slots), [_port_job(job)], settings=port.SASettings(seed=7),
            chains_per_device=6, rounds=0)[0]
        assert got.config.as_tuple() == want.config.as_tuple()
        assert got.n_chains == want.n_chains
        np.testing.assert_allclose(got.best_value, want.best_value,
                                   rtol=1e-5)


@pytest.fixture(scope="module")
def reference_run():
    job = _ref_job()
    res = ref_jobs(make_mesh((1,), ("data",)), [job],
                   settings=ref.SASettings(seed=0), chains_per_device=8,
                   rounds=4, sync_every=40)[0]
    exh = ref.ExplorationEngine(persistent_compile_cache=False).run(
        [job], method="exhaustive")[0]
    pj = _port_job(job)
    opt = port.ExplorationEngine(device="cpu").candidate_values(
        [pj], [np.array([[*exh.config.as_tuple(), 256]], np.float64)])[0][0]
    return res, float(opt)


@pytest.mark.parametrize("slots", SLOTS)
def test_best_within_one_percent_of_reference(slots, reference_run):
    want, opt = reference_run
    got = distributed_co_explore_jobs(
        _mesh(slots), [_port_job(_ref_job())],
        settings=port.SASettings(seed=0), chains_per_device=8, rounds=4,
        sync_every=40)[0]
    assert got.best_value <= max(want.best_value, opt) * 1.01


# ---- the exchange ------------------------------------------------------ #
def _replay_exchange(best_val, best_idx, val):
    """The reference's rule, one slot and one job at a time."""
    D, J, c = best_val.shape
    g_best = np.array([min(best_val[d, j].min() for d in range(D))
                       for j in range(J)])
    g_idx = np.zeros((J, 5), np.int64)
    worst = np.zeros((D, J), np.int64)
    for j in range(J):
        total, n_win = np.zeros(5, np.int64), 0
        for d in range(D):
            local = list(best_val[d, j])
            arg = local.index(min(local))
            if local[arg] <= g_best[j]:
                total += best_idx[d, j, arg]
                n_win += 1
        g_idx[j] = total // max(n_win, 1)
        for d in range(D):
            cur = list(val[d, j])
            worst[d, j] = cur.index(max(cur))
    return g_best, g_idx, worst


def test_exchange_equals_numpy_replay_with_ties():
    rng = np.random.default_rng(0)
    for trial in range(40):
        D, J, c = int(rng.integers(1, 5)), int(rng.integers(1, 4)), \
            int(rng.integers(1, 6))
        # few distinct values, so slots and chains tie often
        best_val = rng.integers(0, 3, (D, J, c)).astype(np.float32)
        val = rng.integers(0, 3, (D, J, c)).astype(np.float32)
        best_idx = rng.integers(0, 9, (D, J, c, 5))
        got = exchange(best_val, best_idx, val)
        want = _replay_exchange(best_val, best_idx, val)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_exchange_tie_takes_the_mean_of_the_winners():
    """Two slots tie at the global best with different configs: the
    re-seeded config is their integer mean, which may be neither (a
    reference quirk the port keeps)."""
    best_val = np.array([[[5.0, 3.0]], [[3.0, 9.0]]], np.float32)
    best_idx = np.zeros((2, 1, 2, 5), np.int64)
    best_idx[0, 0, 1] = [1, 1, 2, 0, 4]
    best_idx[1, 0, 0] = [2, 0, 1, 3, 4]
    val = np.array([[[7.0, 7.0]], [[1.0, 8.0]]], np.float32)
    g_best, g_idx, worst = exchange(best_val, best_idx, val)
    assert g_best.tolist() == [3.0]
    assert g_idx.tolist() == [[1, 0, 1, 1, 4]]
    assert worst.tolist() == [[0], [1]]


# ---- resume ------------------------------------------------------------ #
def _state(d):
    with np.load(os.path.join(d, "dse_state.npz")) as st:
        return {k: st[k] for k in st.files}


@pytest.mark.parametrize("slots", [1, 4])
def test_resume_continues_the_uninterrupted_run(slots, tmp_path):
    jobs = [_port_job(_ref_job("ee")), _port_job(_ref_job("th"))]
    kw = dict(settings=port.SASettings(seed=2), chains_per_device=3,
              sync_every=15)
    full = distributed_co_explore_jobs(
        _mesh(slots), jobs, rounds=6, checkpoint_dir=str(tmp_path / "a"),
        **kw)
    distributed_co_explore_jobs(_mesh(slots), jobs, rounds=3,
                                checkpoint_dir=str(tmp_path / "b"), **kw)
    resumed = distributed_co_explore_jobs(
        _mesh(slots), jobs, rounds=6, checkpoint_dir=str(tmp_path / "b"),
        resume=True, **kw)
    a, b = _state(tmp_path / "a"), _state(tmp_path / "b")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, y in zip(full, resumed):
        assert x.config == y.config and x.best_value == y.best_value
        assert x.trace == y.trace


def test_elastic_resume_and_legacy_checkpoint(tmp_path):
    jobs = [_port_job(_ref_job())]
    kw = dict(settings=port.SASettings(seed=1), chains_per_device=4,
              sync_every=10)
    d = str(tmp_path)
    four = distributed_co_explore_jobs(_mesh(4), jobs, rounds=2,
                                       checkpoint_dir=d, **kw)[0]
    one = distributed_co_explore_jobs(_mesh(1), jobs, rounds=4,
                                      checkpoint_dir=d, resume=True, **kw)[0]
    assert one.trace[:2] == four.trace and len(one.trace) == 4
    assert one.n_chains == 4 and one.best_value <= four.best_value
    # a checkpoint with no job axis and no values (the reference's legacy
    # layout) puts every chain on job 0 and scores it afresh
    st = _state(d)
    np.savez(os.path.join(d, "dse_state.npz"), idx=st["idx"],
             keys=st["keys"], round=st["round"], trace=st["trace"])
    again = distributed_co_explore_jobs(_mesh(2), jobs, rounds=5,
                                        checkpoint_dir=d, resume=True,
                                        **kw)[0]
    assert len(again.trace) == 5 and again.n_chains == 8
    # a reference checkpoint (JAX keys) is refused by name
    np.savez(os.path.join(d, "dse_state.npz"), idx=st["idx"],
             keys=np.zeros((len(st["idx"]), 2), np.uint32),
             job_id=st["job_id"], round=st["round"], trace=st["trace"])
    with pytest.raises(ValueError, match="reference"):
        distributed_co_explore_jobs(_mesh(1), jobs, rounds=5,
                                    checkpoint_dir=d, resume=True, **kw)


def test_launches_per_slot_per_step(monkeypatch):
    """One evaluator call per slot per step, plus one per slot to score
    the initial population."""
    from repro_torch.kernels import ref as kref
    calls = []

    def counting(job, cand, penalty_scale=1e3, **kw):
        calls.append(tuple(cand.shape))
        return kref.job_objective_ref(job, cand, penalty_scale, **kw)

    jobs = [_port_job(_ref_job("ee")), _port_job(_ref_job("th"))]
    distributed_co_explore_jobs(_mesh(4), jobs, chains_per_device=3,
                                rounds=2, sync_every=5, evaluator=counting)
    assert len(calls) == 4 * (1 + 2 * 5)
    assert set(calls) == {(2, 3, 6)}


def test_needs_a_card_unless_given_cpu_slots():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port.distributed_co_explore(None, **_bert(), rounds=1, sync_every=1)
    with pytest.raises(ValueError, match="empty"):
        distributed_co_explore_jobs([], [_port_job(_ref_job())])


# ---- the engine's device race ------------------------------------------ #
def test_race_devices_env(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setenv("CIM_TUNER_RACE_DEVICES", "2, 0")
    assert race_devices() == [torch.device("cuda", 2),
                              torch.device("cuda", 0)]
    monkeypatch.setenv("CIM_TUNER_RACE_DEVICES", "4")
    assert race_devices() == [torch.device("cuda", 1)]
    monkeypatch.setenv("CIM_TUNER_RACE_DEVICES", ",")
    assert len(race_devices()) == 3
    from repro.core.distributed import race_devices as ref_race
    for spec in ("0,x", "a", "1;2"):
        monkeypatch.setenv("CIM_TUNER_RACE_DEVICES", spec)
        with pytest.raises(ValueError) as want:
            ref_race()
        with pytest.raises(ValueError) as got:
            race_devices()
        assert str(got.value) == str(want.value)


def test_portfolio_race_over_two_slots_equals_one_device(monkeypatch):
    job = port.ExploreJob(TPDCIM_MACRO, port.bert_large_workload(), 2.23,
                          space=port.DesignSpace(**SMALL))
    s = PortfolioSettings(total_evals=800, seed=5)
    single = port.ExplorationEngine(device="cpu").run(
        [job], method="portfolio", settings=s)[0]
    monkeypatch.setattr(distributed, "race_devices",
                        lambda: [torch.device("cpu")] * 2)
    engine = port.ExplorationEngine(device="cpu")
    raced = engine.run([job], method="portfolio", settings=s)[0]
    assert single.search["portfolio"]["devices"] == 1
    assert raced.search["portfolio"]["devices"] == 2
    assert engine.stats_snapshot()["device_race_dispatches"] > 0
    assert raced.config == single.config
    assert float(raced.sa.best_value) == float(single.sa.best_value)
    assert raced.search["portfolio"]["pulls"] == \
        single.search["portfolio"]["pulls"]
    pinned = port.ExplorationEngine(device="cpu", device_race=False).run(
        [job], method="portfolio", settings=s)[0]
    assert pinned.search["portfolio"]["devices"] == 1


def test_exports_equal_the_reference():
    assert set(ref.__all__) - set(port.__all__) == {
        "enable_persistent_compilation_cache"}
    assert set(port.__all__) <= set(ref.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name
