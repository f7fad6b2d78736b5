"""The port's DSE service (``repro_torch.service``): streaming order,
dedup, store semantics, the blocking wrappers, and parity with the
reference's service.

The streaming/caching tests drive the port's queue with stub engines (a
counting stub for cache assertions, a blocking stub for order assertions),
as tests/test_service.py does for the reference, so they cannot flake on
timing; the end-to-end tests run the port's engine on the CPU on a small
design space.  The parity tests send the same job specs through the
reference's service and the port's and compare the serialized records:
exact in fp64 against the reference's x64 mode, rtol 1e-5 in fp32.
"""
from __future__ import annotations

import dataclasses
import json
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    DesignSpace,
    ExplorationEngine,
    ExploreJob,
    bert_large_workload,
    co_explore,
    co_explore_macros,
    get_macro,
    job_key,
    pareto_explore,
)
from repro_torch.core.engine import ExploreResult  # noqa: E402
from repro_torch.core.macro import TPDCIM_MACRO  # noqa: E402
from repro_torch.core.template import AcceleratorConfig  # noqa: E402
from repro_torch.service import (  # noqa: E402
    JobQueue,
    QueueConfig,
    ResultStore,
    ServiceClient,
    as_completed,
    deserialize_result,
    job_from_spec,
    serialize_result,
)

SMALL = DesignSpace(mr=(1, 2, 3), mc=(1, 2), scr=(1, 4, 16),
                    is_kb=(2, 16, 128), os_kb=(2, 16, 64))
CPU = dict(device="cpu")


def _job(objective="ee", budget=2.23, wl=None):
    return ExploreJob(TPDCIM_MACRO, wl or bert_large_workload(), budget,
                      objective=objective, space=SMALL)


def _fake_result(job, tag="x") -> ExploreResult:
    return ExploreResult(
        config=AcceleratorConfig(1, 1, 1, 2, 2),
        macro=job.macro, workload=job.workload.name,
        objective=job.objective, strategy_set=job.strategy_set,
        per_op_strategy={"op0": "IS-W-F"},
        metrics={"tops_w": 1.0, "gops": 1.0, "energy_pj": 1.0,
                 "latency_cycles": 1.0, "latency_s": 1.0, "area_mm2": 1.0},
        search={"method": "stub", "tag": tag},
    )


class CountingStubEngine:
    """Engine double: counts run() invocations, optional per-bucket block.

    ``block_buckets``: bucket keys whose dispatch waits on ``release``
    before returning -- lets tests hold the slow bucket open while
    asserting the fast bucket already streamed out."""

    device = torch.device("cpu")
    dtype = torch.float32

    def __init__(self, block_buckets=(), bucket_of=None):
        self.runs = 0
        self.jobs_seen = []
        self.release = threading.Event()
        self.block_buckets = set(block_buckets)
        self.sa_settings = None
        self._bucket_of = bucket_of or (
            lambda job, method: (len(job.merged_workload().ops),))

    def stats_snapshot(self):
        return {}

    def bucket_key(self, job, method="sa"):
        return self._bucket_of(job, method)

    def run(self, jobs, method="sa", settings=None, sa_settings=None,
            keys=None, admit=None):
        if self.bucket_key(jobs[0], method) in self.block_buckets:
            assert self.release.wait(30), "blocked bucket never released"
        self.runs += 1
        self.jobs_seen.extend(jobs)
        return [_fake_result(j, tag=f"run{self.runs}") for j in jobs]

    def candidate_values(self, jobs, candidates):
        self.runs += 1
        return [np.arange(len(c), dtype=float) + 1.0 for c in candidates]


# ------------------------------------------------------------------ #
# streaming order: a multi-bucket submission yields the fast bucket's
# results before the slow bucket completes
# ------------------------------------------------------------------ #
def test_fast_bucket_streams_before_slow_bucket_completes(tmp_path):
    from repro_torch.configs import get_arch
    fast_wl = bert_large_workload()                       # few merged ops
    slow_wl = get_arch("whisper-small").workload(seq=512)  # many ops
    eng = CountingStubEngine()
    slow_bucket = eng.bucket_key(ExploreJob(
        TPDCIM_MACRO, slow_wl, 2.23, space=SMALL), "exhaustive")
    fast_bucket = eng.bucket_key(ExploreJob(
        TPDCIM_MACRO, fast_wl, 2.23, space=SMALL), "exhaustive")
    assert slow_bucket != fast_bucket, "test needs two distinct buckets"
    eng.block_buckets = {slow_bucket}

    q = JobQueue(engine=eng, store=ResultStore(str(tmp_path)),
                 config=QueueConfig(batch_window_s=0.01))
    try:
        f_fast = q.submit(_job(wl=fast_wl), method="exhaustive", priority=1)
        f_slow = q.submit(_job(wl=slow_wl), method="exhaustive")
        first = next(as_completed([f_fast, f_slow], timeout=30))
        assert first is f_fast
        assert not f_slow.done(), \
            "slow bucket finished before fast bucket streamed out"
        eng.release.set()
        assert f_slow.result(timeout=30).workload == slow_wl.name
    finally:
        eng.release.set()
        q.close()
    assert eng.runs == 2, "each bucket must dispatch as its own run()"


# ------------------------------------------------------------------ #
# cache semantics
# ------------------------------------------------------------------ #
def test_warm_store_skips_engine(tmp_path):
    eng = CountingStubEngine()
    store = ResultStore(str(tmp_path))
    with JobQueue(engine=eng, store=store,
                  config=QueueConfig(batch_window_s=0.0)) as q:
        cold = q.submit(_job(), method="exhaustive").result(timeout=30)
    assert eng.runs == 1 and store.stats["puts"] == 1

    eng2 = CountingStubEngine()
    with JobQueue(engine=eng2, store=ResultStore(str(tmp_path))) as q2:
        warm = q2.submit(_job(), method="exhaustive").result(timeout=30)
        assert q2.stats["store_hits"] == 1
    assert eng2.runs == 0, "warm store must serve without engine invocation"
    assert warm.config.as_tuple() == cold.config.as_tuple()
    assert warm.metrics == cold.metrics
    assert warm.search["cache"] == "store"


def test_inflight_dedup_fans_out_single_evaluation(tmp_path):
    eng = CountingStubEngine()
    eng.block_buckets = {eng.bucket_key(_job(), "exhaustive")}
    q = JobQueue(engine=eng, store=ResultStore(str(tmp_path)),
                 config=QueueConfig(batch_window_s=0.01))
    try:
        futs = [q.submit(_job(), method="exhaustive") for _ in range(4)]
        eng.release.set()
        results = [f.result(timeout=30) for f in futs]
    finally:
        eng.release.set()
        q.close()
    assert eng.runs == 1 and len(eng.jobs_seen) == 1
    assert q.stats["inflight_dedup"] == 3
    for a, b in zip(results, results[1:]):
        assert a.config.as_tuple() == b.config.as_tuple()
        assert a.metrics is not b.metrics, "fan-out must not alias dicts"


def test_store_roundtrip_is_exact(tmp_path):
    job = _job()
    r = _fake_result(job)
    r.metrics["tops_w"] = 3.141592653589793116  # full float64 precision
    store = ResultStore(str(tmp_path))
    key = job_key(job, "exhaustive", None)
    store.put(key, r)
    back = store.get(key)
    assert back is not None
    assert back.metrics["tops_w"] == r.metrics["tops_w"]  # bit-for-bit
    assert back.config == r.config
    assert back.macro == r.macro
    assert back.per_op_strategy == r.per_op_strategy


def test_store_tolerates_corrupt_records(tmp_path):
    store = ResultStore(str(tmp_path))
    key = job_key(_job(), "exhaustive", None)
    store.put(key, _fake_result(_job()))
    path = store._path(key)
    with open(path, "w") as f:
        f.write("{not json\n")
    assert store.get(key) is None                # miss, not crash


def test_serialize_roundtrip_standalone():
    r = _fake_result(_job("th"))
    rec = serialize_result(r)
    back = deserialize_result(rec)
    assert back.objective == "th"
    assert back.config == r.config
    assert back.sa is None


def test_serialize_drops_search_tensors_and_converts_values():
    """A real portfolio result carries the port's ``SearchResult`` of
    tensors in ``sa``; the record drops it and holds only JSON values."""
    from repro_torch.search import PortfolioSettings
    r = ExplorationEngine(**CPU).run(
        [_job()], method="portfolio",
        settings=PortfolioSettings(backends=("sa", "sobol"),
                                   total_evals=64, rungs=2))[0]
    assert isinstance(r.sa.best_value, torch.Tensor)
    r.metrics["extra"] = torch.tensor([1.5, 2.0], dtype=torch.float64)
    rec = serialize_result(r)
    assert json.loads(json.dumps(rec)) == rec
    assert rec["metrics"]["extra"] == [1.5, 2.0]
    back = deserialize_result(rec)
    assert back.sa is None and back.config == r.config
    assert back.search["portfolio"] == r.search["portfolio"]


def test_failed_group_rejects_futures(tmp_path):
    class ExplodingEngine(CountingStubEngine):
        def run(self, jobs, method="sa", settings=None, sa_settings=None,
                keys=None):
            raise ValueError("no feasible hardware point under budget")

    with JobQueue(engine=ExplodingEngine(), store=None,
                  config=QueueConfig(batch_window_s=0.0)) as q:
        fut = q.submit(_job(budget=1e-6), method="exhaustive")
        with pytest.raises(ValueError, match="no feasible"):
            fut.result(timeout=30)
        assert fut.exception(timeout=1) is not None


def test_engine_failure_surfaces_job_key_into_every_future():
    """A poisoned engine fails a whole micro-batch bucket; every affected
    future must surface the error tagged with ITS originating job_key."""
    class PoisonedEngine(CountingStubEngine):
        def run(self, jobs, method="sa", settings=None, sa_settings=None,
                keys=None):
            raise RuntimeError("engine poisoned")

    with JobQueue(engine=PoisonedEngine(), store=None,
                  config=QueueConfig(batch_window_s=0.2)) as q:
        f1 = q.submit(_job("ee"), method="exhaustive")
        f2 = q.submit(_job("ee"), method="exhaustive")
        f3 = q.submit(_job("th"), method="exhaustive")
        excs = [f.exception(timeout=30) for f in (f1, f2, f3)]
    for f, exc in zip((f1, f2, f3), excs):
        assert isinstance(exc, RuntimeError)
        assert "engine poisoned" in str(exc)
        assert f.key[:16] in str(exc), "message must carry the job key"
        assert exc.job_key == f.key
        assert exc.__cause__ is not None
    assert excs[0].job_key != excs[2].job_key
    assert q.stats["failed"] >= 1


def test_worker_survives_unbucketable_entry():
    """An entry whose job can't even be bucketed (malformed design space)
    is rejected individually; the worker thread keeps serving."""
    class PickyEngine(CountingStubEngine):
        def bucket_key(self, job, method="sa"):
            if not job.design_space().mr:
                raise IndexError("empty axis")
            return super().bucket_key(job, method)

    bad = ExploreJob(TPDCIM_MACRO, bert_large_workload(), 2.23,
                     space=DesignSpace(mr=()))
    with JobQueue(engine=PickyEngine(), store=None,
                  config=QueueConfig(batch_window_s=0.0)) as q:
        fb = q.submit(bad, method="exhaustive")
        assert fb.exception(timeout=30) is not None
        fg = q.submit(_job(), method="exhaustive")
        assert fg.result(timeout=30).workload == "bert-large"


def test_priority_orders_dispatch():
    eng = CountingStubEngine(
        bucket_of=lambda job, method: (job.objective,))  # bucket per obj
    q = JobQueue(engine=eng, store=None,
                 config=QueueConfig(batch_window_s=0.5))
    try:
        lo = q.submit(_job("ee"), method="exhaustive", priority=0)
        hi = q.submit(_job("th"), method="exhaustive", priority=5)
        first = next(as_completed([lo, hi], timeout=30))
        assert first is hi
    finally:
        q.close()


# ------------------------------------------------------------------ #
# blocking wrappers: the service path equals the direct-engine path
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("entry", ["co_explore", "co_explore_macros"])
def test_co_explore_service_path_matches_engine_path(entry, dtype):
    macro = get_macro("vanilla-dcim")
    wl = bert_large_workload()
    kw = dict(method="exhaustive", space=SMALL, device="cpu", dtype=dtype)
    engine = ExplorationEngine(device="cpu", dtype=dtype)
    if entry == "co_explore":
        via_service = [co_explore(macro, wl, 3.0, objective="ee", **kw)]
        via_engine = [co_explore(macro, wl, 3.0, objective="ee",
                                 engine=engine, **kw)]
    else:
        macros = [macro, get_macro("tpdcim-macro")]
        via_service = co_explore_macros(macros, wl, 3.0, **kw)[1]
        via_engine = co_explore_macros(macros, wl, 3.0, engine=engine,
                                       **kw)[1]
    assert engine.stats["jobs"] == len(via_engine)
    for s, e in zip(via_service, via_engine):
        assert s.config.as_tuple() == e.config.as_tuple()
        assert s.per_op_strategy == e.per_op_strategy
        for key in ("energy_pj", "latency_cycles", "tops_w", "gops"):
            assert s.metrics[key] == e.metrics[key]
        assert s.search["dtype"] == str(dtype)


def test_pareto_explore_service_path_matches_engine_path():
    from repro_torch.service import default_service
    macro = get_macro("vanilla-dcim")
    wl = bert_large_workload()
    svc = default_service("cpu")
    before = svc.stats["submitted"]
    via_service = pareto_explore(macro, wl, 3.0, space=SMALL, **CPU)
    assert svc.stats["submitted"] == before + 2, \
        "pareto must submit its two sweeps to the service"
    via_engine = pareto_explore(macro, wl, 3.0, space=SMALL,
                                engine=ExplorationEngine(**CPU))
    assert [(p["config"], p["gops"], p["tops_w"]) for p in via_service] == \
        [(p["config"], p["gops"], p["tops_w"]) for p in via_engine]


def test_service_end_to_end_two_buckets_real_engine(tmp_path):
    """Real-engine streaming: two shape buckets, every result correct, and
    a resubmission is served entirely from the store."""
    from repro_torch.configs import get_arch
    jobs = [
        _job(wl=bert_large_workload()),
        _job(wl=get_arch("whisper-small").workload(seq=512), budget=5.0),
    ]
    svc = ServiceClient(engine=ExplorationEngine(**CPU),
                        store=ResultStore(str(tmp_path)))
    try:
        futs = svc.submit_many(jobs, method="exhaustive")
        seen = [f.result(timeout=600) for f in futs]
        assert svc.stats["dispatches"] == 2          # one per shape bucket
        reference = ExplorationEngine(**CPU).run(jobs, method="exhaustive")
        for got, ref in zip(seen, reference):
            assert got.config.as_tuple() == ref.config.as_tuple()
            assert got.metrics["energy_pj"] == ref.metrics["energy_pj"]

        d0 = svc.stats["dispatches"]
        warm = svc.explore(jobs, method="exhaustive")
        assert svc.stats["dispatches"] == d0, "warm path must skip engine"
        assert svc.stats["store_hits"] == 2
        for got, ref in zip(warm, reference):
            assert got.config.as_tuple() == ref.config.as_tuple()
            assert got.metrics["energy_pj"] == ref.metrics["energy_pj"]
    finally:
        svc.close()


def test_cli_job_spec_parsing():
    job, method = job_from_spec({
        "macro": "tpdcim-macro", "workload": "bert-large",
        "area_budget_mm2": 2.23, "objective": "th",
        "method": "exhaustive",
        "space": {"mr": [1, 2], "mc": [1, 2], "scr": [1, 4],
                  "is_kb": [16], "os_kb": [16]},
    })
    assert method == "exhaustive"
    assert job.macro.name == "tpdcim-macro"
    assert job.objective == "th"
    assert job.design_space().mr == (1, 2)
    inline, _ = job_from_spec({
        "macro": "vanilla-dcim", "area_budget_mm2": 1.0,
        "workload": {"name": "tiny", "ops": [[64, 64, 64, 2]]}})
    assert inline.workload.ops[0].count == 2


# ------------------------------------------------------------------ #
# no hidden fallback: the service's entry points default to the card
# ------------------------------------------------------------------ #
def test_service_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default is usable")
    from repro_torch.service import default_service
    from repro_torch.service.server import DSEServer
    for build in (lambda: JobQueue(), lambda: ServiceClient(),
                  lambda: default_service(), lambda: DSEServer(),
                  lambda: co_explore(get_macro("vanilla-dcim"),
                                     bert_large_workload(), 3.0,
                                     method="exhaustive", space=SMALL)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build()


# ------------------------------------------------------------------ #
# parity with the reference's service
# ------------------------------------------------------------------ #
#: the small space of the parity runs
PARITY_SPACE = {"mr": [1, 2], "mc": [1, 2], "scr": [1, 4],
                "is_kb": [16, 128], "os_kb": [16, 64]}
PARITY_SPECS = [
    {"macro": "vanilla-dcim", "workload": "bert-large",
     "area_budget_mm2": 5.0, "objective": obj, "strategy_set": sset,
     "search": "exhaustive", "space": PARITY_SPACE}
    for sset in ("st", "so") for obj in ("ee", "th")
] + [{"macro": "tpdcim-macro", "workload": {"name": "whisper-small",
                                            "seq": 512},
      "area_budget_mm2": 2.23, "objective": "ee", "search": "exhaustive",
      "space": PARITY_SPACE}]


@pytest.fixture
def ref_x64():
    """The reference's x64 mode for every thread (its queue's worker
    runs outside the caller's thread-local ``enable_x64`` context)."""
    import jax
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _run_both(tmp_path, dtype):
    import repro.core as ref_core
    import repro.service as ref_service
    ref_svc = ref_service.ServiceClient(
        engine=ref_core.ExplorationEngine(persistent_compile_cache=False),
        store=ref_service.ResultStore(str(tmp_path / "ref")))
    port_svc = ServiceClient(
        store=ResultStore(str(tmp_path / "port")), device="cpu",
        dtype=dtype)
    try:
        want = [ref_service.serialize_result(r)
                for r in ref_svc.explore_specs(PARITY_SPECS, timeout=600)]
        got = [serialize_result(r)
               for r in port_svc.explore_specs(PARITY_SPECS, timeout=600)]
    finally:
        ref_svc.close()
        port_svc.close()
    return got, want


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["fp64", "fp32"])
def test_records_equal_the_reference(tmp_path, request, dtype):
    if dtype == torch.float64:
        request.getfixturevalue("ref_x64")
    got, want = _run_both(tmp_path, dtype)
    assert len(got) == len(want) == len(PARITY_SPECS)
    for g, w in zip(got, want):
        assert set(g) == set(w), "records must carry the same fields"
        assert g["config"] == w["config"]
        assert g["per_op_strategy"] == w["per_op_strategy"]
        assert g["macro"] == w["macro"]
        assert (g["workload"], g["objective"], g["strategy_set"]) == \
            (w["workload"], w["objective"], w["strategy_set"])
        assert set(g["metrics"]) == set(w["metrics"])
        for k, v in w["metrics"].items():
            if dtype == torch.float64:
                assert g["metrics"][k] == v, k
            else:
                assert g["metrics"][k] == pytest.approx(v, rel=1e-5), k
        for k in ("raw", "kept", "bandwidth_pruned", "area_pruned"):
            assert g["search"][k] == w["search"][k]


#: the job records of the reference CLI's docstring
#: (src/repro/service/__main__.py), plus its structured "search" form
DOC_SPECS = [
    {"macro": "vanilla-dcim", "workload": "bert-large",
     "area_budget_mm2": 5.0, "objective": "ee", "search": "exhaustive"},
    {"macro": "tpdcim-macro", "workload": {"name": "yi-6b", "seq": 512},
     "area_budget_mm2": 2.23, "objective": "th", "search": "portfolio"},
    {"macro": "tpdcim-macro", "workload": {"name": "yi-6b", "seq": 512},
     "area_budget_mm2": 2.23, "objective": "th",
     "search": {"method": "portfolio", "settings": {"total_evals": 8000},
                "allocator": "bandit"}},
]


@pytest.mark.parametrize("spec", DOC_SPECS, ids=["exhaustive", "portfolio",
                                                 "structured"])
def test_job_from_spec_equals_the_reference(spec):
    """Both parsers build the same canonical job and settings; only the
    port's tag (and its dtype slot) separate the two key payloads."""
    import repro.service as ref_service
    from repro.core.engine import _canonical as ref_canonical
    from repro.service.queue import resolve_settings as ref_resolve

    from repro_torch.core.engine import _canonical
    from repro_torch.service.queue import resolve_settings

    ref_job, ref_method = ref_service.job_from_spec(spec)
    job, method = job_from_spec(spec)
    assert method == ref_method

    def payload(canonical, j, m, settings):
        return {"job": canonical(dataclasses.replace(
                    j, space=j.design_space(), search_method=m,
                    search_settings=None)),
                "settings": canonical(settings)}

    assert payload(_canonical, job, method,
                   resolve_settings(method, job=job)) == \
        payload(ref_canonical, ref_job, ref_method,
                ref_resolve(ref_method, job=ref_job))
    # the round trip through the wire format keeps the port's key
    from repro_torch.service import job_to_spec
    back, _ = job_from_spec(json.loads(json.dumps(job_to_spec(job))))
    assert job_key(back, method) == job_key(job, method)
