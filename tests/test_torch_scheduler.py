"""The port's continuous-batching scheduler (``repro_torch.service.queue``)
and the streamed path's bit-equality.

tests/test_scheduler.py and tests/test_service_properties.py on the port.
The engine-level admission and budget-flow tests of the reference's file
are in tests/test_torch_portfolio.py (rung admission bit for bit, the
single-bandit-group rule, pull conservation and replay); here the queue
drives the port's engine on the CPU: a job admitted into a running race
through the queue equals its solo run, and with no late arrivals the
continuous path equals ``QueueConfig(continuous=False)`` bit for bit.
Queue-level wiring (admission, the ``max_batch_jobs`` lane cap, the
close() drain) uses stub engines so it cannot flake on timing.
"""
from __future__ import annotations

import contextlib
import shutil
import tempfile
import threading
import time

import pytest
from hypothesis import given, settings, strategies as st
from test_torch_service import _fake_result, _job

import torch

from repro_torch.core import (DesignSpace, ExplorationEngine, ExploreJob,
                              MatmulOp, Workload, get_macro)
from repro_torch.search import PortfolioSettings
from repro_torch.service import JobQueue, QueueConfig, ResultStore

#: small real-engine race: 2 backends x 2 rungs = 4 bandit pulls a job
PS = dict(backends=("sa", "sobol"), total_evals=64, rungs=2)
F64 = dict(device="cpu", dtype=torch.float64)


def _equal_results(a, b) -> None:
    assert a.config.as_tuple() == b.config.as_tuple()
    for k in ("energy_pj", "latency_cycles", "tops_w", "gops", "area_mm2"):
        assert a.metrics[k] == b.metrics[k], k
    assert a.search["portfolio"] == b.search["portfolio"]


# ------------------------------------------------------------------ #
# the real engine through the queue
# ------------------------------------------------------------------ #
def test_quiesced_continuous_equals_window_bitwise():
    """With no late arrivals the scheduler must be invisible: the same
    two-job batch through a continuous queue and a window queue produces
    bit-identical results, equal to the engine's own."""
    eng = ExplorationEngine(**F64)
    ps = PortfolioSettings(**PS)
    jobs = [_job(budget=2.23), _job(budget=2.24)]
    legs = {}
    for continuous in (True, False):
        q = JobQueue(engine=eng, store=None,
                     config=QueueConfig(batch_window_s=0.2,
                                        continuous=continuous))
        futs = [q.submit(j, method="portfolio", settings=ps) for j in jobs]
        legs[continuous] = [f.result(timeout=600) for f in futs]
        q.close()
        assert q.stats["dispatches"] == 1
    direct = eng.run(jobs, method="portfolio", settings=ps)
    for ra, rb, rd in zip(legs[True], legs[False], direct):
        _equal_results(ra, rb)
        _equal_results(ra, rd)
        assert ra.search["budget_flow"] == rb.search["budget_flow"]


class _HoldSecondPoll(ExplorationEngine):
    """The port's engine, whose second admission poll (after the race's
    first wave) waits until the test has submitted its late job -- so the
    late job is pending at a rung boundary of the running race, whatever
    the host's speed."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.racing = threading.Event()
        self.submitted = threading.Event()

    def run(self, jobs, method=None, settings=None, sa_settings=None,
            keys=None, admit=None):
        if admit is not None:
            inner, polls = admit, [0]

            def admit():
                polls[0] += 1
                if polls[0] == 2:
                    self.racing.set()
                    assert self.submitted.wait(30), "late job never came"
                return inner()
        return super().run(jobs, method, settings, sa_settings, keys, admit)


def test_admitted_job_equals_its_solo_run_through_the_queue(tmp_path):
    ps = PortfolioSettings(**PS)
    early, late = _job(budget=2.23), _job(budget=2.24)
    eng = _HoldSecondPoll(**F64)
    store = ResultStore(str(tmp_path))
    q = JobQueue(engine=eng, store=store,
                 config=QueueConfig(batch_window_s=0.01))
    try:
        f_early = q.submit(early, method="portfolio", settings=ps)
        assert eng.racing.wait(60), "the race never reached a boundary"
        f_late = q.submit(late, method="portfolio", settings=ps)
        eng.submitted.set()
        got_early, got_late = (f.result(timeout=600)
                               for f in (f_early, f_late))
    finally:
        eng.submitted.set()
        q.close()
    snap = q.stats_snapshot()
    assert snap["scheduler"]["admitted"] == 1
    assert snap["queue"]["dispatches"] == 1
    assert got_late.search["budget_flow"]["admitted_wave"] >= 1
    solo = ExplorationEngine(**F64)
    _equal_results(got_early, solo.run([early], method="portfolio",
                                       settings=ps)[0])
    _equal_results(got_late, solo.run([late], method="portfolio",
                                      settings=ps)[0])
    assert sorted(store.keys()) == sorted([f_early.key, f_late.key])


# ------------------------------------------------------------------ #
# queue-level admission wiring (stub engine)
# ------------------------------------------------------------------ #
class WaveStubEngine:
    """Holds its first ``run()`` open, polling ``admit`` like the real
    engine does between waves, until ``release`` is set."""

    device = torch.device("cpu")
    dtype = torch.float32

    def __init__(self):
        self.release = threading.Event()
        self.started = threading.Event()
        self.admitted_keys = []
        self.calls = 0

    def stats_snapshot(self):
        return {}

    def bucket_key(self, job, method=None):
        return ("stub-bucket",)

    def run(self, jobs, method=None, settings=None, sa_settings=None,
            keys=None, admit=None):
        self.calls += 1
        jobs = list(jobs)
        self.started.set()
        if admit is not None:
            deadline = time.monotonic() + 30
            while not self.release.is_set():
                assert time.monotonic() < deadline, "never released"
                for job, key in admit():
                    jobs.append(job)
                    self.admitted_keys.append(key)
                time.sleep(0.005)
        return [_fake_result(j) for j in jobs]


def test_queue_admits_compatible_pending_into_inflight_group(tmp_path):
    eng = WaveStubEngine()
    ps = PortfolioSettings(**PS)
    store = ResultStore(str(tmp_path))
    q = JobQueue(engine=eng, store=store,
                 config=QueueConfig(batch_window_s=0.01))
    try:
        f_a = q.submit(_job(budget=2.23), method="portfolio", settings=ps)
        assert eng.started.wait(10), "first dispatch never started"
        f_b = q.submit(_job(budget=2.24), method="portfolio", settings=ps)
        deadline = time.monotonic() + 10
        while not eng.admitted_keys and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eng.admitted_keys == [f_b.key], "late job never admitted"
        snap = q.stats_snapshot()
        assert snap["scheduler"]["inflight_groups"] == 1
        assert snap["scheduler"]["inflight_group_jobs"] == 2
        eng.release.set()
        assert f_a.result(timeout=30) is not None
        assert f_b.result(timeout=30) is not None
        snap = q.stats_snapshot()
        assert snap["scheduler"]["admitted"] == 1
        assert snap["scheduler"]["admission_checks"] >= 1
        assert snap["queue"]["dispatches"] == 1, \
            "admitted job must not trigger a second engine call"
        assert snap["scheduler"]["inflight_groups"] == 0
        assert sorted(store.keys()) == sorted([f_a.key, f_b.key])
    finally:
        eng.release.set()
        q.close()


def test_queue_incompatible_pending_waits_for_own_dispatch():
    """A pending job with different settings must NOT join the in-flight
    group -- it dispatches separately once the race drains."""
    eng = WaveStubEngine()
    q = JobQueue(engine=eng, store=None,
                 config=QueueConfig(batch_window_s=0.01))
    try:
        f_a = q.submit(_job(budget=2.23), method="portfolio",
                       settings=PortfolioSettings(**PS))
        assert eng.started.wait(10)
        other = PortfolioSettings(backends=("sa", "sobol"),
                                  total_evals=128, rungs=2)
        f_b = q.submit(_job(budget=2.24), method="portfolio",
                       settings=other)
        time.sleep(0.1)          # give a wrong admission time to happen
        assert eng.admitted_keys == []
        eng.release.set()
        assert f_a.result(timeout=30) is not None
        assert f_b.result(timeout=30) is not None
        snap = q.stats_snapshot()
        assert snap["scheduler"]["admitted"] == 0
        assert snap["queue"]["dispatches"] == 2
    finally:
        eng.release.set()
        q.close()


class CountingEngine:
    """Records the size of every dispatched batch."""

    device = torch.device("cpu")
    dtype = torch.float32

    def __init__(self):
        self.batch_sizes = []

    def stats_snapshot(self):
        return {}

    def bucket_key(self, job, method=None):
        return ("stub-bucket",)

    def run(self, jobs, method=None, settings=None, sa_settings=None,
            keys=None, admit=None):
        self.batch_sizes.append(len(jobs))
        return [_fake_result(j) for j in jobs]


def test_max_batch_jobs_caps_each_dispatch():
    """``max_batch_jobs`` is a hard lane cap: a bigger backlog dispatches
    as successive bounded batches on the window path."""
    eng = CountingEngine()
    q = JobQueue(engine=eng, store=None,
                 config=QueueConfig(batch_window_s=0.2, max_batch_jobs=2,
                                    continuous=False))
    try:
        futs = [q.submit(_job(budget=2.23 + i * 1e-6), method="portfolio",
                         settings=PortfolioSettings(**PS))
                for i in range(5)]
        for f in futs:
            assert f.result(timeout=30) is not None
        assert eng.batch_sizes == [2, 2, 1]
    finally:
        q.close()


@pytest.mark.parametrize("held, want", [(True, [2]), (False, [1, 1])])
def test_holding_keeps_one_batch_in_one_window(held, want):
    """Submissions made under ``holding()`` land in one dispatch however
    long the caller takes between them (a POST of many specs, a
    ``submit_many`` whose keying outlasts the default window); without
    the hold the window closes in between."""
    eng = CountingEngine()
    q = JobQueue(engine=eng, store=None,
                 config=QueueConfig(continuous=False))
    ps = PortfolioSettings(**PS)
    try:
        with q.holding() if held else contextlib.nullcontext():
            futs = [q.submit(_job(budget=2.23), method="portfolio",
                             settings=ps)]
            time.sleep(0.3)          # 15 default windows
            futs.append(q.submit(_job(budget=2.24), method="portfolio",
                                 settings=ps))
        for f in futs:
            assert f.result(timeout=30) is not None
        assert eng.batch_sizes == want
    finally:
        q.close()


def test_close_drains_accepted_futures_under_load():
    class SlowStubEngine:
        device = torch.device("cpu")
        dtype = torch.float32

        def stats_snapshot(self):
            return {}

        def bucket_key(self, job, method=None):
            return ("stub-bucket",)

        def run(self, jobs, method=None, settings=None, sa_settings=None,
                keys=None, admit=None):
            time.sleep(0.05)
            jobs = list(jobs)
            if admit is not None:
                for job, _key in admit():
                    jobs.append(job)
            return [_fake_result(j) for j in jobs]

    q = JobQueue(engine=SlowStubEngine(), store=None,
                 config=QueueConfig(batch_window_s=0.02, max_batch_jobs=2))
    futs = [q.submit(_job(budget=2.23 + i * 1e-6), method="portfolio",
                     settings=PortfolioSettings(**PS))
            for i in range(8)]
    q.close()                    # default: full drain
    for f in futs:
        assert f.done(), "close() stranded an accepted future"
        assert f.exception(0) is None
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(_job(), method="portfolio",
                 settings=PortfolioSettings(**PS))


# ------------------------------------------------------------------ #
# properties (tests/test_service_properties.py on the port)
# ------------------------------------------------------------------ #
MACRO = get_macro("vanilla-dcim")
TINY = DesignSpace(mr=(1, 2), mc=(1, 2), scr=(1, 4),
                   is_kb=(2, 16), os_kb=(2, 16))

op_st = st.tuples(
    st.integers(1, 96),          # m
    st.integers(1, 512),         # k
    st.integers(1, 256),         # n
    st.integers(1, 4),           # count
    st.booleans(),               # weights_static
)
workload_st = st.lists(op_st, min_size=1, max_size=6)


def _workload(ops, name="prop"):
    return Workload(name, tuple(
        MatmulOp(m=m, k=k, n=n, count=c, weights_static=w,
                 name=f"op{i}")
        for i, (m, k, n, c, w) in enumerate(ops)))


# 7 distinct merged ops -> pads the 8-wide operator bucket that 5-6-op
# random workloads share; its larger budget keeps MORE pruned candidates,
# so the shared [jobs, chunk] sweep pads the small job's exhausted lane
BIG_JOB = ExploreJob(
    MACRO,
    _workload([(64, 64 + 8 * i, 64, 1, True) for i in range(7)],
              name="big"),
    5.0, objective="ee", space=TINY)

SOLO_ENGINE = ExplorationEngine(device="cpu")
STREAM_ENGINE = ExplorationEngine(device="cpu")


@settings(max_examples=15, deadline=None)
@given(ops=workload_st, objective=st.sampled_from(["ee", "th"]))
def test_streamed_best_cost_equals_single_job_bitwise(ops, objective):
    """Shape-bucket padding is value-transparent through the streamed
    path: beside a companion that pads the operator bucket and the sweep's
    lanes, a job gets the solo run's config and metrics bit for bit."""
    wl = _workload(ops)
    job = ExploreJob(MACRO, wl, 3.0, objective=objective, space=TINY)
    solo = SOLO_ENGINE.run([job], method="exhaustive")[0]
    with JobQueue(engine=STREAM_ENGINE, store=None,
                  config=QueueConfig(batch_window_s=0.02)) as q:
        futs = q.submit_many([job, BIG_JOB], method="exhaustive")
        streamed = futs[0].result(timeout=600)
    assert streamed.config.as_tuple() == solo.config.as_tuple()
    for key in ("energy_pj", "latency_cycles", "tops_w", "gops",
                "area_mm2"):
        assert streamed.metrics[key] == solo.metrics[key], \
            (key, "padded/streamed value differs from solo run")


class _PropEngine:
    """Instant stub that still exercises the admission path: one
    admission poll per dispatch, results in engine order."""

    device = torch.device("cpu")
    dtype = torch.float32

    def stats_snapshot(self):
        return {}

    def bucket_key(self, job, method=None):
        return ("prop-bucket",)

    def run(self, jobs, method=None, settings=None, sa_settings=None,
            keys=None, admit=None):
        jobs = list(jobs)
        if admit is not None:
            for job, _key in admit():
                jobs.append(job)
        return [_fake_result(j) for j in jobs]


@settings(max_examples=25, deadline=None)
@given(ops=st.lists(st.integers(0, 5), min_size=1, max_size=10),
       close_at=st.integers(0, 10))
def test_submit_close_interleavings_resolve_exactly_once(ops, close_at):
    """Arbitrary submit/close interleavings: every accepted future
    resolves exactly once and the store ends up holding exactly the
    resolved job keys."""
    bandit = PortfolioSettings(**PS)
    root = tempfile.mkdtemp(prefix="cim-sched-prop-")
    q = JobQueue(engine=_PropEngine(), store=ResultStore(root),
                 config=QueueConfig(batch_window_s=0.005,
                                    max_batch_jobs=3))
    futures, counts = [], {}
    try:
        for i, v in enumerate(ops):
            if i == close_at:
                q.close()
            job = ExploreJob(
                MACRO, _workload([(8, 8, 8, 1, True)], name=f"wl{v % 3}"),
                3.0 + v * 1e-6, objective="ee", space=TINY)
            # odd variants ride the continuous bandit-portfolio path,
            # even ones the plain window path
            kwargs = ({"method": "portfolio", "settings": bandit}
                      if v % 2 else {"method": "exhaustive"})
            try:
                f = q.submit(job, **kwargs)
            except RuntimeError:
                assert i >= close_at, "open queue rejected a submission"
                continue
            counts[id(f)] = 0
            f.add_done_callback(
                lambda fut: counts.__setitem__(
                    id(fut), counts[id(fut)] + 1))
            futures.append(f)
        q.close()
        for f in futures:
            assert f.wait(30), "close() stranded an accepted future"
            assert f.exception(0) is None
            assert counts[id(f)] == 1, "future resolved more than once"
        store = ResultStore(root)
        assert set(store.keys()) == {f.key for f in futures}, \
            "store contents != resolved job keys"
    finally:
        q.close()
        shutil.rmtree(root, ignore_errors=True)
