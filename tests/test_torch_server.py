"""The port's HTTP front door (``repro_torch.service.server``) end to end.

tests/test_server.py on the port, with the HTTP, logging, SSE-progress
and metrics parts of tests/test_obs.py and the timeline-endpoint parts of
tests/test_recorder.py.  Most tests run an in-process ephemeral-port
server over stub engines, so the protocol paths (spec round trip, SSE
ordering, remote store read-through, error handling, graceful shutdown)
cannot flake on timing; the real-engine tests run the port's engine on
the CPU.  Then the port's own rules: ``/healthz`` names the port and the
engine's device and dtype, a port client refuses a reference server (and
an empty URL) loudly, and the two servers speak the same SSE events with
the same payload keys.  Every socket, stream and subprocess wait here has
a timeout, and every server is shut down in ``finally``.
"""
from __future__ import annotations

import importlib.util
import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from test_torch_service import SMALL, CountingStubEngine, _fake_result, _job

import torch

from repro_torch import obs
from repro_torch.core import ExplorationEngine, ExploreJob, \
    bert_large_workload, job_key
from repro_torch.core.macro import TPDCIM_MACRO
from repro_torch.obs.log import _parse_spec, configure_logging
from repro_torch.service import (
    ResultStore,
    ServiceClient,
    job_from_spec,
    job_to_spec,
    settings_from_spec,
)
from repro_torch.service.client import RemoteQueue, _read_sse
from repro_torch.service.queue import resolve_settings
from repro_torch.service.server import DSEServer, ServerConfig, _route
from repro_torch.service.streams import as_completed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")


def _load_tool(name: str):
    """Import a script from tools/ (not a package) by file path."""
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


check_metrics = _load_tool("check_metrics")


def _server(tmp_path, engine=None, store="unset", **cfg) -> DSEServer:
    if store == "unset":
        store = ResultStore(str(tmp_path / "server-store"))
    config = ServerConfig(port=0, stream_ping_s=0.2, **cfg)
    return DSEServer(engine=engine or CountingStubEngine(),
                     store=store, config=config).start()


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read().decode())


def _post_json(url: str, payload) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())


def _stream(url: str) -> list[tuple]:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return list(_read_sse(resp))


def _slow_wl():
    from repro_torch.configs import get_arch
    return get_arch("whisper-small").workload(seq=512)


# ------------------------------------------------------------------ #
# spec round trip + status endpoints
# ------------------------------------------------------------------ #
def test_post_jobs_roundtrip_including_portfolio(tmp_path):
    srv = _server(tmp_path)
    try:
        specs = [
            {"macro": "tpdcim-macro", "workload": "bert-large",
             "area_budget_mm2": 2.23, "objective": obj, "search": search,
             "space": {"mr": [1, 2], "mc": [1, 2], "scr": [1, 4],
                       "is_kb": [2, 16], "os_kb": [2, 16]}}
            for obj, search in (("ee", "exhaustive"), ("th", "portfolio"))]
        out = _post_json(f"{srv.url}/v1/jobs?wait=30", specs)
        assert [s["status"] for s in out["jobs"]] == ["done", "done"]
        # the server's canonical keys equal a client's local computation
        for spec, state in zip(specs, out["jobs"]):
            job, method = job_from_spec(spec)
            assert state["key"] == job_key(
                job, method, resolve_settings(method))
            assert state["result"]["workload"] == "bert-large"
        key = out["jobs"][0]["key"]
        state = _get_json(f"{srv.url}/v1/jobs/{key}")
        assert state["status"] == "done"
        assert state["result"]["objective"] == "ee"
    finally:
        srv.shutdown()


def test_inline_job_spec_roundtrip_preserves_key():
    job = ExploreJob(TPDCIM_MACRO, bert_large_workload(384), 1.75,
                     objective="th", strategy_set="so", bw=128, space=SMALL,
                     merge_ops=False, search_method="genetic")
    wire = json.loads(json.dumps(job_to_spec(job)))
    back, method = job_from_spec(wire)
    assert method == "genetic"
    for dtype in (torch.float32, torch.float64):
        assert job_key(back, method, resolve_settings(method), dtype) == \
            job_key(job, "genetic", resolve_settings("genetic"), dtype)


def test_spec_settings_parse_and_reject_unknown_fields():
    from repro_torch.search.genetic import GASettings
    got = settings_from_spec("genetic", {"pop": 8, "generations": 5})
    assert got == GASettings(pop=8, generations=5)
    with pytest.raises(ValueError, match="unknown GASettings fields"):
        settings_from_spec("genetic", {"population": 8})
    assert settings_from_spec("exhaustive", {"x": 1}) is None


# ------------------------------------------------------------------ #
# SSE streaming: per-bucket completion order mirrors as_completed
# ------------------------------------------------------------------ #
def test_sse_stream_order_matches_as_completed(tmp_path):
    fast_wl, slow_wl = bert_large_workload(), _slow_wl()
    eng = CountingStubEngine()
    eng.block_buckets = {eng.bucket_key(
        ExploreJob(TPDCIM_MACRO, slow_wl, 2.23, space=SMALL), "exhaustive")}
    srv = _server(tmp_path, engine=eng)
    try:
        specs = [job_to_spec(_job(wl=fast_wl), "exhaustive"),
                 job_to_spec(_job(wl=slow_wl), "exhaustive")]
        out = _post_json(f"{srv.url}/v1/jobs", specs)
        fast_key, slow_key = (s["key"] for s in out["jobs"])
        url = f"{srv.url}/v1/stream?keys={slow_key},{fast_key}&timeout=30"
        events = []
        with urllib.request.urlopen(url, timeout=60) as resp:
            it = _read_sse(resp)
            event, obj = next(it)
            events.append((event, obj))
            assert obj["key"] == fast_key
            eng.release.set()
            for event, obj in it:
                events.append((event, obj))
        assert [e for e, _ in events] == ["result", "result", "end"]
        assert events[1][1]["key"] == slow_key
        assert events[1][1]["status"] == "done"
    finally:
        eng.release.set()
        srv.shutdown()


def test_remote_client_streams_in_completion_order(tmp_path):
    fast_wl, slow_wl = bert_large_workload(), _slow_wl()
    eng = CountingStubEngine()
    eng.block_buckets = {eng.bucket_key(
        ExploreJob(TPDCIM_MACRO, slow_wl, 2.23, space=SMALL), "exhaustive")}
    srv = _server(tmp_path, engine=eng)
    cli = ServiceClient(base_url=srv.url, store=None, device="cpu")
    try:
        futs = cli.submit_many([_job(wl=fast_wl), _job(wl=slow_wl)],
                               method="exhaustive", metas=["fast", "slow"])
        stream = as_completed(futs, timeout=30)
        assert next(stream).meta == "fast"
        assert not futs[1].done()
        eng.release.set()
        assert next(stream).meta == "slow"
        assert futs[1].result(timeout=30).workload == slow_wl.name
    finally:
        eng.release.set()
        cli.close()
        srv.shutdown()


# ------------------------------------------------------------------ #
# shared-store semantics
# ------------------------------------------------------------------ #
def test_identical_resubmission_answered_from_shared_store(tmp_path):
    eng = CountingStubEngine()
    srv = _server(tmp_path, engine=eng)
    try:
        a = ServiceClient(base_url=srv.url, store=None, device="cpu")
        cold = a.explore([_job()], method="exhaustive", timeout=30)[0]
        assert eng.runs == 1
        a.close()

        b = ServiceClient(base_url=srv.url, store=None, device="cpu")
        warm = b.explore([_job()], method="exhaustive", timeout=30)[0]
        b.close()
        assert eng.runs == 1, "repeat must not reach the engine"
        assert warm.config.as_tuple() == cold.config.as_tuple()
        assert warm.search["cache"] == "remote-store"

        stats = _get_json(f"{srv.url}/v1/stats")
        assert stats["server"]["store_get_hits"] >= 1
        assert stats["store"]["hits"] >= 1
        assert stats["queue"]["dispatches"] == 1
    finally:
        srv.shutdown()


def test_remote_store_read_through_warms_local_tier(tmp_path):
    eng = CountingStubEngine()
    srv = _server(tmp_path, engine=eng)
    local = ResultStore(str(tmp_path / "client-store"))
    try:
        seed = ServiceClient(base_url=srv.url, store=None, device="cpu")
        seed.explore([_job()], method="exhaustive", timeout=30)
        seed.close()

        cli = ServiceClient(base_url=srv.url, store=local, device="cpu")
        got = cli.explore([_job()], method="exhaustive", timeout=30)[0]
        assert got.search["cache"] == "remote-store"
        assert cli.queue.store.stats["remote_hits"] == 1
        before = srv.http_stats["requests"]
        again = cli.explore([_job()], method="exhaustive", timeout=30)[0]
        assert again.search["cache"] == "store"
        assert cli.queue.store.stats["local_hits"] == 1
        assert srv.http_stats["requests"] == before
        cli.close()
    finally:
        srv.shutdown()


def test_remote_values_submission(tmp_path):
    srv = _server(tmp_path)
    cli = ServiceClient(base_url=srv.url, store=None, device="cpu")
    try:
        rows = np.tile(np.asarray([1, 1, 1, 2, 2, 256], np.float64), (5, 1))
        vals = cli.submit_values(_job(), rows).result(timeout=30)
        np.testing.assert_allclose(vals, np.arange(5, dtype=float) + 1.0)
    finally:
        cli.close()
        srv.shutdown()


def test_stream_timeout_fails_pending_futures_instead_of_hanging(tmp_path):
    eng = CountingStubEngine()
    eng.block_buckets = {eng.bucket_key(_job(), "exhaustive")}
    srv = _server(tmp_path, engine=eng)
    q = RemoteQueue(srv.url, store=None, timeout_s=0.5)
    try:
        fut = q.submit(_job(), method="exhaustive")
        exc = fut.exception(timeout=30)
        assert exc is not None
        assert fut.key[:16] in str(exc)
        assert exc.job_key == fut.key
    finally:
        eng.release.set()
        q.close()
        srv.shutdown()


def test_registry_eviction_never_drops_pending_futures(tmp_path):
    eng = CountingStubEngine()
    eng.block_buckets = {eng.bucket_key(_job(), "exhaustive"),
                         eng.bucket_key(_job(wl=_slow_wl()), "exhaustive")}
    srv = _server(tmp_path, engine=eng, registry_cap=1)
    try:
        specs = [job_to_spec(_job(), "exhaustive"),
                 job_to_spec(_job(wl=_slow_wl()), "exhaustive")]
        out = _post_json(f"{srv.url}/v1/jobs", specs)
        keys = [s["key"] for s in out["jobs"]]
        eng.release.set()
        got = {obj.get("key") for event, obj in _stream(
            f"{srv.url}/v1/stream?keys={','.join(keys)}&timeout=30")
            if event == "result"}
        assert got == set(keys)
    finally:
        eng.release.set()
        srv.shutdown()


# ------------------------------------------------------------------ #
# malformed requests
# ------------------------------------------------------------------ #
def _status_of(url: str, payload=None) -> int:
    try:
        if payload is None:
            urllib.request.urlopen(url, timeout=30).close()
        else:
            req = urllib.request.Request(
                url, data=payload,
                headers={"Content-Type": "application/json"},
                method="POST")
            urllib.request.urlopen(req, timeout=30).close()
    except urllib.error.HTTPError as exc:
        return exc.code
    return 200


def test_malformed_requests_get_400s(tmp_path):
    srv = _server(tmp_path)
    try:
        jobs = f"{srv.url}/v1/jobs"
        assert _status_of(jobs, b"{not json") == 400
        assert _status_of(jobs, b"[]") == 400
        assert _status_of(jobs, b'["not-a-spec"]') == 400
        assert _status_of(jobs, json.dumps(
            [{"workload": "bert-large", "area_budget_mm2": 1}]
        ).encode()) == 400                              # missing macro
        assert _status_of(jobs, json.dumps(
            [{"macro": "tpdcim-macro", "workload": "bert-large",
              "area_budget_mm2": 1, "search": "nope"}]).encode()) == 400
        bad_cands = {"macro": "tpdcim-macro", "workload": "bert-large",
                     "area_budget_mm2": 1, "candidates": [[1, 2, 3]]}
        assert _status_of(jobs, json.dumps([bad_cands]).encode()) == 400
        assert _get_json(f"{srv.url}/v1/stats")["queue"]["submitted"] == 0
        assert _status_of(f"{srv.url}/v1/stream") == 400
        assert _status_of(f"{srv.url}/v1/stream?keys=deadbeef") == 404
        assert _status_of(f"{srv.url}/v1/jobs/deadbeef") == 404
        assert _status_of(f"{srv.url}/v1/store/deadbeef") == 404
        assert _status_of(f"{srv.url}/nope") == 404
        assert _get_json(f"{srv.url}/v1/stats")["server"]["bad_requests"] > 0
    finally:
        srv.shutdown()


# ------------------------------------------------------------------ #
# graceful shutdown
# ------------------------------------------------------------------ #
def test_graceful_shutdown_drains_inflight_buckets(tmp_path):
    eng = CountingStubEngine()
    eng.block_buckets = {eng.bucket_key(_job(), "exhaustive")}
    store = ResultStore(str(tmp_path / "server-store"))
    srv = _server(tmp_path, engine=eng, store=store)
    try:
        out = _post_json(f"{srv.url}/v1/jobs",
                         [job_to_spec(_job(), "exhaustive")])
        key = out["jobs"][0]["key"]
        assert out["jobs"][0]["status"] == "pending"
        done = threading.Event()
        threading.Thread(target=lambda: (srv.shutdown(drain=True),
                                         done.set()), daemon=True).start()
        time.sleep(0.1)
        assert not done.is_set(), "shutdown must wait for the held bucket"
        eng.release.set()
        assert done.wait(30), "drain never completed"
        assert store.get(key) is not None
    finally:
        eng.release.set()
        srv.shutdown()


# ------------------------------------------------------------------ #
# pareto SSE endpoint (stub candidate sweep)
# ------------------------------------------------------------------ #
def test_pareto_endpoint_streams_frontiers(tmp_path):
    srv = _server(tmp_path)
    try:
        events = _stream(f"{srv.url}/v1/pareto?macro=tpdcim-macro"
                         f"&workloads=bert-large&area_budget_mm2=2.23"
                         f"&timeout=30")
        assert [e for e, _ in events] == ["frontier", "end"]
        front = events[0][1]
        assert front["workload"] == "bert-large"
        assert front["frontier"], "stub sweep must yield frontier points"
        assert {"config", "gops", "tops_w"} <= set(front["frontier"][0])
    finally:
        srv.shutdown()


# ------------------------------------------------------------------ #
# logging selectors (tests/test_obs.py)
# ------------------------------------------------------------------ #
def test_log_spec_parsing():
    assert _parse_spec("server") == {"server": logging.DEBUG}
    assert _parse_spec("engine,queue=INFO") == {
        "engine": logging.DEBUG, "queue": logging.INFO}
    assert _parse_spec("all=WARNING") == {"all": logging.WARNING}
    assert _parse_spec(" Server = info ") == {"server": logging.INFO}
    assert _parse_spec("") == {}
    assert _parse_spec("x=bogus") == {"x": logging.DEBUG}


def test_configure_logging_applies_selectors_idempotently():
    root = configure_logging("engine=INFO,queue", force=True)
    try:
        assert root.name == "repro_torch"
        assert root.level == logging.WARNING
        assert logging.getLogger("repro_torch.engine").level == logging.INFO
        assert logging.getLogger("repro_torch.queue").level == logging.DEBUG
        assert obs.get_logger("engine").getEffectiveLevel() == logging.INFO
        configure_logging("all=INFO", force=True)
        assert root.level == logging.INFO
        tagged = [h for h in root.handlers
                  if getattr(h, "_repro_obs", False)]
        assert len(tagged) == 1
        assert root.propagate is False
    finally:
        configure_logging("", force=True)
        logging.getLogger("repro_torch.engine").setLevel(logging.NOTSET)
        logging.getLogger("repro_torch.queue").setLevel(logging.NOTSET)


# ------------------------------------------------------------------ #
# HTTP surface: /v1/metrics, /v1/stats shape, concurrent load
# ------------------------------------------------------------------ #
def test_metrics_endpoint_serves_parseable_prometheus(tmp_path):
    srv = _server(tmp_path, engine=ExplorationEngine(**CPU))
    try:
        _post_json(f"{srv.url}/v1/jobs?wait=30",
                   [job_to_spec(_job(), "exhaustive")])
        with urllib.request.urlopen(f"{srv.url}/v1/metrics",
                                    timeout=30) as resp:
            ctype = resp.headers.get("Content-Type", "")
            body = resp.read().decode()
        assert ctype.startswith("text/plain") and "version=0.0.4" in ctype
        families = check_metrics.parse(body)
        assert len(families) >= 12
        for fam in ("cim_queue_submitted_total", "cim_queue_depth",
                    "cim_queue_wait_seconds", "cim_store_ops_total",
                    "cim_http_requests_total", "cim_http_request_seconds",
                    "cim_engine_jobs_total", "cim_search_pulls_total"):
            assert fam in families, f"missing family {fam}"
        for fam in ("cim_queue_submitted_total", "cim_http_requests_total",
                    "cim_engine_jobs_total"):
            assert check_metrics.family_total(families, fam) >= 1, fam
        stats = _get_json(f"{srv.url}/v1/stats")
        assert {"queue", "server", "store", "engine"} <= set(stats)
        assert {"submitted", "store_hits", "inflight_dedup", "dispatches",
                "completed", "failed"} <= set(stats["queue"])
        assert stats["queue"]["submitted"] >= 1
        assert stats["engine"]["jobs"] == 1
        assert stats["engine"]["device"] == "cpu"
    finally:
        srv.shutdown()


def test_stats_and_metrics_consistent_under_concurrent_load(tmp_path):
    """Reader threads hammer /v1/stats + /v1/metrics while a blocked
    batch is in flight and further jobs stream in: every snapshot stays
    internally consistent and monotonic; every scrape stays parseable."""
    slow_wl = _slow_wl()
    eng = CountingStubEngine()
    eng.block_buckets = {eng.bucket_key(
        ExploreJob(TPDCIM_MACRO, slow_wl, 2.23, space=SMALL), "exhaustive")}
    srv = _server(tmp_path, engine=eng)
    errors: list[str] = []
    stop = threading.Event()

    def reader():
        last: dict[str, float] = {}
        while not stop.is_set():
            try:
                stats = _get_json(f"{srv.url}/v1/stats")
                flat = {f"{sec}.{k}": v
                        for sec in ("queue", "server", "store")
                        for k, v in stats[sec].items()
                        if isinstance(v, (int, float))}
                for k in ("queue.submitted", "queue.dispatches",
                          "queue.completed", "server.requests"):
                    if flat[k] < last.get(k, 0):
                        errors.append(
                            f"{k} went backwards: {last[k]} -> {flat[k]}")
                    last[k] = flat[k]
                if flat["queue.completed"] > flat["queue.submitted"]:
                    errors.append(f"torn read: {flat}")
                with urllib.request.urlopen(f"{srv.url}/v1/metrics",
                                            timeout=30) as resp:
                    check_metrics.parse(resp.read().decode())
            except Exception as exc:      # noqa: BLE001 -- collected
                errors.append(f"reader died: {exc!r}")
                return

    threads = [threading.Thread(target=reader) for _ in range(4)]
    try:
        out = _post_json(f"{srv.url}/v1/jobs",
                         [job_to_spec(_job(wl=slow_wl), "exhaustive")])
        keys = [out["jobs"][0]["key"]]
        for t in threads:
            t.start()
        for budget in (2.23, 3.0, 4.0, 5.0):
            out = _post_json(f"{srv.url}/v1/jobs",
                             [job_to_spec(_job(budget=budget),
                                          "exhaustive")])
            keys.append(out["jobs"][0]["key"])
        eng.release.set()
        done = {obj["key"] for event, obj in _stream(
            f"{srv.url}/v1/stream?keys={','.join(keys)}&timeout=30")
            if event == "result"}
        assert done == set(keys)
    finally:
        eng.release.set()
        stop.set()
        for t in threads:
            t.join(timeout=30)
        srv.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]


# ------------------------------------------------------------------ #
# SSE progress events (tests/test_obs.py)
# ------------------------------------------------------------------ #
def test_stream_interleaves_progress_before_result(tmp_path):
    """Per-rung ``progress`` events -- including ones published before
    the stream attached (history replay) -- precede the ``result``."""
    job = _job(budget=7.77)        # a budget no other test publishes for
    eng = CountingStubEngine()
    eng.block_buckets = {eng.bucket_key(job, "exhaustive")}
    srv = _server(tmp_path, engine=eng)
    try:
        out = _post_json(f"{srv.url}/v1/jobs",
                         [job_to_spec(job, "exhaustive")])
        key = out["jobs"][0]["key"]
        bus = obs.progress_bus()
        bus.publish(key, phase="race", allocator="bandit", rung=0,
                    best=2.0, pulls={"sa": 1})
        bus.publish(key, phase="race", allocator="bandit", rung=1,
                    best=1.0, pulls={"sa": 2})
        events = []
        with urllib.request.urlopen(
                f"{srv.url}/v1/stream?keys={key}&timeout=30",
                timeout=60) as resp:
            for event, obj in _read_sse(resp):
                events.append((event, obj))
                if event == "progress" and obj.get("rung") == 1:
                    bus.publish(key, phase="final", best=1.0)
                    eng.release.set()
                if event == "end":
                    break
        kinds = [e for e, _ in events]
        assert kinds.index("progress") < kinds.index("result")
        progress = [obj for e, obj in events if e == "progress"]
        assert [p["seq"] for p in progress] == [0, 1, 2]
        assert [p["phase"] for p in progress] == ["race", "race", "final"]
        assert progress[0]["rung"] == 0 and progress[0]["key"] == key
        assert kinds[-2:] == ["result", "end"]
    finally:
        eng.release.set()
        srv.shutdown()


def test_portfolio_job_progress_reconciles_with_timeline(tmp_path):
    """A real portfolio job on the port's engine, through the server:
    its per-rung SSE progress events equal the flight recorder's timeline
    events on every shared field, the timeline endpoint serves the same
    record, and its summary agrees with the result's portfolio block.
    (tests/test_obs.py's and tests/test_recorder.py's real-engine checks,
    run in process: the port has no native-allocator hazard.)"""
    from repro_torch.search import PortfolioSettings
    ps = PortfolioSettings(backends=("sobol", "sa"), total_evals=512,
                           rungs=2)
    job = _job(budget=7.91)
    srv = _server(tmp_path, engine=ExplorationEngine(**CPU))
    try:
        out = _post_json(f"{srv.url}/v1/jobs",
                         [job_to_spec(job, "portfolio", settings=ps)])
        key = out["jobs"][0]["key"]
        assert key == job_key(job, "portfolio", ps)
        events = _stream(f"{srv.url}/v1/stream?keys={key}&timeout=60")
        sse = [obj for e, obj in events if e == "progress"]
        result = [obj for e, obj in events if e == "result"][0]
        assert [e for e, _ in events][-2:] == ["result", "end"]
        doc = _get_json(f"{srv.url}/v1/jobs/{key}/timeline")
    finally:
        srv.shutdown()
    tl = doc["timeline"]
    assert doc["source"] == "live"
    assert tl["key"] == key and tl["method"] == "portfolio"
    phases = [ev["phase"] for ev in sse]
    assert phases.count("race") >= 1 and phases[-1] == "final"
    assert {"allocator", "rung", "best", "pulls"} <= set(sse[0])
    shared = ("phase", "allocator", "rung", "best", "backend_best",
              "pulls", "devices")
    assert len(tl["events"]) == len(sse)
    for tl_ev, sse_ev in zip(tl["events"], sse):
        for field in shared:
            assert tl_ev.get(field) == sse_ev.get(field), field
    portfolio = result["result"]["search"]["portfolio"]
    assert tl["summary"]["winner"] == portfolio["winner"]
    assert tl["summary"]["pulls"] == tl["events"][-1]["pulls"]


# ------------------------------------------------------------------ #
# timeline endpoint + queue persistence + CLI (tests/test_recorder.py)
# ------------------------------------------------------------------ #
_SPEC = {"macro": "tpdcim-macro", "workload": "bert-large",
         "area_budget_mm2": 2.23, "objective": "ee",
         "search": "exhaustive",
         "space": {"mr": [1, 2], "mc": [1, 2], "scr": [1, 4],
                   "is_kb": [2, 16], "os_kb": [2, 16]}}


def test_timeline_endpoint_live_store_and_404(tmp_path):
    key = "a1b2c3d4"
    store = ResultStore(str(tmp_path / "store"))
    srv = _server(tmp_path, store=store)
    rec = obs.flight_recorder()
    try:
        rec.start(key, method="portfolio", backends=["sa"])
        rec.finish(key, winner="sa")
        doc = _get_json(f"{srv.url}/v1/jobs/{key}/timeline")
        assert doc["source"] == "live"
        assert doc["timeline"]["summary"] == {"winner": "sa"}
        store.put_timeline(key, rec.timeline(key))
        rec.clear()
        doc = _get_json(f"{srv.url}/v1/jobs/{key}/timeline")
        assert doc["source"] == "store"
        assert _status_of(f"{srv.url}/v1/jobs/unknown00/timeline") == 404
    finally:
        rec.clear()
        srv.shutdown()
    assert _route(f"/v1/jobs/{key}/timeline") == "/v1/jobs/{key}/timeline"


def test_queue_persists_timeline_and_restart_serves_it(tmp_path, capsys):
    """The resolve path writes the recorder's timeline into the store, so
    a fresh server over the same store root still serves it -- and the
    CLI renders it."""
    job, method = job_from_spec(_SPEC)
    key = job_key(job, method, resolve_settings(method))
    rec = obs.flight_recorder()
    store = ResultStore(str(tmp_path / "store"))
    srv = _server(tmp_path, store=store)
    try:
        rec.start(key, method=method, backends=["sa"], allocator="none")
        rec.finish(key, winner="sa", best=1.0, final=1.0)
        out = _post_json(f"{srv.url}/v1/jobs?wait=30", [_SPEC])
        assert out["jobs"][0]["status"] == "done"
        assert out["jobs"][0]["key"] == key
        assert store.get_timeline(key) is not None
    finally:
        rec.clear()
        srv.shutdown()
    srv2 = _server(tmp_path, engine=CountingStubEngine(),
                   store=ResultStore(str(tmp_path / "store")))
    try:
        doc = _get_json(f"{srv2.url}/v1/jobs/{key}/timeline")
        assert doc["source"] == "store"
        assert doc["timeline"]["summary"]["winner"] == "sa"
        from repro_torch.service.__main__ import main
        assert main(["timeline", key, "--url", srv2.url]) == 0
        assert "winner    sa" in capsys.readouterr().out
        assert main(["timeline", key, "--url", srv2.url, "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["key"] == key
        assert main(["timeline", "unknown00", "--url", srv2.url]) == 2
        assert "no timeline" in capsys.readouterr().err
    finally:
        srv2.shutdown()


def test_trace_and_store_cli(tmp_path, capsys, monkeypatch):
    from repro_torch.obs.trace import Tracer
    from repro_torch.service.__main__ import main
    spans = tmp_path / "spans.jsonl"
    tr = Tracer(capacity=8, jsonl_path=str(spans))
    with tr.span("cli.work", rows=3):
        pass
    out = tmp_path / "trace.json"
    assert main(["trace", "--input", str(spans), "--export", "chrome",
                 "-o", str(out)]) == 0
    ev = json.loads(out.read_text())["traceEvents"][0]
    assert ev["name"] == "cli.work" and ev["ph"] == "X"
    assert {"ts", "dur", "pid", "tid"} <= set(ev)
    capsys.readouterr()

    monkeypatch.setenv("CIM_TUNER_RESULT_STORE", str(tmp_path / "st"))
    store = ResultStore()
    store.put("ab" * 32, _fake_result(_job()))
    assert main(["store", "--info"]) == 0
    info = capsys.readouterr().out
    assert "records    : 1" in info and store.root in info
    assert main(["store", "--clear"]) == 0
    assert "cleared 1 records" in capsys.readouterr().out
    assert store.keys() == []


# ------------------------------------------------------------------ #
# the port's own rules
# ------------------------------------------------------------------ #
def test_healthz_names_the_port_device_and_dtype(tmp_path):
    srv = DSEServer(store=None, config=ServerConfig(port=0), device="cpu",
                    dtype=torch.float64).start()
    try:
        doc = _get_json(f"{srv.url}/healthz")
        assert doc["ok"] is True and doc["service"] == "cim-tuner-dse"
        assert doc["port"] == "repro_torch"
        assert (doc["device"], doc["device_type"], doc["dtype"]) == \
            ("cpu", "cpu", "torch.float64")
        # a client keys its jobs in the server's dtype
        q = RemoteQueue(srv.url, store=None)
        assert q.dtype == torch.float64
        q.close()
        with pytest.raises(ValueError, match="runs on cpu"):
            ServiceClient(base_url=srv.url, store=None)     # cuda asked
        with pytest.raises(ValueError, match="works in torch.float64"):
            ServiceClient(base_url=srv.url, store=None, device="cpu")
    finally:
        srv.shutdown()


@pytest.mark.parametrize("target", ["reference-server", "nothing"])
def test_port_client_refuses_anything_but_a_port_server(tmp_path, target,
                                                        monkeypatch):
    """No fallback hides the device: a port client pointed at a reference
    server, or at a URL where nothing listens, fails naming the URL."""
    ref_srv = None
    if target == "reference-server":
        pytest.importorskip("jax")
        from repro.service.server import DSEServer as RefServer
        from repro.service.server import ServerConfig as RefConfig
        ref_srv = RefServer(engine=CountingStubEngine(), store=None,
                            config=RefConfig(port=0)).start()
        url = ref_srv.url
    else:
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            url = f"http://127.0.0.1:{s.getsockname()[1]}"
    try:
        with pytest.raises(ConnectionError) as err:
            RemoteQueue(url, store=None, timeout_s=5)
        assert url in str(err.value)
        from repro_torch.service import default_service, \
            reset_default_service
        monkeypatch.setenv("CIM_TUNER_SERVICE_URL", url)
        reset_default_service()
        with pytest.raises(ConnectionError, match=url):
            default_service("cpu")
    finally:
        reset_default_service()
        if ref_srv is not None:
            ref_srv.shutdown()


def test_sse_events_and_payloads_equal_the_reference(tmp_path):
    """The same spec through a reference server (its engine) and a port
    server (the port's engine on the CPU): the same SSE event names in
    the same order, and the same keys in every payload and result."""
    pytest.importorskip("jax")
    import repro.core as ref_core
    from repro.service import ResultStore as RefStore
    from repro.service.server import DSEServer as RefServer
    from repro.service.server import ServerConfig as RefConfig
    spec = dict(_SPEC, search="exhaustive")
    servers = [
        RefServer(engine=ref_core.ExplorationEngine(
            persistent_compile_cache=False),
            store=RefStore(str(tmp_path / "ref")),
            config=RefConfig(port=0, stream_ping_s=0.2)).start(),
        _server(tmp_path, engine=ExplorationEngine(**CPU))]
    seen = []
    try:
        for srv in servers:
            posted = _post_json(f"{srv.url}/v1/jobs?wait=60", [spec])
            key = posted["jobs"][0]["key"]
            events = _stream(f"{srv.url}/v1/stream?keys={key}&timeout=60")
            seen.append((posted, events))
    finally:
        for srv in servers:
            srv.shutdown()
    (ref_post, ref_events), (port_post, port_events) = seen
    assert set(port_post) == set(ref_post)
    assert set(port_post["jobs"][0]) == set(ref_post["jobs"][0])
    assert [e for e, _ in port_events] == [e for e, _ in ref_events] == \
        ["result", "end"]
    for (_, got), (_, want) in zip(port_events, ref_events):
        assert set(got) == set(want)
    got, want = port_events[0][1]["result"], ref_events[0][1]["result"]
    assert set(got) == set(want)
    assert set(got["metrics"]) == set(want["metrics"])
    assert got["config"] == want["config"]
    assert got["per_op_strategy"] == want["per_op_strategy"]


# ------------------------------------------------------------------ #
# separate OS processes sharing one port serve instance
# ------------------------------------------------------------------ #
def test_fleet_of_processes_shares_one_server(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["CIM_TUNER_RESULT_STORE"] = str(tmp_path / "server-store")
    env.pop("CIM_TUNER_SERVICE_URL", None)
    specs = [dict(_SPEC, objective=obj, area_budget_mm2=5.0,
                  macro="vanilla-dcim",
                  space={"mr": [1, 2], "mc": [1, 2], "scr": [1, 4],
                         "is_kb": [16, 128], "os_kb": [16, 64]})
             for obj in ("ee", "th")]
    jobs_file = tmp_path / "jobs.json"
    jobs_file.write_text(json.dumps(specs))
    port_file = tmp_path / "port.txt"
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", "serve", "--port", "0",
         "--port-file", str(port_file), "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO)
    try:
        deadline = time.monotonic() + 120
        while not port_file.exists():
            assert server.poll() is None, \
                f"server died early:\n{server.stdout.read()}"
            assert time.monotonic() < deadline, "server never bound a port"
            time.sleep(0.1)
        url = f"http://127.0.0.1:{port_file.read_text().strip()}"
        assert _get_json(f"{url}/healthz")["port"] == "repro_torch"

        def client(tag: str, extra: list[str]) -> subprocess.Popen:
            cenv = dict(env)
            cenv["CIM_TUNER_RESULT_STORE"] = str(tmp_path / f"{tag}-store")
            cenv["CIM_TUNER_SERVICE_URL"] = url
            return subprocess.Popen(
                [sys.executable, "-m", "repro_torch.service", "explore",
                 str(jobs_file), "--device", "cpu", *extra],
                env=cenv, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=REPO)

        a = client("client-a", ["--stream"])
        b = client("client-b", ["--json"])
        out_a, _ = a.communicate(timeout=300)
        out_b, _ = b.communicate(timeout=300)
        assert a.returncode == 0, f"client A failed:\n{out_a}"
        assert b.returncode == 0, f"client B failed:\n{out_b}"
        assert out_a.count("bert-large") >= 2, out_a
        recs = [json.loads(line) for line in out_b.splitlines()]
        assert [r["index"] for r in recs] == [0, 1]

        before = _get_json(f"{url}/v1/stats")
        c = client("client-c", [])
        out_c, _ = c.communicate(timeout=300)
        assert c.returncode == 0, f"client C failed:\n{out_c}"
        after = _get_json(f"{url}/v1/stats")
        assert after["store"]["hits"] > before["store"]["hits"], \
            "warm repeat must be served by the shared store"
        assert after["queue"]["dispatches"] == before["queue"]["dispatches"]

        server.terminate()                              # SIGTERM: graceful
        out_s, _ = server.communicate(timeout=60)
        assert server.returncode == 0, f"server exit nonzero:\n{out_s}"
        assert "draining" in out_s
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate(timeout=30)
