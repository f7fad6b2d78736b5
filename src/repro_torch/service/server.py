"""Multi-process HTTP front door of the port's DSE service.

One ``python -m repro_torch.service serve`` process owns the batched
exploration engine (on the card unless asked for the CPU), the
micro-batching job queue and the persistent result store; any number of
client processes -- CI shards, sweeps, notebooks on other hosts -- submit
over plain HTTP and share its engine and results.  Stdlib only
(``http.server.ThreadingHTTPServer``): no new dependencies.

Endpoints
---------

``POST /v1/jobs``
    Body: one JSON job spec or a list (the exact schema the CLI reads --
    see :func:`repro_torch.service.client.job_from_spec`, including ``"search"``
    as a backend name or the structured per-job form ``{"method": ...,
    "settings": {...}, "allocator": "bandit"|"halving"}``, plus the
    legacy top-level ``"settings"``; a spec with ``"candidates": [[...],
    ...]`` runs the Pareto candidate-sweep path).  Specs are validated up front:
    any bad record fails the whole request with 400 before anything is
    admitted.  Returns one state record per spec (canonical ``key``,
    ``status``, and the inline result for store/dedup answers);
    ``?wait=SECONDS`` long-polls until done.
``GET /v1/jobs/<key>``
    Status/result of one submission (``?wait=SECONDS`` long-polls).
    Falls back to the persistent store for keys from previous runs.
``GET /v1/stream?keys=k1,k2,...``
    Server-sent events: one ``result`` event per key the moment its
    micro-batch bucket finishes -- completion order, mirroring
    :func:`repro_torch.service.streams.as_completed` -- then one ``end``
    event.  Portfolio races interleave per-rung ``progress`` events.
    Comment pings keep idle connections alive.
``GET /v1/pareto?macro=...&workloads=a,b&area_budget_mm2=...``
    Streams per-workload EE/Th Pareto frontiers as SSE events
    (server-side :func:`repro_torch.service.streams.stream_pareto`).
``GET /v1/store/<key>``
    Raw serialized record from the server's result store -- the remote
    tier of :class:`repro_torch.service.store.RemoteStoreTier` reads this;
    the server is the only writer of the shared store.
``GET /v1/jobs/<key>/timeline`` / ``.../measurements``
    A portfolio job's decision timeline (live recorder, then the store's
    sidecar); the kernel measurements behind a measured-fidelity result.
``GET /healthz`` / ``GET /v1/stats``
    Liveness -- with the port's tag (``"port": "repro_torch"``) and the
    engine's device and dtype beside the reference's fields, which is how
    a port client tells a port server from a reference one; queue depth,
    dedup/store hit counters, engine run counters, HTTP counters.
``GET /v1/metrics`` / ``/v1/trace`` / ``/v1/calibration``
    Prometheus text of the process registry; the span ring buffer as a
    Chrome trace; the active kernel calibration.

Graceful shutdown (``DSEServer.shutdown`` / SIGTERM in the CLI) stops
accepting connections, then drains in-flight micro-batch buckets through
``JobQueue.close`` so accepted work still lands in the store.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue as _queue
import threading
import time
import typing
import urllib.parse
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import (PORT_TAG, ExplorationEngine,
                                     ExploreResult, device_name)
from repro_torch.service.client import ServiceClient, job_from_spec
from repro_torch.service.queue import _device_scope
from repro_torch.service.store import serialize_result
from repro_torch.service.streams import ExploreFuture, stream_pareto

__all__ = ["ServerConfig", "DSEServer", "serve"]

_SPEC_ERRORS = (KeyError, TypeError, ValueError)

# telemetry families (process-wide, the reference's names)
_REG = obs.registry()
_M_HTTP = _REG.counter(
    "cim_http_requests_total",
    "Requests served per (normalized) endpoint and method",
    ("endpoint", "method"))
_M_HTTP_S = _REG.histogram(
    "cim_http_request_seconds", "Request handling latency per endpoint",
    ("endpoint",))
_M_EVENTS = _REG.counter(
    "cim_http_events_total", "Front-door events by type", ("event",))

#: normalized route labels -- key-bearing paths collapse onto one child so
#: label cardinality stays bounded no matter how many job keys exist
_ROUTES = ("/healthz", "/v1/stats", "/v1/metrics", "/v1/trace",
           "/v1/jobs", "/v1/stream", "/v1/pareto", "/v1/calibration")


def _route(path: str) -> str:
    """Bounded endpoint label of a request path."""
    if path in _ROUTES:
        return path
    if path.startswith("/v1/jobs/"):
        if path.endswith("/timeline"):
            return "/v1/jobs/{key}/timeline"
        if path.endswith("/measurements"):
            return "/v1/jobs/{key}/measurements"
        return "/v1/jobs/{key}"
    if path.startswith("/v1/store/"):
        return "/v1/store/{key}"
    return "other"


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Front-door knobs (all orthogonal to the queue's own config)."""

    host: str = "127.0.0.1"
    #: 0 binds an ephemeral port (read it back from ``DSEServer.port``)
    port: int = 0
    #: reject request bodies larger than this (one giant candidate sweep
    #: is ~a few MB; 64 MB is far beyond any legitimate submission)
    max_body_bytes: int = 64 * 1024 * 1024
    #: completed futures kept addressable for /v1/jobs + /v1/stream;
    #: evicted explore results remain reachable through the store
    registry_cap: int = 4096
    #: SSE keep-alive comment interval
    stream_ping_s: float = 15.0
    #: cap on ?wait= long-polling
    max_wait_s: float = 600.0
    #: keep the ``repro_torch.server`` logger at its env-configured level
    #: (``CIM_TUNER_LOG``); ``quiet=False`` forces it to DEBUG, which
    #: turns on per-request access lines (the old stderr logging)
    quiet: bool = True


class DSEServer:
    """The always-on multi-process front door over one ServiceClient."""

    def __init__(
        self,
        client: ServiceClient | None = None,
        engine: ExplorationEngine | None = None,
        store: typing.Any = "auto",
        config: ServerConfig = ServerConfig(),
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        """Serve ``client``, or a new in-process one over ``engine`` (or
        the default engine for ``device`` and ``dtype``) and ``store``;
        binds the socket here, serves after :meth:`start`."""
        self.client = client or ServiceClient(engine=engine, store=store,
                                              device=device, dtype=dtype)
        if self.client.remote:
            raise ValueError("DSEServer needs an in-process ServiceClient")
        self.config = config
        # legacy-shaped per-instance counters mirrored into the
        # process-wide cim_http_events_total family; StatCounters locks
        # each bump, replacing the old dedicated _stats_lock
        self.http_stats = obs.StatCounters({
            key: _M_EVENTS.labels(event=key)
            for key in ("requests", "bad_requests", "errors",
                        "jobs_posted", "values_posted", "store_get_hits",
                        "store_get_misses", "streams")})
        self.log = obs.get_logger("server")
        if not config.quiet:
            # --verbose: per-request access lines regardless of env
            import logging
            self.log.setLevel(logging.DEBUG)
        self._registry: OrderedDict[str, ExploreFuture] = OrderedDict()
        self._reg_lock = threading.Lock()
        self._started_s = time.time()
        self._httpd = ThreadingHTTPServer(
            (config.host, config.port), _Handler)
        self._httpd.dse = self                         # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None
        self._shut = False

    # ------------------------------------------------------------- #
    # lifecycle
    # ------------------------------------------------------------- #
    @property
    def host(self) -> str:
        """The bound host."""
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        """The bound port (the ephemeral one when configured with 0)."""
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        """``http://host:port`` of this front door."""
        return f"http://{self.host}:{self.port}"

    def start(self) -> "DSEServer":
        """Serve in a daemon thread; returns self (context-manager style:
        ``with DSEServer(...).start() as srv: ...``).

        With ``CIM_TUNER_PROFILE`` set, a background warm-up runs the
        kernel micro-profile pass once on the engine's device (on the card,
        every kernel launches), so ``/v1/metrics`` serves real
        ``cim_kernel_*`` series (with exemplars into this process's
        ``/v1/trace``) from the first scrape."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="cim-tuner-dse-http", daemon=True)
        self._thread.start()
        if obs.profile.profiling_enabled():
            threading.Thread(target=self._profile_warmup,
                             name="cim-tuner-profile-warmup",
                             daemon=True).start()
        return self

    def _profile_warmup(self) -> None:
        queue = self.client.queue
        try:
            # one launcher at a time: the queue's worker holds the same
            # lock around every engine call
            with queue.engine_lock, _device_scope(queue.device):
                rows = obs.profile.run_microbench(device=queue.device)
            self.log.info("kernel profile warm-up: %d series", len(rows))
        except Exception as exc:           # noqa: BLE001 -- never fatal
            self.log.warning("kernel profile warm-up failed: %r", exc)

    def shutdown(self, drain: bool = True,
                 timeout: float | None = 30.0) -> None:
        """Stop accepting requests, then (by default) drain every accepted
        micro-batch bucket through the queue so in-flight submissions still
        resolve and persist before the process exits."""
        if self._shut:
            return
        self._shut = True
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
        if drain:
            self.client.close()

    def __enter__(self) -> "DSEServer":
        """Context-manager support (see :meth:`start`)."""
        return self

    def __exit__(self, *exc) -> None:
        """Shut down with a drain on context exit."""
        self.shutdown()

    def bump(self, counter: str) -> None:
        """Locked counter increment -- handler threads are concurrent and
        ``/v1/stats`` readings gate CI assertions, so lost updates from
        racing read-modify-writes are not acceptable."""
        self.http_stats.bump(counter)

    # ------------------------------------------------------------- #
    # registry
    # ------------------------------------------------------------- #
    def register(self, fut: ExploreFuture) -> None:
        """Make a future addressable by its key (bounded; see
        ``ServerConfig.registry_cap``)."""
        store = self.client.store
        with self._reg_lock:
            self._registry[fut.key] = fut
            self._registry.move_to_end(fut.key)
            while len(self._registry) > self.config.registry_cap:
                # eviction preference: completed entries whose result is
                # recoverable through the store, then any completed entry
                # (values sweeps / --no-store results become 404s), and
                # NEVER a pending future -- /v1/stream must not lose
                # running work, so the cap may temporarily overrun
                victim = next(
                    (k for k, f in self._registry.items()
                     if f.done() and store is not None and k in store),
                    None)
                if victim is None:
                    victim = next((k for k, f in self._registry.items()
                                   if f.done()), None)
                if victim is None:
                    break
                del self._registry[victim]

    def lookup(self, key: str) -> ExploreFuture | None:
        """Future for a key: live registry first, then the persistent
        store (as an already-completed future)."""
        with self._reg_lock:
            fut = self._registry.get(key)
        if fut is not None:
            return fut
        store = self.client.store
        if store is None:
            return None
        result = store.get(key)
        if result is None:
            return None
        return ExploreFuture.completed(None, "store", key, result,
                                       source="store")

    # ------------------------------------------------------------- #
    # state serialization
    # ------------------------------------------------------------- #
    @staticmethod
    def job_state(fut: ExploreFuture) -> dict:
        """JSON-able status/result record of one future."""
        rec: dict = {"key": fut.key, "method": fut.method}
        if not fut.done():
            rec["status"] = "pending"
            return rec
        exc = fut.exception(timeout=0)
        if exc is not None:
            rec.update(status="failed", error=str(exc),
                       error_type=type(exc).__name__,
                       job_key=getattr(exc, "job_key", None))
            return rec
        rec["status"] = "done"
        rec["source"] = fut.source
        result = fut._result
        if isinstance(result, ExploreResult):
            rec["result"] = serialize_result(result)
        else:
            rec["values"] = np.asarray(result).tolist()
        return rec

    def health(self) -> dict:
        """The ``/healthz`` record: the reference's fields, plus the
        port's tag and the engine's device and dtype."""
        queue = self.client.queue
        return {"ok": True, "service": "cim-tuner-dse",
                "pid": os.getpid(),
                "uptime_s": round(time.time() - self._started_s, 3),
                "port": PORT_TAG,
                "device": device_name(queue.device),
                "device_type": queue.device.type,
                "dtype": str(queue.dtype)}

    def stats(self) -> dict:
        """The ``/v1/stats`` record: queue, scheduler, store and engine
        counters plus this front door's own."""
        snap = self.client.stats_snapshot()
        with self._reg_lock:
            registry = len(self._registry)
        http = self.http_stats.snapshot()
        snap["server"] = {
            **http,
            "registry": registry,
            "uptime_s": round(time.time() - self._started_s, 3),
            "url": self.url,
        }
        return snap


def serve(
    host: str = "127.0.0.1",
    port: int = 0,
    store: typing.Any = "auto",
    engine: ExplorationEngine | None = None,
    config: ServerConfig | None = None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> DSEServer:
    """Build and start a front door in one call; returns the running
    server (``.url`` carries the bound ephemeral port)."""
    cfg = config or ServerConfig(host=host, port=port)
    return DSEServer(engine=engine, store=store, config=cfg, device=device,
                     dtype=dtype).start()


# ------------------------------------------------------------------ #
# the request handler
# ------------------------------------------------------------------ #
class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "cim-tuner-dse/1.0"

    # -- plumbing --------------------------------------------------- #
    @property
    def dse(self) -> DSEServer:
        return self.server.dse                         # type: ignore[attr-defined]

    def log_message(self, fmt: str, *args) -> None:    # noqa: A003
        # request lines go through the repro_torch.server logger at DEBUG --
        # silent by default, enabled via CIM_TUNER_LOG=server or --verbose
        self.dse.log.debug("%s %s", self.address_string(), fmt % args)

    def _send_json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, content_type: str) -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _bad(self, message: str, code: int = 400) -> None:
        self.dse.bump("bad_requests")
        self._send_json(code, {"error": message})

    def _query(self) -> tuple[str, dict[str, str]]:
        parts = urllib.parse.urlsplit(self.path)
        q = {k: v[-1] for k, v in
             urllib.parse.parse_qs(parts.query).items()}
        return parts.path, q

    def _wait_s(self, q: dict[str, str]) -> float:
        try:
            wait = float(q.get("wait", "0"))
        except ValueError:
            wait = 0.0
        return max(0.0, min(wait, self.dse.config.max_wait_s))

    # -- SSE -------------------------------------------------------- #
    def _sse_begin(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True

    def _sse_event(self, obj: dict, event: str | None = None) -> None:
        buf = b""
        if event:
            buf += f"event: {event}\n".encode()
        buf += b"data: " + json.dumps(obj).encode("utf-8") + b"\n\n"
        self.wfile.write(buf)
        self.wfile.flush()

    def _sse_ping(self) -> None:
        self.wfile.write(b": ping\n\n")
        self.wfile.flush()

    # -- routing ---------------------------------------------------- #
    def do_GET(self) -> None:                          # noqa: N802
        self.dse.bump("requests")
        path, q = self._query()
        route = _route(path)
        _M_HTTP.inc(endpoint=route, method="GET")
        try:
            with obs.span("server.request", histogram=_M_HTTP_S.labels(
                    endpoint=route), endpoint=route, method="GET"):
                if path == "/healthz":
                    self._send_json(200, self.dse.health())
                elif path == "/v1/stats":
                    self._send_json(200, self.dse.stats())
                elif path == "/v1/metrics":
                    self._send_text(
                        200, obs.registry().render(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/v1/trace":
                    self._send_json(
                        200, obs.chrome_trace(obs.tracer().events()))
                elif path == "/v1/calibration":
                    self._get_calibration()
                elif path.startswith("/v1/jobs/") and \
                        path.endswith("/timeline"):
                    key = path[len("/v1/jobs/"):-len("/timeline")]
                    self._get_timeline(key.rstrip("/"))
                elif path.startswith("/v1/jobs/") and \
                        path.endswith("/measurements"):
                    key = path[len("/v1/jobs/"):-len("/measurements")]
                    self._get_measurements(key.rstrip("/"))
                elif path.startswith("/v1/jobs/"):
                    self._get_job(path.rsplit("/", 1)[1], q)
                elif path == "/v1/stream":
                    self._get_stream(q)
                elif path == "/v1/pareto":
                    self._get_pareto(q)
                elif path.startswith("/v1/store/"):
                    self._get_store(path.rsplit("/", 1)[1])
                else:
                    self._bad(f"unknown path {path!r}", code=404)
        except (BrokenPipeError, ConnectionResetError):
            pass                                       # client went away
        except Exception as exc:                       # noqa: BLE001
            self.dse.bump("errors")
            self.dse.log.warning("GET %s failed: %r", path, exc)
            try:
                self._send_json(500, {"error": repr(exc)})
            except OSError:                            # pragma: no cover
                pass

    def do_POST(self) -> None:                         # noqa: N802
        self.dse.bump("requests")
        path, q = self._query()
        route = _route(path)
        _M_HTTP.inc(endpoint=route, method="POST")
        try:
            with obs.span("server.request", histogram=_M_HTTP_S.labels(
                    endpoint=route), endpoint=route, method="POST"):
                if path == "/v1/jobs":
                    self._post_jobs(q)
                else:
                    self._bad(f"unknown path {path!r}", code=404)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as exc:                       # noqa: BLE001
            self.dse.bump("errors")
            self.dse.log.warning("POST %s failed: %r", path, exc)
            try:
                self._send_json(500, {"error": repr(exc)})
            except OSError:                            # pragma: no cover
                pass

    # -- endpoints -------------------------------------------------- #
    def _read_body(self) -> typing.Any:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise ValueError("missing request body")
        if length > self.dse.config.max_body_bytes:
            raise ValueError(
                f"body of {length} bytes exceeds the "
                f"{self.dse.config.max_body_bytes}-byte cap")
        return json.loads(self.rfile.read(length).decode("utf-8"))

    def _post_jobs(self, q: dict[str, str]) -> None:
        try:
            payload = self._read_body()
        except (ValueError, UnicodeDecodeError) as exc:
            self._bad(f"bad request body: {exc}")
            return
        specs = payload if isinstance(payload, list) else [payload]
        if not specs or not all(isinstance(s, dict) for s in specs):
            self._bad("body must be a job-spec object or a non-empty "
                      "list of them")
            return
        # validate every spec before admitting ANY of them -- a typo'd
        # backend name must not leave half a batch running.  Per-job
        # backend settings (structured "search" form or the top-level
        # "settings" dict) are parsed onto ExploreJob.search_settings by
        # job_from_spec, so the queue resolves and keys them per job.
        parsed = []
        for i, spec in enumerate(specs):
            try:
                job, method = job_from_spec(spec)
                cands = spec.get("candidates")
                if cands is not None:
                    cands = np.asarray(cands, dtype=np.float64)
                    if cands.ndim != 2 or cands.shape[1] != 6:
                        raise ValueError(
                            f"candidates must be [C, 6] rows, got shape "
                            f"{cands.shape}")
                parsed.append((job, method, cands,
                               int(spec.get("priority", 0))))
            except _SPEC_ERRORS as exc:
                self._bad(f"bad job spec #{i}: {exc}")
                return
        svc = self.dse.client
        futs: list[ExploreFuture] = []
        # one POST is one batch: the queue's window opens after the last
        # spec is keyed and admitted
        with svc.queue.holding():
            for job, method, cands, priority in parsed:
                if cands is not None:
                    fut = svc.submit_values(job, cands, priority=priority)
                    self.dse.bump("values_posted")
                else:
                    fut = svc.submit(job, method, priority=priority)
                    self.dse.bump("jobs_posted")
                self.dse.register(fut)
                futs.append(fut)
        wait = self._wait_s(q)
        if wait:
            deadline = time.monotonic() + wait
            for fut in futs:
                fut.wait(max(0.0, deadline - time.monotonic()))
        states = [self.dse.job_state(f) for f in futs]
        self._send_json(200, {
            "jobs": states,
            "pending": sum(s["status"] == "pending" for s in states)})

    def _get_job(self, key: str, q: dict[str, str]) -> None:
        fut = self.dse.lookup(key)
        if fut is None:
            self._bad(f"unknown job key {key!r}", code=404)
            return
        wait = self._wait_s(q)
        if wait:
            fut.wait(wait)
        self._send_json(200, self.dse.job_state(fut))

    def _get_timeline(self, key: str) -> None:
        """Flight-recorder timeline of one job: the in-process recorder
        first (live or recently finished races), then the store's
        persisted sidecar (results from previous runs / other hosts)."""
        timeline = obs.flight_recorder().timeline(key)
        source = "live"
        if timeline is None:
            store = self.dse.client.store
            timeline = store.get_timeline(key) if store is not None \
                else None
            source = "store"
        if timeline is None:
            self._bad(f"no timeline for job {key!r}", code=404)
            return
        self._send_json(200, {"key": key, "source": source,
                              "timeline": timeline})

    def _get_calibration(self) -> None:
        """The process's active kernel calibration: source (pinned
        artifact / live fit / none), version, correction factors and fit
        diagnostics."""
        from repro_torch.core.calibration import calibration_record
        self._send_json(200, calibration_record())

    def _get_measurements(self, key: str) -> None:
        """The measurement records behind one measured-fidelity result,
        from the store's ``.measurements.json`` sidecar."""
        store = self.dse.client.store
        records = store.get_measurements(key) if store is not None \
            else None
        if records is None:
            self._bad(f"no measurements for job {key!r}", code=404)
            return
        self._send_json(200, {"key": key, "measurements": records})

    def _get_store(self, key: str) -> None:
        store = self.dse.client.store
        payload = store.get_raw(key) if store is not None else None
        if payload is None:
            # a read-through miss is normal fleet behaviour, not a bad
            # request -- don't pollute that counter
            self.dse.bump("store_get_misses")
            self._send_json(404, {"error": f"no stored result for {key!r}"})
            return
        self.dse.bump("store_get_hits")
        self._send_json(200, {"key": key, "result": payload})

    def _get_stream(self, q: dict[str, str]) -> None:
        keys = [k for k in q.get("keys", "").split(",") if k]
        if not keys:
            self._bad("stream needs ?keys=k1,k2,...")
            return
        try:
            timeout = float(q.get("timeout", "0")) or None
        except ValueError:
            timeout = None
        futs: list[ExploreFuture] = []
        unknown: list[str] = []
        for key in dict.fromkeys(keys):                # dedup, keep order
            fut = self.dse.lookup(key)
            if fut is None:
                unknown.append(key)
            else:
                futs.append(fut)
        if unknown:
            self._bad(f"unknown job keys {unknown}", code=404)
            return
        self.dse.bump("streams")
        self._sse_begin()
        # one queue interleaves final results and per-rung progress
        # events (portfolio races publish on the progress bus); the
        # atomic subscribe returns history for rungs that fired before
        # this stream attached, so POST-then-stream clients still see
        # the whole race, each event exactly once
        done_q: _queue.SimpleQueue = _queue.SimpleQueue()
        bus = obs.progress_bus()

        def _on_progress(_key: str, ev: dict) -> None:
            done_q.put(("progress", ev))

        history = bus.subscribe([f.key for f in futs], _on_progress)
        for fut in futs:
            fut.add_done_callback(lambda f: done_q.put(("result", f)))
        try:
            for ev in history:
                self._sse_event(ev, event="progress")
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            remaining = len(futs)
            while remaining:
                budget = self.dse.config.stream_ping_s
                if deadline is not None:
                    budget = min(budget, deadline - time.monotonic())
                    if budget <= 0:
                        self._sse_event({"remaining": remaining,
                                         "reason": "timeout"}, event="end")
                        return
                try:
                    kind, item = done_q.get(timeout=budget)
                except _queue.Empty:
                    self._sse_ping()
                    continue
                if kind == "progress":
                    self._sse_event(item, event="progress")
                    continue
                self._sse_event(self.dse.job_state(item), event="result")
                remaining -= 1
            self._sse_event({"remaining": 0}, event="end")
        finally:
            bus.unsubscribe(_on_progress)

    def _get_pareto(self, q: dict[str, str]) -> None:
        from repro_torch.core.macro import get_macro
        from repro_torch.service.client import _workload_from_spec
        try:
            macro = get_macro(q["macro"])
            budget = float(q["area_budget_mm2"])
            names = [w for w in q.get("workloads", "").split(",") if w]
            if not names:
                raise KeyError("workloads")
            seq = int(q.get("seq", "512"))
            workloads = [_workload_from_spec({"name": n, "seq": seq})
                         for n in names]
            bw = int(q.get("bw", "256"))
            strategy_set = q.get("strategy_set", "st")
        except _SPEC_ERRORS as exc:
            self._bad(f"bad pareto query: {exc}")
            return
        try:
            timeout = float(q.get("timeout", "0")) or None
        except ValueError:
            timeout = None
        self._sse_begin()
        count = 0
        try:
            for name, frontier in stream_pareto(
                    macro, workloads, budget, service=self.dse.client,
                    strategy_set=strategy_set, bw=bw, timeout=timeout):
                self._sse_event({
                    "workload": name,
                    "frontier": [{
                        "config": dataclasses.asdict(pt["config"]),
                        "gops": pt["gops"], "tops_w": pt["tops_w"],
                    } for pt in frontier],
                }, event="frontier")
                count += 1
        except Exception as exc:                       # noqa: BLE001
            self._sse_event({"error": repr(exc)}, event="error")
        self._sse_event({"remaining": len(workloads) - count}, event="end")
