"""Programmatic client of the port's DSE service + process-wide defaults.

``ServiceClient`` wraps a :class:`~repro_torch.service.queue.JobQueue` with the
call shapes consumers actually want: blocking ``explore`` (what the
``co_explore`` family delegates to), streaming ``explore(..., stream=True)``
(yields ``(meta, result)`` the moment each micro-batch bucket finishes), and
dict-based job specs so the CLI / JSON job files share one parser.

``ServiceClient(base_url=...)`` switches to **remote mode**: submissions go
over HTTP to a ``python -m repro_torch.service serve`` front door
(``repro_torch.service.server``) instead of an in-process queue.  Jobs are shipped as the same JSON specs the
CLI reads (:func:`job_to_spec` inlines macros/tech/ops so arbitrary
in-memory jobs survive the wire bit-for-bit), results stream back over SSE
in completion order, and a read-through store tier
(:class:`~repro_torch.service.store.RemoteStoreTier`) answers repeats from the
local disk cache first, then the server's shared store, before ever
submitting.

:func:`default_service` is the process-wide instance (one per device and
dtype, as :func:`~repro_torch.core.engine.default_engine` keeps one engine
each) the blocking wrappers in ``core/explorer.py`` use -- interleaved
callers (tests, notebooks, sweeps) therefore share one queue, one engine
and one persistent result store.  When ``CIM_TUNER_SERVICE_URL`` is set it
becomes a remote client of that server, so every ``co_explore`` /
``pareto_explore`` call in the process rides the shared front door with
zero code changes.

No fallback hides the device: a remote client first reads the server's
``/healthz``, and fails with an error naming the URL when no port server
answers there (a reference server does not name the port), when the
server works in another dtype, or when it runs on another kind of device
than the caller asked for.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
import threading
import typing
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch

from repro_torch.core.annealing import SASettings
from repro_torch.core.calibration import TechConstants, resolve_tech
from repro_torch.core.engine import (
    PORT_TAG,
    ExplorationEngine,
    ExploreJob,
    clone_result,
    resolve_device,
    valid_methods,
)
from repro_torch.core.ir import MatmulOp, Workload, bert_large_workload
from repro_torch.core.macro import MacroSpec, get_macro
from repro_torch.core.pruning import DesignSpace
from repro_torch.search.base import get_backend
from repro_torch.service.queue import (
    JobQueue,
    QueueConfig,
    _normalize_submit_args,
    _tag_job_exc,
    values_key,
)
from repro_torch.service.store import (
    RemoteStoreTier,
    ResultStore,
    default_store,
    deserialize_result,
)
from repro_torch.service.streams import ExploreFuture, stream_results

__all__ = ["ServiceClient", "RemoteQueue", "default_service",
           "reset_default_service", "job_from_spec", "job_to_spec",
           "settings_from_spec", "settings_to_spec",
           "merge_spec_settings"]

#: environment variable that points every default-service consumer
#: (``co_explore`` & friends, the CLI) at a running ``serve`` front door
#: (the reference reads it too; a reference server there is refused)
SERVICE_URL_ENV = "CIM_TUNER_SERVICE_URL"

_SPACE_AXES = ("mr", "mc", "scr", "is_kb", "os_kb")


# --------------------------------------------------------------------- #
# JSON job specs (CLI + programmatic + the remote wire format)
# --------------------------------------------------------------------- #
def _op_from_spec(i: int, o) -> MatmulOp:
    if isinstance(o, dict):
        return MatmulOp(
            m=int(o["m"]), k=int(o["k"]), n=int(o["n"]),
            count=int(o.get("count", 1)),
            weights_static=bool(o.get("weights_static", True)),
            name=str(o.get("name", f"op{i}")))
    return MatmulOp(m=o[0], k=o[1], n=o[2],
                    count=o[3] if len(o) > 3 else 1,
                    name=str(o[4]) if len(o) > 4 else f"op{i}")


def _workload_from_spec(spec) -> Workload:
    if isinstance(spec, dict) and "ops" in spec:
        ops = tuple(_op_from_spec(i, o) for i, o in enumerate(spec["ops"]))
        return Workload(spec.get("name", "custom"), ops)
    name = spec["name"] if isinstance(spec, dict) else str(spec)
    seq = spec.get("seq", 512) if isinstance(spec, dict) else 512
    if name == "bert-large":
        return bert_large_workload(seq)
    from repro_torch.configs import get_arch
    return get_arch(name).workload(seq=seq)


def _parse_search_spec(spec: dict) -> tuple[str, dict | None]:
    """``(method, settings-field-dict-or-None)`` from a job record's
    search keys.  ``"search"`` is either a backend-name string (legacy)
    or the structured form ``{"method": ..., "settings": {...},
    "allocator": "bandit"|"halving"}`` -- ``allocator`` is sugar for the
    portfolio's settings field of the same name.  A top-level
    ``"settings"`` dict (the original spelling) is still honoured, but
    giving settings in both places is ambiguous and rejected."""
    search = spec.get("search", spec.get("method", "sa"))
    top_settings = spec.get("settings")
    if isinstance(search, dict):
        unknown = set(search) - {"method", "settings", "allocator"}
        if unknown:
            raise ValueError(
                f"unknown 'search' keys {sorted(unknown)}; valid: "
                f"['method', 'settings', 'allocator']")
        method = search.get("method", "sa")
        settings_d = search.get("settings")
        if settings_d is not None and top_settings is not None:
            raise ValueError(
                "settings given both top-level and inside 'search' -- "
                "pick one spelling")
        settings_d = settings_d if settings_d is not None else top_settings
        allocator = search.get("allocator")
        if allocator is not None:
            settings_d = {**(settings_d or {}), "allocator": allocator}
    else:
        method, settings_d = search, top_settings
    if not isinstance(method, str) or method not in valid_methods():
        raise ValueError(
            f"unknown search {method!r}; valid: {sorted(valid_methods())}")
    return method, settings_d


def job_from_spec(spec: dict) -> tuple[ExploreJob, str]:
    """``(ExploreJob, method)`` from one JSON job record.

    Minimal record::

        {"macro": "vanilla-dcim", "workload": "bert-large",
         "area_budget_mm2": 5.0}

    Optional keys: ``objective`` ("ee"|"th"|"edp"), ``strategy_set``
    ("st"|"so"), ``bw``, ``seq`` (inside workload dict), ``search`` --
    any registered ``repro_torch.search`` backend ("sa", "genetic",
    "evolution", "sobol", "portfolio", ...) or "exhaustive" as a plain
    string (``method`` is the legacy spelling), or the structured form
    ``{"method": "portfolio", "settings": {...}, "allocator": "bandit"}``
    carrying per-job backend settings (see :func:`_parse_search_spec`);
    ``settings`` (top-level backend settings fields, the original
    spelling), ``space`` (axis-name -> value list), ``merge_ops``, inline
    workloads via ``{"workload": {"name": ..., "ops": [[m,k,n,count],
    ...]}}`` (ops may also be field dicts), inline macros via
    ``{"macro": {<MacroSpec fields>}}``, and ``tech`` (TechConstants
    fields) -- the inline forms are what the remote client emits so any
    in-memory job round-trips the wire with its canonical key intact.
    Parsed settings land on ``ExploreJob.search_settings``, so they ride
    the job through every queue/engine layer and fold into ``job_key``.
    """
    space = None
    if "space" in spec:
        axes = {k: tuple(v) for k, v in spec["space"].items()}
        for k, v in axes.items():
            if not v:
                raise ValueError(f"space axis {k!r} must be non-empty")
        space = DesignSpace(**axes)
    method, settings_d = _parse_search_spec(spec)
    settings = settings_from_spec(method, settings_d)  # raises on bad fields
    macro = spec["macro"]
    macro = MacroSpec(**macro) if isinstance(macro, dict) else \
        get_macro(macro)
    tech = TechConstants(**spec["tech"]) if "tech" in spec else resolve_tech()
    job = ExploreJob(
        macro=macro,
        workload=_workload_from_spec(spec["workload"]),
        area_budget_mm2=float(spec["area_budget_mm2"]),
        objective=spec.get("objective", "ee"),
        strategy_set=spec.get("strategy_set", "st"),
        bw=int(spec.get("bw", 256)),
        tech=tech,
        space=space,
        merge_ops=bool(spec.get("merge_ops", True)),
        search_method=method,
        search_settings=settings,
    )
    return job, method


def job_to_spec(job: ExploreJob, method: str | None = None,
                settings=None) -> dict:
    """Inverse of :func:`job_from_spec` for arbitrary in-memory jobs (the
    remote client's wire format).  Macro and tech constants are inlined as
    full dataclass dicts and every op keeps its name, so
    :func:`repro_torch.core.engine.job_key` of the round-tripped job matches the
    original bit-for-bit -- cross-host store sharing depends on it.
    ``settings`` (default: the job's own ``search_settings``) emits the
    structured ``"search": {"method": ..., "settings": {...}}`` form so
    per-job backend settings survive the wire too."""
    space = job.design_space()
    method = method or job.search_method
    if settings is None:
        settings = job.search_settings
    search: dict | str = method
    if settings is not None:
        search = {"method": method, "settings": settings_to_spec(settings)}
    return {
        "macro": dataclasses.asdict(job.macro),
        "workload": {
            "name": job.workload.name,
            "ops": [dataclasses.asdict(op) for op in job.workload.ops],
        },
        "area_budget_mm2": job.area_budget_mm2,
        "objective": job.objective,
        "strategy_set": job.strategy_set,
        "bw": job.bw,
        "tech": dataclasses.asdict(job.tech),
        "space": {k: list(v) for k, v in zip(_SPACE_AXES, space.axes())},
        "merge_ops": job.merge_ops,
        "search": search,
    }


def merge_spec_settings(spec: dict, override: dict) -> dict:
    """A copy of ``spec`` with ``override`` merged over its backend
    settings (whichever spelling the spec used) -- what the CLI's
    ``--search-settings`` flag applies to every record of a jobs file.
    A spec carrying settings in BOTH spellings is as ambiguous here as it
    is to :func:`job_from_spec`, and rejected the same way."""
    out = dict(spec)
    search = out.get("search")
    if isinstance(search, dict):
        search = dict(search)
        if search.get("settings") is not None and \
                out.get("settings") is not None:
            raise ValueError(
                "settings given both top-level and inside 'search' -- "
                "pick one spelling")
        if "allocator" in override:      # the override wins over the sugar
            search.pop("allocator", None)
        search["settings"] = {**(search.get("settings") or {}),
                              **(out.pop("settings", None) or {}),
                              **override}
        out["search"] = search
    else:
        out["settings"] = {**(out.get("settings") or {}), **override}
    return out


def settings_to_spec(settings) -> dict | None:
    """Backend settings dataclass -> JSON-able field dict (``None`` stays
    ``None`` -- exhaustive / server-side defaults)."""
    return None if settings is None else dataclasses.asdict(settings)


def settings_from_spec(method: str, d: dict | None):
    """Field dict -> the backend's settings dataclass (lists become tuples
    so the reconstructed object is hashable: settings key the engine's and
    the queue's batch groups).
    ``None`` means "use the backend's defaults server-side"."""
    if d is None or method == "exhaustive":
        return None
    cls = get_backend(method).settings_cls
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} fields {sorted(unknown)}; "
            f"valid: {sorted(names)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items()})


# --------------------------------------------------------------------- #
# remote mode: HTTP client of repro_torch.service.server
# --------------------------------------------------------------------- #
def _read_sse(resp) -> typing.Iterator[tuple[str | None, dict]]:
    """Minimal SSE reader: yields ``(event, parsed-json-data)`` records."""
    event: str | None = None
    data: list[str] = []
    for raw in resp:
        line = raw.decode("utf-8").rstrip("\r\n")
        if not line:
            if data:
                yield event, json.loads("".join(data))
            event, data = None, []
        elif line.startswith(":"):
            continue                                   # keep-alive ping
        elif line.startswith("event:"):
            event = line[len("event:"):].strip()
        elif line.startswith("data:"):
            data.append(line[len("data:"):].strip())


def _dtype_named(name: str) -> torch.dtype:
    """``"torch.float64"`` -> ``torch.float64`` (the ``/healthz`` field)."""
    dtype = getattr(torch, str(name).rsplit(".", 1)[-1], None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


class RemoteQueue:
    """Drop-in ``JobQueue`` replacement that talks to a ``python -m
    repro_torch.service serve`` front door over HTTP.

    Construction reads the server's ``/healthz`` (bounded by
    ``timeout_s`` and at most 30 s) and refuses anything but a port
    server: no answer, or an answer that does not name the port (a
    reference server), raises ``ConnectionError`` naming the URL.  Job
    keys are computed in the server's dtype; a caller that names a
    ``device`` or ``dtype`` gets a ``ValueError`` when the server runs on
    another kind of device or in another dtype.

    Admission tiers mirror the local queue: **local store -> remote store
    (read-through GET) -> POST /v1/jobs**.  Posted jobs resolve through one
    ``GET /v1/stream`` SSE connection per submission batch, so futures
    complete in the server's per-bucket completion order exactly like
    in-process callers.  Engine results arriving over the wire are written
    into the local store tier, so the next identical query on this host is
    answered without any network traffic at all.

    Batches larger than :attr:`REMOTE_PROBE_MAX_JOBS` skip the per-job
    remote GET (each cold probe is a full round-trip) and go local-tier ->
    POST directly; the server still answers warm keys inline from the
    shared store at admission, so nothing is recomputed either way.
    """

    #: largest submission batch that still probes the remote store tier
    #: per job before POSTing
    REMOTE_PROBE_MAX_JOBS = 4

    def __init__(
        self,
        base_url: str,
        store: ResultStore | None | str = "auto",
        timeout_s: float = 600.0,
        *,
        device=None,
        dtype: torch.dtype | None = None,
    ):
        """Connect to the front door at ``base_url`` (scheme optional).

        ``store`` is the local read-through tier (``"auto"`` resolves via
        :func:`repro_torch.service.store.default_store`, honouring
        ``CIM_TUNER_RESULT_STORE`` / ``CIM_TUNER_DISABLE_RESULT_STORE``;
        ``None`` disables local caching); ``timeout_s`` bounds how long a
        posted batch's SSE stream may stay open.  ``device`` / ``dtype``,
        when given, must match the server's (see the class docstring).
        """
        if "://" not in base_url:
            base_url = "http://" + base_url
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.server = self._healthz()
        self.dtype = _dtype_named(self.server["dtype"])
        served = self.server["device_type"]
        if device is not None and torch.device(device).type != served:
            raise ValueError(
                f"DSE server {self.base_url} runs on {served} "
                f"({self.server['device']}), not the requested "
                f"{device!r}")
        if dtype is not None and dtype != self.dtype:
            raise ValueError(
                f"DSE server {self.base_url} works in {self.dtype}, not "
                f"the requested {dtype}")
        local = default_store() if store == "auto" else store
        self.store = RemoteStoreTier(self.base_url, local=local)
        self.stats = {"submitted": 0, "store_hits": 0, "remote_store_hits": 0,
                      "posted": 0, "completed": 0, "failed": 0}
        self._lock = threading.Lock()
        self._streamers: list[threading.Thread] = []
        self._closed = False

    def _bump(self, counter: str) -> None:
        """Locked counter increment (submissions and streamer threads
        mutate the same stats dict concurrently)."""
        with self._lock:
            self.stats[counter] += 1

    # ------------------------------------------------------------- #
    # submission API (JobQueue-compatible surface)
    # ------------------------------------------------------------- #
    def submit(self, job: ExploreJob, method: str | None = None,
               sa_settings: SASettings | None = None, priority: int = 0,
               meta=None, settings=None,
               fidelity: str | None = None) -> ExploreFuture:
        """Admit one job (a batch of one through :meth:`submit_many`)."""
        return self.submit_many([job], method, sa_settings, priority,
                                metas=[meta], settings=settings,
                                fidelity=fidelity)[0]

    def submit_many(
        self,
        jobs: typing.Sequence[ExploreJob],
        method: str | None = None,
        sa_settings: SASettings | None = None,
        priority: int = 0,
        metas: typing.Sequence | None = None,
        settings=None,
        fidelity: str | None = None,
    ) -> list[ExploreFuture]:
        """Admit a job batch; returns one future per job immediately.

        Same surface as :meth:`JobQueue.submit_many`: ``method=None``
        uses each job's own ``search_method``; ``settings=None`` resolves
        per job (``job.search_settings``, then backend defaults) and the
        RESOLVED settings ship over the wire, so the server keys every
        job exactly as this client just did.
        """
        metas = metas if metas is not None else [None] * len(jobs)
        if len(metas) != len(jobs):
            raise ValueError(
                f"metas length {len(metas)} != jobs length {len(jobs)}")
        if self._closed:
            raise RuntimeError("remote service client is closed")
        futures: list[ExploreFuture] = []
        post_specs: list[dict] = []
        post_futs: list[ExploreFuture] = []
        # the read-through chain (local -> remote GET -> submit) costs one
        # synchronous round-trip per COLD job; past a few jobs the batched
        # POST is strictly cheaper, because the server answers warm keys
        # inline from the same store at admission anyway
        probe_remote = len(jobs) <= self.REMOTE_PROBE_MAX_JOBS
        for job, meta in zip(jobs, metas):
            # the one shared submit contract (repro_torch.service.queue):
            # the canonical key computed here matches the server's exactly
            m, eff, key = _normalize_submit_args(
                job, method, settings, sa_settings, fidelity,
                dtype=self.dtype)
            fut = ExploreFuture(job, m, key, meta=meta)
            futures.append(fut)
            self._bump("submitted")
            cached = self.store.get(key) if probe_remote else (
                self.store.local.get(key)
                if self.store.local is not None else None)
            if cached is not None:
                tier = cached.search.get("cache")
                self._bump("remote_store_hits" if tier == "remote-store"
                           else "store_hits")
                fut._finish(cached, source="store")
                continue
            # ship the RESOLVED settings (structured "search" form), so
            # the server's queue keys the job exactly like we just did
            spec = job_to_spec(job, m, settings=eff)
            if priority:
                spec["priority"] = int(priority)
            post_specs.append(spec)
            post_futs.append(fut)
        if post_specs:
            self._post_jobs(post_specs, post_futs)
        return futures

    def submit_values(self, job: ExploreJob, candidates, priority: int = 0,
                      meta=None) -> ExploreFuture:
        """Remote candidate sweep (the Pareto path); resolves to the ``[C]``
        objective-value array computed server-side."""
        if self._closed:
            raise RuntimeError("remote service client is closed")
        rows = np.asarray(candidates, dtype=np.float64)
        fut = ExploreFuture(job, "values", values_key(job, rows, self.dtype),
                            meta=meta)
        self._bump("submitted")
        spec = job_to_spec(job, "exhaustive")
        spec["candidates"] = rows.tolist()
        if priority:
            spec["priority"] = int(priority)
        self._post_jobs([spec], [fut])
        return fut

    def run_sync(self, jobs, method=None, sa_settings=None,
                 timeout: float | None = None, settings=None,
                 fidelity: str | None = None):
        """Blocking batch call: submit, then wait for every result in
        submission order (the remote analogue of ``JobQueue.run_sync``).
        """
        futures = self.submit_many(jobs, method, sa_settings,
                                   settings=settings, fidelity=fidelity)
        return [f.result(timeout) for f in futures]

    # ------------------------------------------------------------- #
    # introspection / lifecycle
    # ------------------------------------------------------------- #
    def depth(self) -> dict:
        """Client-side depth view: live SSE streamer threads (the server
        owns the real queue depth -- see :meth:`stats_snapshot`)."""
        with self._lock:
            live = sum(t.is_alive() for t in self._streamers)
        return {"pending": 0, "inflight": live}

    def stats_snapshot(self) -> dict:
        """Server-side ``/v1/stats`` merged with this client's counters."""
        snap = self._get_json("/v1/stats")
        snap["client"] = {**self.stats, "store": dict(self.store.stats)}
        return snap

    def close(self, timeout: float | None = 10.0) -> None:
        """Refuse new submissions and join the live SSE streamers (the
        server keeps running; only this client's connections drain)."""
        self._closed = True
        with self._lock:
            streamers = list(self._streamers)
        for t in streamers:
            t.join(timeout)

    def __enter__(self):
        """Context-manager support: ``with RemoteQueue(url) as q:``."""
        return self

    def __exit__(self, *exc):
        """Close on context exit (see :meth:`close`)."""
        self.close()

    # ------------------------------------------------------------- #
    # wire internals
    # ------------------------------------------------------------- #
    def _healthz(self) -> dict:
        """The server's ``/healthz`` record, or ``ConnectionError`` naming
        the URL when no port server answers there."""
        url = f"{self.base_url}/healthz"
        try:
            with urllib.request.urlopen(
                    url, timeout=min(self.timeout_s, 30.0)) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
        except (OSError, ValueError) as exc:
            raise ConnectionError(
                f"no port DSE server at {self.base_url}: GET {url} failed: "
                f"{exc!r}") from exc
        if not isinstance(doc, dict) or doc.get("port") != PORT_TAG:
            raise ConnectionError(
                f"{self.base_url} is not a port DSE server: its /healthz "
                f"does not name the {PORT_TAG!r} port (a reference "
                f"server?): {doc!r}")
        return doc

    def _get_json(self, path: str) -> dict:
        with urllib.request.urlopen(self.base_url + path,
                                    timeout=30.0) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _post_jobs(self, specs: list[dict],
                   futures: list[ExploreFuture]) -> None:
        req = urllib.request.Request(
            self.base_url + "/v1/jobs",
            data=json.dumps(specs).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60.0) as resp:
                out = json.loads(resp.read().decode("utf-8"))
            states = out["jobs"]
            if len(states) != len(futures):
                raise ValueError(
                    f"server answered {len(states)} states for "
                    f"{len(futures)} jobs")
        except Exception as exc:                       # noqa: BLE001
            err = self._wire_error(exc)
            for fut in futures:
                self._fail(fut, err)
            return
        with self._lock:
            self.stats["posted"] += len(specs)
        pending: dict[str, list[ExploreFuture]] = {}
        for state, fut in zip(states, futures):
            if state.get("status") in ("done", "failed"):
                self._resolve_safe(fut, state)
            else:
                pending.setdefault(state["key"], []).append(fut)
        if pending:
            t = threading.Thread(target=self._stream_worker, args=(pending,),
                                 name="cim-tuner-remote-stream", daemon=True)
            with self._lock:
                # prune finished streamers so a long-lived client doesn't
                # accumulate one dead Thread per submission batch
                self._streamers = [x for x in self._streamers
                                   if x.is_alive()]
                self._streamers.append(t)
            t.start()

    def _stream_worker(self, pending: dict[str, list[ExploreFuture]]) -> None:
        query = urllib.parse.urlencode(
            {"keys": ",".join(pending), "timeout": f"{self.timeout_s:g}"})
        url = f"{self.base_url}/v1/stream?{query}"
        err: BaseException | None = None
        try:
            with urllib.request.urlopen(url, timeout=120.0) as resp:
                for event, obj in _read_sse(resp):
                    if event == "result":
                        for i, fut in enumerate(pending.pop(obj["key"], ())):
                            self._resolve_safe(fut, obj, fan_out=i > 0)
                    elif event == "end":
                        break
                    if not pending:
                        break
        except Exception as exc:                       # noqa: BLE001
            err = self._wire_error(exc)
        if pending:
            # the stream ended (server timeout event, clean EOF, or wire
            # error) with futures unresolved -- fail them rather than
            # leaving callers blocked forever
            if err is None:
                err = TimeoutError(
                    f"DSE server {self.base_url} stream ended with "
                    f"{len(pending)} job(s) unresolved")
            for futs in pending.values():
                for fut in futs:
                    self._fail(fut, err)

    def _resolve_safe(self, fut: ExploreFuture, state: dict,
                      fan_out: bool = False) -> None:
        """A malformed/incompatible server payload must FAIL the future,
        never abandon it (the caller may be blocked with timeout=None)."""
        try:
            self._resolve(fut, state, fan_out=fan_out)
        except Exception as exc:                       # noqa: BLE001
            self._fail(fut, ValueError(
                f"undecodable server response for job: {exc!r}"))

    def _resolve(self, fut: ExploreFuture, state: dict,
                 fan_out: bool = False) -> None:
        status = state.get("status")
        if status == "failed":
            exc: BaseException = RuntimeError(
                f"remote job failed ({state.get('error_type', 'Error')}): "
                f"{state.get('error', 'unknown error')}")
            self._fail(fut, exc)
            return
        source = state.get("source") or "engine"
        if "values" in state:
            fut._finish(np.asarray(state["values"], dtype=np.float64),
                        source=source)
        else:
            result = deserialize_result(state["result"])
            result.search["remote"] = True
            if fan_out:
                result = clone_result(result)
            # read-through: engine answers computed server-side become
            # local-tier records, so this host's next identical query
            # never touches the network
            self.store.put(fut.key, result)
            fut._finish(result, source=source)
        self._bump("completed")

    def _fail(self, fut: ExploreFuture, exc: BaseException) -> None:
        # per-future copy tagged with ITS key (one wire error can fail a
        # whole batch; sharing the object would stamp every future with
        # the first one's job_key)
        self._bump("failed")
        fut._finish(exc=_tag_job_exc(exc, fut.key), source="remote")

    def _wire_error(self, exc: Exception) -> BaseException:
        if isinstance(exc, urllib.error.HTTPError):
            try:
                detail = exc.read().decode("utf-8", "replace")[:500]
            except Exception:                          # noqa: BLE001
                detail = ""
            return ConnectionError(
                f"DSE server {self.base_url} answered HTTP {exc.code}: "
                f"{detail}")
        return ConnectionError(
            f"DSE server {self.base_url} unreachable: {exc!r}")


# --------------------------------------------------------------------- #
# the client
# --------------------------------------------------------------------- #
class ServiceClient:
    """Convenience facade over one :class:`JobQueue` (in-process) or one
    :class:`RemoteQueue` (``base_url=`` / ``CIM_TUNER_SERVICE_URL``)."""

    def __init__(
        self,
        queue: JobQueue | RemoteQueue | None = None,
        engine: ExplorationEngine | None = None,
        store="auto",
        config: QueueConfig = QueueConfig(),
        base_url: str | None = None,
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        """Wrap an explicit ``queue``, or build one: ``base_url=`` makes
        a :class:`RemoteQueue` (remote mode, held to ``device`` and
        ``dtype``), otherwise an in-process :class:`JobQueue` over
        ``engine`` (``None`` = the process-wide default engine for
        ``device`` and ``dtype``) with the given ``store``/``config``."""
        if queue is not None:
            self.queue: JobQueue | RemoteQueue = queue
        elif base_url:
            self.queue = RemoteQueue(base_url, store=store, device=device,
                                     dtype=dtype)
        else:
            self.queue = JobQueue(engine=engine, store=store, config=config,
                                  device=device, dtype=dtype)

    @property
    def remote(self) -> bool:
        """True when submissions go over HTTP to a serve front door."""
        return isinstance(self.queue, RemoteQueue)

    # passthroughs --------------------------------------------------- #
    def submit(self, job: ExploreJob, method: str | None = None,
               sa_settings: SASettings | None = None, priority: int = 0,
               meta=None, settings=None,
               fidelity: str | None = None) -> ExploreFuture:
        """Admit one job (see :meth:`JobQueue.submit`); per-job
        ``job.search_settings`` apply when ``settings`` is ``None``."""
        return self.queue.submit(job, method, sa_settings, priority, meta,
                                 settings=settings, fidelity=fidelity)

    def submit_many(self, jobs, method=None, sa_settings=None,
                    priority=0, metas=None, settings=None,
                    fidelity: str | None = None) -> list[ExploreFuture]:
        """Admit a job batch (see :meth:`JobQueue.submit_many`)."""
        return self.queue.submit_many(jobs, method, sa_settings, priority,
                                      metas, settings=settings,
                                      fidelity=fidelity)

    def submit_values(self, job, candidates, priority=0, meta=None):
        """Admit a ``[C, 6]`` candidate sweep; the future resolves to the
        ``[C]`` objective-value array (the Pareto path)."""
        return self.queue.submit_values(job, candidates, priority, meta)

    @property
    def stats(self) -> dict:
        """The underlying queue's counter dict (live, not a snapshot)."""
        return self.queue.stats

    @property
    def store(self):
        """The queue's result-store tier (``None`` when caching is off)."""
        return self.queue.store

    def stats_snapshot(self) -> dict:
        """Full counter view: the server's ``/v1/stats`` in remote mode,
        the local queue/store/engine snapshot otherwise."""
        return self.queue.stats_snapshot()

    # blocking / streaming ------------------------------------------- #
    def explore(
        self,
        jobs: typing.Sequence[ExploreJob],
        method: str | None = None,
        sa_settings: SASettings | None = None,
        stream: bool = False,
        metas: typing.Sequence | None = None,
        timeout: float | None = None,
        settings=None,
        fidelity: str | None = None,
    ):
        """Run a job list through the service.

        ``stream=False`` (default): blocking, returns results in
        submission order.  ``stream=True``: returns an iterator of
        ``(meta, result)`` in *completion* order -- metas default to the
        submission index.  ``method=None`` uses each job's own
        ``search_method``.
        """
        if metas is None:
            metas = list(range(len(jobs)))
        futures = self.submit_many(jobs, method, sa_settings, metas=metas,
                                   settings=settings, fidelity=fidelity)
        if stream:
            return stream_results(futures, timeout=timeout)
        return [f.result(timeout) for f in futures]

    def explore_specs(self, specs: typing.Sequence[dict],
                      stream: bool = False, timeout: float | None = None):
        """Dict-spec variant (the CLI path).  Each spec's method AND
        backend settings ride the parsed job itself
        (``ExploreJob.search_method`` / ``.search_settings``), so the
        whole file is ONE ``submit_many`` batch regardless of how
        heterogeneous it is -- a remote client ships one POST + one SSE
        stream, and the server stacks every (bucket, method, settings)
        group into shared micro-batch dispatches."""
        jobs = [job_from_spec(spec)[0] for spec in specs]
        futures = self.submit_many(jobs, metas=list(range(len(specs))))
        if stream:
            return stream_results(futures, timeout=timeout)
        return [f.result(timeout) for f in futures]

    def close(self) -> None:
        """Drain and stop the underlying queue (in-process: waits for
        pending micro-batches; remote: joins live streams)."""
        self.queue.close()


# --------------------------------------------------------------------- #
# process-wide default services (one per device and dtype)
# --------------------------------------------------------------------- #
_default_services: dict[tuple, ServiceClient] = {}
_default_lock = threading.Lock()
_atexit_registered = False


def default_service(device="cuda",
                    dtype: torch.dtype = torch.float32) -> ServiceClient:
    """The shared always-on service for ``device`` and ``dtype`` (lazy;
    its worker thread starts on first submission, drained at interpreter
    exit).  With ``CIM_TUNER_SERVICE_URL`` set this is a remote client of
    that front door instead of an in-process queue -- every blocking
    wrapper in the process shares the fleet-wide engine and store -- held
    to the same device kind and dtype; with it unset, ``cuda`` on a host
    without a card raises."""
    global _atexit_registered
    url = os.environ.get(SERVICE_URL_ENV) or None
    # a remote client needs no local card: key it by what was asked for
    dev = torch.device(device) if url else resolve_device(device)
    key = (url, str(dev), dtype)
    with _default_lock:
        svc = _default_services.get(key)
        if svc is None:
            svc = ServiceClient(base_url=url, device=dev, dtype=dtype)
            _default_services[key] = svc
            if not _atexit_registered:
                atexit.register(_shutdown_default)
                _atexit_registered = True
        return svc


def _shutdown_default() -> None:
    with _default_lock:
        services = list(_default_services.values())
        _default_services.clear()
    for svc in services:
        svc.close()


def reset_default_service() -> None:
    """Tear down every shared service (tests / store or URL
    re-pointing)."""
    _shutdown_default()
