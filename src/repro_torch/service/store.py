"""The port's persistent on-disk result store, content-addressed by
canonical job key.

Repeated queries across processes -- CI runs, benchmark re-runs, notebook
users -- hit this cache instead of re-annealing.  Layout: one JSONL record
per result at ``<root>/<key[:2]>/<key>.jsonl``, written to a temp file and
moved into place with ``os.replace`` so concurrent writers (parallel CI
shards, several notebooks) can never expose a torn record.

The key already folds in everything that determines the answer bit-for-bit
(job ingredients, search method, backend settings, working dtype, the
port's tag and a schema version -- see
:func:`repro_torch.core.engine.job_key`), so ``get`` is a pure content
lookup.  Corrupt or schema-mismatched records read as misses.

Hygiene: records older than ``CIM_TUNER_RESULT_STORE_TTL`` seconds expire
on read, and every ``put`` enforces ``CIM_TUNER_RESULT_STORE_MAX_MB`` by
evicting the least-recently-*used* records first (``get`` touches a hit's
mtime, so hot entries survive).  Both limits default to off.  Expired or
evicted entries simply read as misses -- the caller falls back to the
engine and the record is re-written.

The port keeps its records in a ``repro_torch/`` subdirectory of the root
the reference's store would use (:data:`PORT_DIR`).  The two packages'
keys never collide, but one shared directory would let either package's
``store --clear``, size cap or LRU eviction delete the other's records;
the reference never looks inside a subdirectory of a shard name, and the
port never looks outside its own.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import ExploreResult
from repro_torch.core.macro import MacroSpec
from repro_torch.core.template import AcceleratorConfig

__all__ = ["ResultStore", "RemoteStoreTier", "default_store",
           "serialize_result", "deserialize_result", "STORE_SCHEMA",
           "PORT_DIR"]

#: one family covers both tiers: ``tier="local"`` is the on-disk store,
#: ``tier="remote"`` the read-through client tier
_M_OPS = obs.registry().counter(
    "cim_store_ops_total", "Result-store operations by tier and outcome",
    ("tier", "op"))

#: bump together with ``engine.JOB_KEY_SCHEMA`` when the serialized result
#: layout changes shape
STORE_SCHEMA = 1
#: the port's subdirectory of the reference's store root
PORT_DIR = "repro_torch"


def _to_py(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().tolist()
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _to_py(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_py(x) for x in v]
    return v


def serialize_result(r: ExploreResult) -> dict:
    """JSON-able record of an ExploreResult.  The search diagnostics
    (``sa``, the port's ``SearchResult`` of device tensors) are
    deliberately dropped (they are diagnostics, not the answer); every
    other value becomes a Python number, list or dict, and floats keep
    every bit through JSON.  Rehydrated results carry ``sa=None``."""
    return {
        "config": dataclasses.asdict(r.config),
        "macro": dataclasses.asdict(r.macro),
        "workload": r.workload,
        "objective": r.objective,
        "strategy_set": r.strategy_set,
        "per_op_strategy": dict(r.per_op_strategy),
        "metrics": _to_py(r.metrics),
        "search": _to_py(r.search),
    }


def deserialize_result(rec: dict) -> ExploreResult:
    """Rehydrate a :func:`serialize_result` record (``sa`` diagnostics
    were dropped at serialization time, so they come back ``None``)."""
    return ExploreResult(
        config=AcceleratorConfig(**rec["config"]),
        macro=MacroSpec(**rec["macro"]),
        workload=rec["workload"],
        objective=rec["objective"],
        strategy_set=rec["strategy_set"],
        per_op_strategy=dict(rec["per_op_strategy"]),
        metrics=dict(rec["metrics"]),
        search=dict(rec["search"]),
        sa=None,
    )


def _limit_from_env(var: str) -> float | None:
    raw = os.environ.get(var)
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        return None
    return val if val > 0 else None


class ResultStore:
    """Content-addressed persistent cache of ExploreResults.

    ``ttl_s`` / ``max_mb`` default to the ``CIM_TUNER_RESULT_STORE_TTL``
    (seconds) and ``CIM_TUNER_RESULT_STORE_MAX_MB`` environment variables;
    pass explicit numbers to override, or ``None``-producing env state to
    run uncapped.
    """

    _ENV = object()                    # sentinel: read limits from env

    def __init__(self, root: str | None = None, ttl_s=_ENV, max_mb=_ENV):
        """Open (lazily -- no I/O here) the store in the :data:`PORT_DIR`
        subdirectory of ``root`` (default: ``CIM_TUNER_RESULT_STORE``,
        else ``~/.cache/cim-tuner/result-store``, the reference's root);
        see the class docstring for the ``ttl_s`` / ``max_mb`` hygiene
        knobs."""
        base = root or os.environ.get("CIM_TUNER_RESULT_STORE") or \
            os.path.join(os.path.expanduser("~"), ".cache", "cim-tuner",
                         "result-store")
        self.root = os.path.join(base, PORT_DIR)
        self.ttl_s = _limit_from_env("CIM_TUNER_RESULT_STORE_TTL") \
            if ttl_s is self._ENV else ttl_s
        max_mb = _limit_from_env("CIM_TUNER_RESULT_STORE_MAX_MB") \
            if max_mb is self._ENV else max_mb
        self.max_bytes = None if max_mb is None else max_mb * 1e6
        #: running (over-)estimate of the store's byte total; a full
        #: directory walk only happens when this crosses the cap, so puts
        #: stay O(1) until eviction is actually needed
        self._approx_bytes: float | None = None
        # handler threads of the HTTP front door and the queue worker hit
        # one store concurrently; StatCounters locks each bump and
        # mirrors it into the process-wide cim_store_ops_total family
        self.stats = obs.StatCounters({
            "hits": _M_OPS.labels(tier="local", op="hit"),
            "misses": _M_OPS.labels(tier="local", op="miss"),
            "puts": _M_OPS.labels(tier="local", op="put"),
            "expired": _M_OPS.labels(tier="local", op="expired"),
            "evicted": _M_OPS.labels(tier="local", op="evicted"),
        })

    def _bump(self, counter: str, n: int = 1) -> None:
        self.stats.bump(counter, n)

    # ------------------------------------------------------------- #
    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], f"{key}.jsonl")

    def _timeline_path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], f"{key}.timeline.json")

    def _measurements_path(self, key: str) -> str:
        return os.path.join(self.root, key[:2],
                            f"{key}.measurements.json")

    def _sidecar_paths(self, key: str) -> tuple[str, ...]:
        """Every sidecar that shares its parent record's lifecycle --
        evicted/expired with it, recency-refreshed on its hits."""
        return (self._timeline_path(key), self._measurements_path(key))

    def _write_sidecar(self, path: str, payload, op: str) -> None:
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(path), suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)                      # atomic publish
        except (OSError, TypeError, ValueError):       # pragma: no cover
            return
        _M_OPS.inc(tier="local", op=op)

    def put_timeline(self, key: str, timeline: dict) -> None:
        """Persist one flight-recorder timeline next to its result
        (atomic publish; write failures degrade to a no-op, exactly like
        :meth:`put`) -- warm-store hits after a server restart still
        serve ``GET /v1/jobs/<key>/timeline`` from this sidecar."""
        self._write_sidecar(self._timeline_path(key), timeline,
                            "timeline_put")

    def put_measurements(self, key: str, records: list) -> None:
        """Persist the kernel measurement records backing one measured-
        fidelity result next to it (same lifecycle as the timeline
        sidecar: atomic publish, evicted/expired with the parent) -- so
        a two-fidelity race replays bit-for-bit from the store and
        ``GET /v1/jobs/<key>/measurements`` survives server restarts."""
        self._write_sidecar(self._measurements_path(key), list(records),
                            "measurements_put")

    def get_measurements(self, key: str) -> list | None:
        """The persisted measurement records for a canonical job key
        (``None`` on any kind of miss -- absent, corrupt, non-list)."""
        try:
            with open(self._measurements_path(key)) as f:
                records = json.load(f)
            if not isinstance(records, list):
                raise ValueError("malformed measurements")
        except (OSError, ValueError):
            _M_OPS.inc(tier="local", op="measurements_miss")
            return None
        _M_OPS.inc(tier="local", op="measurements_hit")
        return records

    def get_timeline(self, key: str) -> dict | None:
        """The persisted timeline for a canonical job key (``None`` on
        any kind of miss -- absent, corrupt, non-dict)."""
        try:
            with open(self._timeline_path(key)) as f:
                timeline = json.load(f)
            if not isinstance(timeline, dict):
                raise ValueError("malformed timeline")
        except (OSError, ValueError):
            _M_OPS.inc(tier="local", op="timeline_miss")
            return None
        _M_OPS.inc(tier="local", op="timeline_hit")
        return timeline

    def get_raw(self, key: str, count: bool = True) -> dict | None:
        """The serialized-result payload of a live record (TTL and schema
        enforced exactly like :meth:`get`); what the HTTP front door's
        ``GET /v1/store/<key>`` ships to remote readers.  ``count=False``
        suppresses the hit/miss accounting (for callers like :meth:`get`
        that do their own, once deserialization is known to succeed --
        mirrored counters are monotonic, so outcomes must be counted
        exactly once, after they are final)."""
        path = self._path(key)
        try:
            with open(path) as f:
                rec = json.loads(f.readline())
            if rec.get("schema") != STORE_SCHEMA:
                raise ValueError("schema mismatch")
            if self.ttl_s is not None and \
                    time.time() - rec.get("created_s", 0.0) > self.ttl_s:
                self._bump("expired")
                for p in (path, *self._sidecar_paths(key)):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                raise ValueError("expired")
            payload = rec["result"]
            if not isinstance(payload, dict):
                raise ValueError("malformed record")
        except (OSError, ValueError, KeyError, TypeError):
            if count:
                self._bump("misses")
            return None
        if count:
            self._bump("hits")
        try:
            os.utime(path)             # LRU-ish: hits refresh the mtime
        except OSError:                                # pragma: no cover
            pass
        for p in self._sidecar_paths(key):
            try:                       # sidecars share the hit's recency
                os.utime(p)
            except OSError:
                pass
        return payload

    def get(self, key: str) -> ExploreResult | None:
        """The stored result for a canonical job key, or ``None`` on any
        kind of miss (absent, expired, corrupt, schema-mismatched); hits
        are tagged ``search["cache"] = "store"`` and refresh recency."""
        with obs.span("store.get", tier="local"):
            payload = self.get_raw(key, count=False)
            if payload is None:
                self._bump("misses")
                return None
            try:
                out = deserialize_result(payload)
            except (ValueError, KeyError, TypeError):
                self._bump("misses")
                return None
            self._bump("hits")
        out.search["cache"] = "store"
        return out

    def put(self, key: str, result: ExploreResult) -> None:
        """Persist one result under its canonical key (atomic publish via
        ``os.replace``; write failures degrade to a no-op so read-only
        filesystems never break exploration), then enforce the size cap.
        """
        rec = {"schema": STORE_SCHEMA, "key": key,
               "created_s": time.time(),
               "result": serialize_result(result)}
        path = self._path(key)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(path), suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(rec) + "\n")
            os.replace(tmp, path)                      # atomic publish
        except OSError:                                # pragma: no cover
            return                                     # read-only FS etc.
        self._bump("puts")
        if self.max_bytes is not None:
            if self._approx_bytes is not None:
                # overwrites double-count the record; the estimate only
                # ever errs high, forcing at worst an early rescan
                try:
                    self._approx_bytes += os.path.getsize(path)
                except OSError:                        # pragma: no cover
                    self._approx_bytes = None
            if self._approx_bytes is None or \
                    self._approx_bytes > self.max_bytes:
                self._enforce_cap(keep=key)

    def _enforce_cap(self, keep: str | None = None) -> None:
        """Evict least-recently-used records until under ``max_bytes``
        (the just-written ``keep`` key is never evicted).  Re-establishes
        the exact byte total as a side effect."""
        entries = []                    # (mtime, size, key, path)
        total = 0
        for k in self.keys():
            p = self._path(k)
            try:
                st = os.stat(p)
            except OSError:                            # pragma: no cover
                continue
            total += st.st_size
            entries.append((st.st_mtime, st.st_size, k, p))
        for mtime, size, k, p in sorted(entries):
            if total <= self.max_bytes:
                break
            if k == keep:
                continue
            try:
                os.remove(p)
            except OSError:                            # pragma: no cover
                continue
            for sp in self._sidecar_paths(k):
                try:                   # every sidecar goes with it
                    os.remove(sp)
                except OSError:
                    pass
            self._bump("evicted")
            total -= size
        self._approx_bytes = total

    def __contains__(self, key: str) -> bool:
        """get-parity membership: a record ``get`` would reject (expired,
        schema-mismatched, unparseable) is absent."""
        try:
            with open(self._path(key)) as f:
                rec = json.loads(f.readline())
        except (OSError, ValueError):
            return False
        if rec.get("schema") != STORE_SCHEMA:
            return False
        return self.ttl_s is None or \
            time.time() - rec.get("created_s", 0.0) <= self.ttl_s

    def keys(self) -> list[str]:
        """Every record key currently on disk, sorted within shards."""
        out = []
        if not os.path.isdir(self.root):
            return out
        for shard in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, shard)
            if os.path.isdir(d):
                out.extend(sorted(
                    f[:-len(".jsonl")] for f in os.listdir(d)
                    if f.endswith(".jsonl")))
        return out

    def clear(self) -> int:
        """Remove every record; returns how many were deleted."""
        n = 0
        for key in self.keys():
            try:
                os.remove(self._path(key))
                n += 1
            except OSError:                            # pragma: no cover
                pass
            for sp in self._sidecar_paths(key):
                try:
                    os.remove(sp)
                except OSError:
                    pass
        self._approx_bytes = None
        return n


class RemoteStoreTier:
    """Read-through tiering over a ``python -m repro_torch.service serve``
    instance.

    ``get`` falls through **local store -> remote GET /v1/store/<key>**;
    remote hits are written back into the local tier so the next identical
    query on this host never leaves the machine.  ``put`` writes the local
    tier only -- the *server* is the sole writer of the shared store (every
    engine result it computes lands there via its own queue), so client
    fleets cannot race each other's writes across hosts.  Remote errors
    (server down, timeouts) degrade to misses: the caller simply submits.
    """

    def __init__(self, base_url: str,
                 local: "ResultStore | None" = None,
                 timeout_s: float = 10.0):
        """Tier over the server at ``base_url`` with an optional
        ``local`` write-back store; ``timeout_s`` bounds each remote GET.
        """
        self.base_url = base_url.rstrip("/")
        self.local = local
        self.timeout_s = float(timeout_s)
        self.stats = obs.StatCounters({
            "local_hits": _M_OPS.labels(tier="remote", op="local_hit"),
            "remote_hits": _M_OPS.labels(tier="remote", op="remote_hit"),
            "misses": _M_OPS.labels(tier="remote", op="miss"),
            "puts": _M_OPS.labels(tier="remote", op="put"),
            "remote_errors": _M_OPS.labels(tier="remote",
                                           op="remote_error"),
        })

    def _bump(self, counter: str) -> None:
        self.stats.bump(counter)

    def get(self, key: str) -> ExploreResult | None:
        """Read-through lookup: local tier, then ``GET /v1/store/<key>``
        (remote hits are written back locally; remote errors read as
        misses so a down server degrades to plain submission)."""
        with obs.span("store.get", tier="remote"):
            if self.local is not None:
                out = self.local.get(key)
                if out is not None:
                    self._bump("local_hits")
                    return out
            payload = self._remote_get(key)
            if payload is None:
                self._bump("misses")
                return None
            try:
                out = deserialize_result(payload)
            except (ValueError, KeyError, TypeError):
                self._bump("misses")
                return None
            self._bump("remote_hits")
        out.search["cache"] = "remote-store"
        if self.local is not None:
            self.local.put(key, out)       # read-through: warm the local tier
        return out

    def put(self, key: str, result: ExploreResult) -> None:
        """Write the LOCAL tier only -- the server is the shared store's
        sole writer (its own queue persists every engine result)."""
        if self.local is not None:
            self.local.put(key, result)
        self._bump("puts")

    def put_measurements(self, key: str, records: list) -> None:
        """Measurement sidecars follow :meth:`put`'s local-only rule."""
        if self.local is not None:
            self.local.put_measurements(key, records)

    def get_measurements(self, key: str) -> list | None:
        """Local tier only (no remote fall-through for sidecars)."""
        if self.local is not None:
            return self.local.get_measurements(key)
        return None

    def _remote_get(self, key: str) -> dict | None:
        import urllib.error
        import urllib.request
        url = f"{self.base_url}/v1/store/{key}"
        try:
            with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
                rec = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as exc:
            if exc.code != 404:                        # pragma: no cover
                self._bump("remote_errors")
            return None
        except (OSError, ValueError):
            self._bump("remote_errors")
            return None
        payload = rec.get("result") if isinstance(rec, dict) else None
        return payload if isinstance(payload, dict) else None


def default_store() -> ResultStore | None:
    """The store the process-wide service uses; ``None`` (cache off) when
    ``CIM_TUNER_DISABLE_RESULT_STORE`` is set."""
    if os.environ.get("CIM_TUNER_DISABLE_RESULT_STORE"):
        return None
    return ResultStore()
