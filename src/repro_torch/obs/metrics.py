"""Process-wide metrics registry: counters, gauges, histograms.

The port's copy of the reference's ``obs/metrics.py`` (stdlib only).

This is the unified telemetry core the whole DSE stack reports into --
engine, queue, store tiers and the HTTP front door all bump children of
one process-wide :class:`Registry` (:func:`registry`) instead of the four
hand-rolled counter dicts (each behind its own lock) they grew over PRs
2-5.  Stdlib only, matching the service's no-new-dependencies rule.

Three instrument types, all label-aware and thread-safe:

``Counter``
    Monotonic float; ``inc(amount, **labels)``.
``Gauge``
    Settable float; ``set`` / ``inc`` / ``dec``.
``Histogram``
    Fixed cumulative buckets plus ``_sum`` / ``_count`` (Prometheus
    histogram semantics); ``observe(value, **labels)``.

Exports: :meth:`Registry.render` emits the Prometheus text exposition
format (what ``GET /v1/metrics`` serves), :meth:`Registry.snapshot` a flat
JSON-able dict (what ``benchmarks/run.py`` embeds in ``results.jsonl``).

:class:`StatCounters` is the migration bridge: a read-only-``Mapping``
facade with the exact shape of the legacy per-instance ``stats`` dicts
(``stats["submitted"]`` reads, ``dict(stats)`` snapshots, ``/v1/stats``
JSON unchanged) whose ``bump`` increments both the per-instance value and
the process-wide registry family behind one audited lock.
"""
from __future__ import annotations

import json
import math
import os
import re
import threading
import time
import typing

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "StatCounters",
    "registry",
    "exemplars_enabled",
    "DEFAULT_BUCKETS",
]

#: when truthy, ``Histogram.render_into`` appends each bucket's last
#: exemplar in OpenMetrics syntax (``... # {span_id="..."} value ts``);
#: off by default so the exposition stays strict text-format 0.0.4
_EXEMPLARS_ENV = "CIM_TUNER_EXEMPLARS"


def exemplars_enabled() -> bool:
    """Whether ``CIM_TUNER_EXEMPLARS`` asks for OpenMetrics exemplar
    suffixes on histogram bucket lines."""
    return os.environ.get(_EXEMPLARS_ENV, "") not in ("", "0", "false",
                                                      "no")

#: default latency buckets (seconds): sub-ms HTTP handling up to multi-
#: second cold compiles; +Inf is implicit
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    """Sample-value formatting: integers render bare, floats via repr."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Family:
    """Shared base: one named metric family holding labeled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str,  # noqa: A002 -- prometheus term
                 labelnames: tuple[str, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], typing.Any] = {}

    def _child_values(self) -> typing.Any:
        raise NotImplementedError

    def _key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def labels(self, **labels):
        """The child for one label-value combination (created on first
        use); with no labelnames there is a single anonymous child."""
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child_values()
            return child

    def samples(self) -> list[tuple[tuple[str, ...], typing.Any]]:
        """``(label-values, child)`` pairs, insertion-ordered."""
        with self._lock:
            return list(self._children.items())

    def _label_str(self, values: tuple[str, ...],
                   extra: tuple[tuple[str, str], ...] = ()) -> str:
        pairs = [f'{ln}="{_escape(v)}"'
                 for ln, v in zip(self.labelnames, values)]
        pairs += [f'{ln}="{_escape(v)}"' for ln, v in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""


class _Value:
    """One float cell behind its own lock (counter/gauge child)."""

    __slots__ = ("_v", "_lock")

    def __init__(self) -> None:
        self._v = 0.0
        self._lock = threading.Lock()

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    def add(self, amount: float) -> None:
        with self._lock:
            self._v += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)


class Counter(_Family):
    """Monotonically increasing metric family."""

    kind = "counter"

    def _child_values(self) -> _Value:
        return _Value()

    def inc(self, amount: float = 1.0, **labels) -> None:
        """Increment by ``amount`` (must be >= 0) for the given labels."""
        if amount < 0:
            raise ValueError("counters only go up")
        self.labels(**labels).add(amount)

    def value(self, **labels) -> float:
        """Current value of one child (0.0 if never incremented)."""
        return self.labels(**labels).value

    def render_into(self, out: list[str]) -> None:
        for values, child in self.samples():
            out.append(f"{self.name}{self._label_str(values)} "
                       f"{_fmt(child.value)}")


class Gauge(_Family):
    """Settable point-in-time metric family."""

    kind = "gauge"

    def _child_values(self) -> _Value:
        return _Value()

    def set(self, value: float, **labels) -> None:
        """Set the child to ``value``."""
        self.labels(**labels).set(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        """Add ``amount`` (may be negative) to the child."""
        self.labels(**labels).add(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        """Subtract ``amount`` from the child."""
        self.labels(**labels).add(-amount)

    def value(self, **labels) -> float:
        """Current value of one child."""
        return self.labels(**labels).value

    def render_into(self, out: list[str]) -> None:
        for values, child in self.samples():
            out.append(f"{self.name}{self._label_str(values)} "
                       f"{_fmt(child.value)}")


class _HistChild:
    """Bucket counts + sum + count for one label combination.

    ``exemplars`` holds, per non-cumulative bucket, the most recent
    ``(labels, value, unix_ts)`` exemplar handed to :meth:`observe`
    (typically ``{"span_id": ...}`` from ``obs.span``) -- rendered as
    OpenMetrics suffixes when :func:`exemplars_enabled`."""

    __slots__ = ("buckets", "counts", "sum", "count", "exemplars",
                 "_lock")

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1 for +Inf
        self.exemplars: list[tuple[dict, float, float] | None] = \
            [None] * (len(buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: dict | None = None) -> None:
        value = float(value)
        with self._lock:
            self.sum += value
            self.count += 1
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    break
            else:
                i = len(self.buckets)
            self.counts[i] += 1
            if exemplar:
                self.exemplars[i] = (dict(exemplar), value, time.time())

    def exemplars_snapshot(self) -> list:
        with self._lock:
            return list(self.exemplars)

    def cumulative(self) -> list[int]:
        with self._lock:
            out, acc = [], 0
            for c in self.counts:
                acc += c
                out.append(acc)
            return out

    def snapshot(self) -> tuple[float, int]:
        with self._lock:
            return self.sum, self.count


class Histogram(_Family):
    """Fixed-bucket cumulative histogram family (latency distributions)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(),  # noqa: A002
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = b

    def _child_values(self) -> _HistChild:
        return _HistChild(self.buckets)

    def observe(self, value: float, exemplar: dict | None = None,
                **labels) -> None:
        """Record one observation for the given labels; ``exemplar`` is
        an optional dict of exemplar labels (e.g. ``{"span_id": ...}``)
        remembered as the bucket's latest exemplar."""
        self.labels(**labels).observe(value, exemplar=exemplar)

    def render_into(self, out: list[str]) -> None:
        show_ex = exemplars_enabled()
        for values, child in self.samples():
            cum = child.cumulative()
            exs = child.exemplars_snapshot() if show_ex \
                else [None] * len(cum)
            for i, ub in enumerate((*self.buckets, math.inf)):
                line = (f"{self.name}_bucket"
                        f"{self._label_str(values, (('le', _fmt(ub)),))} "
                        f"{cum[i]}")
                if exs[i] is not None:
                    ex_labels, ex_value, ex_ts = exs[i]
                    pairs = ",".join(f'{k}="{_escape(v)}"'
                                     for k, v in ex_labels.items())
                    line += (f" # {{{pairs}}} {_fmt(ex_value)} "
                             f"{ex_ts:.3f}")
                out.append(line)
            s, n = child.snapshot()
            out.append(f"{self.name}_sum{self._label_str(values)} {_fmt(s)}")
            out.append(f"{self.name}_count{self._label_str(values)} {n}")


class Registry:
    """A namespace of metric families; see :func:`registry` for the
    process-wide instance every subsystem reports into.

    Family constructors are idempotent: asking for an existing name with
    the same type/labelnames returns the existing family (so modules can
    declare their instruments at import time without double-registration
    hazards); a mismatch raises.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get_or_make(self, cls, name, help, labelnames, **kw):  # noqa: A002
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.labelnames}")
                return fam
            fam = cls(name, help, tuple(labelnames), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str,  # noqa: A002
                labelnames: tuple[str, ...] = ()) -> Counter:
        """Get-or-create a :class:`Counter` family."""
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str,  # noqa: A002
              labelnames: tuple[str, ...] = ()) -> Gauge:
        """Get-or-create a :class:`Gauge` family."""
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str,  # noqa: A002
                  labelnames: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        """Get-or-create a :class:`Histogram` family."""
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets)

    def families(self) -> list[_Family]:
        """Every registered family, registration-ordered."""
        with self._lock:
            return list(self._families.values())

    def render(self) -> str:
        """The Prometheus text exposition format (``text/plain;
        version=0.0.4``) of every family -- what ``GET /v1/metrics``
        serves."""
        out: list[str] = []
        for fam in self.families():
            out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            fam.render_into(out)
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict[str, float]:
        """Flat JSON-able view: ``{"name{label=\\"v\\"}": value}``.

        Histograms contribute their ``_sum`` and ``_count`` series only
        (the bucket vector is scrape detail, not trend signal) -- this is
        the record ``benchmarks/run.py`` embeds per module in
        ``results.jsonl``."""
        out: dict[str, float] = {}
        for fam in self.families():
            for values, child in fam.samples():
                label_s = fam._label_str(values)
                if isinstance(fam, Histogram):
                    s, n = child.snapshot()
                    out[f"{fam.name}_sum{label_s}"] = s
                    out[f"{fam.name}_count{label_s}"] = float(n)
                else:
                    out[f"{fam.name}{label_s}"] = child.value
        return out


class StatCounters(typing.Mapping):
    """Legacy-shaped per-instance counters, mirrored into the registry.

    Drop-in replacement for the hand-rolled ``self.stats`` dicts of the
    queue / store / engine / server: reads (``stats["submitted"]``,
    ``dict(stats)``, iteration) behave exactly like the old dict so the
    ``/v1/stats`` JSON shape and every existing assertion are unchanged,
    while writes go through :meth:`bump`, which updates the per-instance
    value AND the mapped process-wide registry child under one lock --
    the single audited locking scheme replacing the three independent
    ones.

    ``mirror`` maps each legacy key to a registry child (a
    ``family.labels(...)`` handle) or ``None`` for keys that stay
    instance-local.
    """

    def __init__(self, mirror: dict[str, typing.Any]):
        self._mirror = dict(mirror)
        self._vals = dict.fromkeys(mirror, 0)
        self._lock = threading.Lock()

    def bump(self, key: str, n: int = 1) -> None:
        """Add ``n`` to ``key`` locally and in the mirrored registry
        child (registry mirrors are counters: negative local corrections
        are applied locally only)."""
        with self._lock:
            self._vals[key] += n
        child = self._mirror[key]
        if child is not None and n > 0:
            child.add(n)

    # Mapping protocol: the legacy read surface ----------------------- #
    def __getitem__(self, key: str) -> int:
        with self._lock:
            return self._vals[key]

    def __iter__(self):
        return iter(self._vals)

    def __len__(self) -> int:
        return len(self._vals)

    def __repr__(self) -> str:          # legacy dicts printed in CLIs
        with self._lock:
            return repr(dict(self._vals))

    def snapshot(self) -> dict[str, int]:
        """Plain-dict copy (one lock acquisition, no torn multi-key
        reads)."""
        with self._lock:
            return dict(self._vals)


# --------------------------------------------------------------------- #
# the process-wide registry
# --------------------------------------------------------------------- #
_REGISTRY = Registry()


def registry() -> Registry:
    """The process-wide :class:`Registry` every repro_torch subsystem reports
    into; ``GET /v1/metrics`` renders it."""
    return _REGISTRY


def render_json(reg: Registry | None = None) -> str:
    """JSON spelling of :meth:`Registry.snapshot` (debug helper)."""
    return json.dumps((reg or _REGISTRY).snapshot(), indent=2,
                      sort_keys=True)
