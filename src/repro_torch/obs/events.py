"""Per-job-key progress bus.

The portfolio racer publishes one event per rung / bandit wave
(allocator, backend, pulls, best-so-far, device); a subscriber registers
per job key and watches the race converge instead of only seeing the
winner.

Publishing is fire-and-forget from the engine's perspective; each key
keeps a small bounded history so a subscriber that attaches *after* the
rung fired still replays what it missed.  ``subscribe`` registers the
live sink and returns the history snapshot under one lock: no event is
lost or duplicated between replay and live delivery.
"""
from __future__ import annotations

import collections
import threading
import typing

__all__ = ["ProgressBus", "progress_bus"]

_HISTORY_PER_KEY = 64
_MAX_KEYS = 1024


class ProgressBus:
    """Bounded per-key pub/sub with atomic history-replay subscribe."""

    def __init__(self, history_per_key: int = _HISTORY_PER_KEY,
                 max_keys: int = _MAX_KEYS):
        self._history_per_key = history_per_key
        self._max_keys = max_keys
        self._lock = threading.Lock()
        # key -> deque of events, LRU-ordered for key eviction
        self._history: collections.OrderedDict[str, collections.deque] = \
            collections.OrderedDict()
        self._seq: dict[str, int] = {}
        # sink -> frozenset of keys it wants
        self._sinks: dict[typing.Callable[[str, dict], None],
                          frozenset] = {}

    def publish(self, key: str, **fields) -> dict:
        """Record an event for ``key`` and push it to live sinks.

        Adds a per-key monotonic ``seq`` so clients can detect the
        replay/live boundary; returns the event dict.
        """
        with self._lock:
            seq = self._seq.get(key, 0)
            self._seq[key] = seq + 1
            ev = {"key": key, "seq": seq, **fields}
            dq = self._history.get(key)
            if dq is None:
                dq = collections.deque(maxlen=self._history_per_key)
                self._history[key] = dq
                while len(self._history) > self._max_keys:
                    old, _ = self._history.popitem(last=False)
                    self._seq.pop(old, None)
            else:
                self._history.move_to_end(key)
            dq.append(ev)
            sinks = [s for s, keys in self._sinks.items() if key in keys]
        for sink in sinks:      # outside the lock: sinks may block
            try:
                sink(key, ev)
            except Exception:
                pass            # a dead subscriber must not stall the race
        return ev

    def subscribe(self, keys: typing.Iterable[str],
                  sink: typing.Callable[[str, dict], None],
                  ) -> list[dict]:
        """Register ``sink`` for ``keys`` and return the missed history.

        Registration and the history snapshot happen under one lock, so
        replaying the returned events then consuming live sink calls
        yields every event exactly once, in order.
        """
        keyset = frozenset(keys)
        with self._lock:
            self._sinks[sink] = keyset
            history: list[dict] = []
            for key in keyset:
                dq = self._history.get(key)
                if dq:
                    history.extend(dq)
            history.sort(key=lambda ev: (ev["key"], ev["seq"]))
            return history

    def unsubscribe(self, sink) -> None:
        """Detach a sink (idempotent)."""
        with self._lock:
            self._sinks.pop(sink, None)


# --------------------------------------------------------------------- #
_BUS = ProgressBus()


def progress_bus() -> ProgressBus:
    """The process-wide :class:`ProgressBus` shared by engine and
    server."""
    return _BUS
