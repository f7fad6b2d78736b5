"""Env-gated ``repro_torch.*`` logging hierarchy.

Every subsystem logs through ``get_logger("server")`` ->
``repro_torch.server`` etc., quiet (WARNING) by default, and
``CIM_TUNER_LOG`` turns subsystems on with comma-separated selectors::

    CIM_TUNER_LOG=server              # repro_torch.server at DEBUG
    CIM_TUNER_LOG=engine,queue=INFO   # engine DEBUG, queue INFO
    CIM_TUNER_LOG=all=INFO            # whole repro_torch.* tree at INFO

One tagged ``StreamHandler`` is installed on the ``repro_torch`` root
logger (``propagate=False`` keeps host applications' root handlers out of
it); request-line logging from the HTTP server lands at DEBUG so it only
appears when an operator asks for it.  The selector grammar is the
reference's; the root is the port's own, so the two packages' loggers
never share a level or a handler.
"""
from __future__ import annotations

import logging
import os
import sys
import threading

__all__ = ["configure_logging", "get_logger", "ROOT"]

ROOT = "repro_torch"
_FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"
_configured = False
_lock = threading.Lock()


def _parse_spec(spec: str) -> dict[str, int]:
    """``"engine,queue=INFO"`` -> ``{"engine": DEBUG, "queue": INFO}``."""
    levels: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, level_s = part.partition("=")
        level = logging.DEBUG
        if level_s:
            level = logging.getLevelName(level_s.strip().upper())
            if not isinstance(level, int):
                level = logging.DEBUG
        levels[name.strip().lower()] = level
    return levels


def configure_logging(spec: str | None = None, *,
                      force: bool = False) -> logging.Logger:
    """Install the ``repro_torch`` handler and apply ``CIM_TUNER_LOG``.

    Idempotent: the handler is installed once per process; pass
    ``force=True`` to re-read ``spec`` / the environment (tests).
    Returns the ``repro_torch`` root logger.
    """
    global _configured
    root = logging.getLogger(ROOT)
    with _lock:
        if _configured and not force:
            return root
        if not any(getattr(h, "_repro_obs", False) for h in root.handlers):
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(_FORMAT))
            handler._repro_obs = True        # type: ignore[attr-defined]
            root.addHandler(handler)
        root.propagate = False
        root.setLevel(logging.WARNING)
        if spec is None:
            spec = os.environ.get("CIM_TUNER_LOG", "")
        for name, level in _parse_spec(spec).items():
            if name in ("all", ROOT, "*"):
                root.setLevel(level)
            else:
                logging.getLogger(f"{ROOT}.{name}").setLevel(level)
        _configured = True
    return root


def get_logger(subsystem: str) -> logging.Logger:
    """The ``repro_torch.<subsystem>`` logger (configuring the hierarchy
    on first use)."""
    configure_logging()
    return logging.getLogger(f"{ROOT}.{subsystem}")
