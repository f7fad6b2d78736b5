"""Batched search-backend interface + registry.

Every optimizer implements one contract so the batched exploration engine
can treat them interchangeably:

``backend.run(objective_fn, mat, lens, bw, settings, generator)`` searches
the padded axis-index space of a batch of jobs at once: ``objective_fn``
maps cfg rows [J, M, 6] to objective values [J, M] (one batched kernel
call), ``mat`` [J, 5, L], ``lens`` [J, 5] and ``bw`` [J] describe each
job's axes.  It returns

    (best_idx [J, members, 5], best_val [J, members], trace_best [J, steps])

where *members* is the backend's population axis (chains for SA) and
``trace_best`` is the population-best objective value per step.  The
engine picks the argmin member per job, snaps it to a config and wraps it
in a :class:`SearchResult`.  All randomness comes from ``generator``,
which :meth:`SearchBackend.make_generator` seeds from ``settings.seed``.
"""
from __future__ import annotations

import typing

import torch

__all__ = [
    "SearchResult",
    "SearchBackend",
    "register_backend",
    "get_backend",
    "available_backends",
]


class SearchResult(typing.NamedTuple):
    """Summary of one backend run on one job (attached to ExploreResult)."""

    best_cfg: torch.Tensor        # [6] (mr, mc, scr, is_kb, os_kb, bw)
    best_value: torch.Tensor      # scalar raw objective of the winner
    best_per_chain: torch.Tensor  # [members] per-member best values
    trace_best: torch.Tensor      # [steps] population-best value per step


class SearchBackend:
    """Base class: subclasses set ``name`` + ``settings_cls`` and implement
    :meth:`run`."""

    name: str = ""
    settings_cls: type = type(None)

    def default_settings(self):
        """A fresh default-constructed settings object for this backend."""
        return self.settings_cls()

    def make_generator(self, settings, device) -> torch.Generator:
        """The generator :meth:`run` draws from, seeded from
        ``settings.seed`` so equal settings replay identically."""
        gen = torch.Generator(device=device)
        gen.manual_seed(int(settings.seed))
        return gen

    def run(self, objective_fn, mat, lens, bw, settings, generator):
        """Batched search over index space -- see the module docstring for
        the exact contract."""
        raise NotImplementedError


_REGISTRY: dict[str, SearchBackend] = {}


def register_backend(backend: SearchBackend,
                     overwrite: bool = False) -> SearchBackend:
    """Add a backend to the registry; its ``name`` becomes a valid
    ``method=`` for the engine and the ``co_explore`` family."""
    if not backend.name:
        raise ValueError("backend must define a non-empty name")
    if backend.name == "exhaustive":
        raise ValueError("'exhaustive' is reserved for the pruned sweep")
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> SearchBackend:
    """The registered backend for ``name`` (raises ``ValueError`` with the
    registered-name list on a miss)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown search backend {name!r}; registered: "
            f"{sorted(_REGISTRY)} (plus 'exhaustive')") from None


def available_backends() -> tuple[str, ...]:
    """Registered backend names, sorted (excludes 'exhaustive')."""
    return tuple(sorted(_REGISTRY))
