"""Batched search-backend interface + registry.

Every optimizer implements one contract so the batched exploration engine
can treat them interchangeably:

``backend.run(objective_fn, mat, lens, bw, settings, generators)``
searches the padded axis-index space of a batch of jobs at once:
``objective_fn`` maps cfg rows [J, M, 6] to objective values [J, M] (one
batched kernel call), ``mat`` [J, 5, L], ``lens`` [J, 5] and ``bw`` [J]
describe each job's axes, and ``generators`` holds one
``torch.Generator`` per job.  It returns

    (best_idx [J, members, 5], best_val [J, members], trace_best [J, steps])

where *members* is the backend's population axis (chains for SA, the
population for GA/DE, the point count for Sobol) and ``trace_best`` is
the population-best objective value per step.  The engine picks the
argmin member per job, snaps it to a config and wraps it in a
:class:`SearchResult`.

A job's randomness comes only from its own generator, drawn up front
(:func:`draw_per_job`) and stacked along the job axis, so a job's search
does not depend on the batch it runs in and no RNG call sits inside a
step loop.  :meth:`SearchBackend.make_generators` seeds each job's
generator from ``settings.seed``, or from a per-job seed (the portfolio's
derived pull seeds).  ``run`` must draw ALL of its randomness from the
generators -- ``settings.seed`` only feeds :meth:`make_generators` -- or
declare ``seed_free_run = False``.

Backends also expose a budget algebra (``budget`` / ``with_budget`` /
``reseed``) so the portfolio racer can hand every backend a comparable
slice of the evaluation budget.
"""
from __future__ import annotations

import dataclasses
import typing

import torch

__all__ = [
    "SearchResult",
    "SearchBackend",
    "register_backend",
    "get_backend",
    "available_backends",
    "cfg_from_indices",
    "draw_per_job",
    "gather_rows",
]


class SearchResult(typing.NamedTuple):
    """Summary of one backend run on one job (attached to ExploreResult)."""

    best_cfg: torch.Tensor        # [6] (mr, mc, scr, is_kb, os_kb, bw)
    best_value: torch.Tensor      # scalar raw objective of the winner
    best_per_chain: torch.Tensor  # [members] per-member best values
    trace_best: torch.Tensor      # [steps] population-best value per step


def cfg_from_indices(mat: torch.Tensor, idx: torch.Tensor,
                     bw: torch.Tensor) -> torch.Tensor:
    """Axis-index rows [J, M, 5] -> cfg rows [J, M, 6] (bus width last);
    shared by every index-space backend."""
    J, n = idx.shape[:2]
    vals = torch.gather(mat[:, None].expand(J, n, *mat.shape[1:]), 3,
                        idx[..., None])[..., 0]
    return torch.cat([vals, bw[:, None, None].expand(J, n, 1)], dim=2)


def gather_rows(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Rows ``x[j, i[j, m]]`` of ``x`` [J, N, 5] for indices ``i`` [J, M]."""
    return torch.gather(x, 1, i[..., None].expand(*i.shape, x.shape[2]))


def draw_per_job(generators: typing.Sequence[torch.Generator],
                 draw: typing.Callable[[torch.Generator], tuple]) -> tuple:
    """Call ``draw(generator)`` once per job and stack each returned
    tensor along a new leading job axis."""
    per_job = [draw(g) for g in generators]
    return tuple(torch.stack(xs) for xs in zip(*per_job))


class SearchBackend:
    """Base class: subclasses set ``name`` + ``settings_cls`` and implement
    :meth:`run`; ``composite`` backends (the portfolio) are orchestrated by
    the engine over the other backends instead of running themselves."""

    name: str = ""
    settings_cls: type = type(None)
    #: composite backends have no run of their own; the engine races the
    #: registered primitives
    composite: bool = False
    #: contract flag: ``run()`` draws ALL randomness from its
    #: ``generators`` and never reads ``settings.seed`` (which only feeds
    #: :meth:`make_generators`).  The bandit allocator reseeds pulls
    #: through per-job generators, so it requires this.
    seed_free_run: bool = True

    # ------------------------------------------------------------- #
    # settings algebra (used by the portfolio's budget split)
    # ------------------------------------------------------------- #
    def default_settings(self):
        """A fresh default-constructed settings object for this backend."""
        return self.settings_cls()

    def reseed(self, settings, seed: int):
        """``settings`` with its RNG seed replaced (the portfolio hands
        every scaled constituent a deterministic derived seed)."""
        return dataclasses.replace(settings, seed=int(seed))

    def budget(self, settings) -> int:
        """Approximate number of objective evaluations one run performs."""
        raise NotImplementedError

    def with_budget(self, settings, n_evals: int):
        """Settings rescaled to roughly ``n_evals`` objective evaluations."""
        raise NotImplementedError

    # ------------------------------------------------------------- #
    # the batched core
    # ------------------------------------------------------------- #
    def make_generators(self, settings, device, n_jobs: int = 1,
                        seeds: typing.Sequence[int] | None = None
                        ) -> list[torch.Generator]:
        """One generator per job on ``device``: each seeded
        ``settings.seed``, or ``seeds[j]`` when ``seeds`` is given (then
        its length is the job count), so equal seeds replay
        identically."""
        if seeds is None:
            seeds = [settings.seed] * n_jobs
        gens = []
        for s in seeds:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(s))
            gens.append(gen)
        return gens

    def run(self, objective_fn, mat, lens, bw, settings, generators):
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
