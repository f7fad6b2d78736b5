"""``repro_torch.search`` -- batched search backends.

The port has the ``"sa"`` backend (the paper's simulated annealing); the
reference's genetic, evolution, Sobol and portfolio backends are not
ported yet.  Every registered name, plus ``"exhaustive"``, is a valid
``method=`` for ``ExplorationEngine.run`` and the ``co_explore`` family.
"""
from repro_torch.search.base import (SearchBackend, SearchResult,
                                     available_backends, get_backend,
                                     register_backend)
from repro_torch.search.sa import SASettings, SimulatedAnnealingBackend

__all__ = [
    "SearchBackend", "SearchResult", "register_backend", "get_backend",
    "available_backends", "SASettings", "SimulatedAnnealingBackend",
]
