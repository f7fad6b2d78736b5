"""``repro_torch.search`` -- pluggable batched search backends.

The extended CIM-Tuner search space (hardware sizing x two-level mapping
under an area budget) is explored by interchangeable backends that all
share one interface (:class:`~repro_torch.search.base.SearchBackend`) and
the same ``[jobs]``-leading-axis contract: every step of every job of a
batch is one call of the engine's batched objective, the hand-written
``strategy_eval`` kernel on the card.

* ``"sa"``         -- the paper's simulated annealing (adapter over
  ``core/annealing``);
* ``"genetic"``    -- tournament-selection GA, uniform crossover +
  axis-index mutation;
* ``"evolution"``  -- discrete differential evolution (rand/1/bin on
  index space);
* ``"sobol"``      -- scrambled quasi-random baseline (and the init-
  population provider for GA / DE);
* ``"portfolio"``  -- budget-allocated racer over the other backends
  (composite; the engine orchestrates it per job).
  ``PortfolioSettings.allocator`` selects the race-budget allocator:
  ``"bandit"`` (deterministic UCB over per-backend improvement rates, the
  default) or ``"halving"`` (fixed successive-halving rungs);
  ``fidelity="measured"`` adds the re-scoring rung under kernel-calibrated
  tech constants.

Every registered name, plus ``"exhaustive"``, is a valid ``method=`` for
``ExplorationEngine.run`` and the ``co_explore`` family.  Register your
own with :func:`register_backend` (see ``base.py``).
"""
from repro_torch.search.base import (SearchBackend, SearchResult,
                                     available_backends, cfg_from_indices,
                                     get_backend, register_backend)
from repro_torch.search.evolution import (DESettings,
                                          DifferentialEvolutionBackend)
from repro_torch.search.genetic import GASettings, GeneticBackend
from repro_torch.search.portfolio import (ALLOCATORS, FIDELITIES,
                                          PortfolioBackend,
                                          PortfolioSettings,
                                          bandit_pull_plan, bandit_rounds,
                                          bandit_slice, constituent_devices,
                                          final_plan, race_plan, ucb_scores)
from repro_torch.search.sa import SASettings, SimulatedAnnealingBackend
from repro_torch.search.sobol import (SobolBackend, SobolSettings,
                                      sobol_index_population)

__all__ = [
    "SearchBackend", "SearchResult", "register_backend", "get_backend",
    "available_backends", "cfg_from_indices",
    "SASettings", "SimulatedAnnealingBackend",
    "GASettings", "GeneticBackend",
    "DESettings", "DifferentialEvolutionBackend",
    "SobolSettings", "SobolBackend", "sobol_index_population",
    "PortfolioSettings", "PortfolioBackend", "race_plan", "final_plan",
    "ALLOCATORS", "FIDELITIES", "bandit_pull_plan", "bandit_rounds",
    "bandit_slice", "ucb_scores", "constituent_devices",
]
