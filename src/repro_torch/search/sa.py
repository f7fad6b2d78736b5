"""Simulated annealing as a search backend: registers
``core/annealing.anneal`` under ``"sa"``."""
from __future__ import annotations

import dataclasses

from repro_torch.core.annealing import SASettings, anneal
from repro_torch.search.base import SearchBackend, register_backend

__all__ = ["SimulatedAnnealingBackend", "SASettings"]


class SimulatedAnnealingBackend(SearchBackend):
    name = "sa"
    settings_cls = SASettings

    def budget(self, settings: SASettings) -> int:
        return settings.n_chains * settings.n_steps

    def with_budget(self, settings: SASettings, n_evals: int):
        chains = min(settings.n_chains, max(4, int(n_evals) // 25))
        return dataclasses.replace(
            settings, n_chains=chains,
            n_steps=max(1, int(n_evals) // chains))

    def run(self, objective_fn, mat, lens, bw, settings: SASettings,
            generators):
        best_idx, best_val, hists = anneal(
            objective_fn, mat, lens, bw, settings, generators)
        return best_idx, best_val, hists.min(dim=1).values


register_backend(SimulatedAnnealingBackend())
