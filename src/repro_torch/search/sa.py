"""Simulated annealing as a search backend: registers
``core/annealing.anneal`` under ``"sa"``."""
from __future__ import annotations

from repro_torch.core.annealing import SASettings, anneal
from repro_torch.search.base import SearchBackend, register_backend

__all__ = ["SimulatedAnnealingBackend", "SASettings"]


class SimulatedAnnealingBackend(SearchBackend):
    name = "sa"
    settings_cls = SASettings

    def run(self, objective_fn, mat, lens, bw, settings: SASettings,
            generator):
        best_idx, best_val, hists = anneal(
            objective_fn, mat, lens, bw, settings, generator)
        return best_idx, best_val, hists.min(dim=1).values


register_backend(SimulatedAnnealingBackend())
